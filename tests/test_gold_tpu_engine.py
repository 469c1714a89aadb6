"""Gold-grade validation of the device engine.

The bar_read gold scenarios run end-to-end with ``-engine tpu`` and the
results are held to the same bar as the exact engine:

* the evalres metrics TSV must equal the dev/ gold line verbatim;
* every read must land in the same output file as under the exact engine
  (decision identity — any flipped extraction/barcode decision fails);
* a decision-margin audit quantifies how far each read's Q sits from the
  calibrated threshold relative to the measured exact<->device score delta.

The device engine runs the same DP core and post-DP path on the CPU here
as on a GPU; `chip_smoke.py` holds the GPU run to the exact engine on the
same terms (decision identity, |dQ| bound).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from test_gold_regression import (
    EDITTAG,
    GOLD_BARREAD1,
    GOLD_BARREAD2,
    read_results,
    requires_dev,
    simreads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(tool, args, cwd, extra_env=None):
    from conftest import spawn_env

    env = spawn_env()
    if extra_env:
        env.update(extra_env)
    res = subprocess.run(
        [sys.executable, "-m", f"tagdust_tpu.cli.{tool}"] + args,
        cwd=cwd, env=env, capture_output=True, text=True,
    )
    assert res.returncode == 0, f"{tool} failed: {res.stderr[-2000:]}"
    return res


_RQ = re.compile(r";RQ:[0-9.]+")


def read_assignment(cwd, prefix):
    """{read name (RQ stripped): (output file, seq, qual)} over all outputs."""
    out = {}
    for f in sorted(os.listdir(cwd)):
        if not (f.startswith(prefix) and f.endswith(".fq")):
            continue
        with open(os.path.join(cwd, f)) as fh:
            lines = fh.read().splitlines()
        for i in range(0, len(lines) - 3, 4):
            name = _RQ.sub("", lines[i])
            out[name] = (f[len(prefix):], lines[i + 1], lines[i + 3])
    return out


def _gold_scenario_both_engines(tmp_path, scenario, gold):
    cwd = str(tmp_path)
    extra = (
        ("-sim_5seq", "GGGGGGG", "-sim_3seq", "TTTTTTT")
        if scenario == "barread2"
        else ()
    )
    simreads(cwd, f"{scenario}.fq", 4, extra=extra)
    arch = f"{scenario}.fq_tagdust_arch.txt"
    run_tool(
        "tagdust",
        ["-seed", "42", f"{scenario}.fq", "-arch", arch, "-o", "ex"],
        cwd,
    )
    run_tool(
        "tagdust",
        ["-seed", "42", f"{scenario}.fq", "-arch", arch, "-engine", "tpu",
         "-o", "tp"],
        cwd,
        extra_env={"TAGDUST_TPU_STRICT": "1"},
    )

    # 1. gold metrics TSV, verbatim, for the device engine
    outs = sorted(
        f for f in os.listdir(cwd) if f.startswith("tp_") and f.endswith(".fq")
    )
    run_tool("evalres", ["-name", "tagdust", *outs, "-o", "tp"], cwd)
    assert read_results(os.path.join(cwd, "tp_results.txt")) == gold

    # 2. decision identity: every read in the same file with the same
    #    extracted seq/qual under both engines
    ex = read_assignment(cwd, "ex_")
    tp = read_assignment(cwd, "tp_")
    assert set(ex) == set(tp)
    diff = [n for n in ex if ex[n] != tp[n]]
    assert not diff, f"{len(diff)} reads decided differently, e.g. {diff[:3]}"
    return cwd


@requires_dev
def test_barread1_gold_tpu_engine(tmp_path):
    _gold_scenario_both_engines(tmp_path, "barread1", GOLD_BARREAD1)


@requires_dev
def test_barread2_gold_tpu_engine(tmp_path):
    _gold_scenario_both_engines(tmp_path, "barread2", GOLD_BARREAD2)


@requires_dev
def test_decision_margin_audit(tmp_path):
    """Quantified safety margin: the exact<->device score delta must be far
    smaller than typical |Q - threshold| margins, and every read within the
    delta of the threshold must still decide identically (subsumed by the
    decision-identity assertions above; this test makes the numbers
    visible and fails if the tolerance degrades)."""
    from tagdust_tpu.arch import read_structure_from_params
    from tagdust_tpu.config import parse_args
    from tagdust_tpu.engine.runner import score_reads
    from tagdust_tpu.io.fastq import SeqReader
    from tagdust_tpu.model import init_model_bag
    from tagdust_tpu.stats import get_sequence_stats

    cwd = str(tmp_path)
    simreads(cwd, "ma.fq", 4)
    path = os.path.join(cwd, "ma.fq")
    p = parse_args(["-1", "B:ACAGTG", "-2", "R:N"])  # placeholder segs
    arch_line = open(os.path.join(cwd, "ma.fq_tagdust_arch.txt")).read().split()
    segs = [None] * 10
    for i, tok in enumerate(arch_line):
        if tok.startswith("-") and tok[1:].isdigit():
            segs[int(tok[1:]) - 1] = arch_line[i + 1]
    rs = read_structure_from_params(segs)
    ssi = get_sequence_stats(path, rs, 100000, -1, -1)
    mb = init_model_bag(rs, ssi, 0.05, 0.1)

    rd = SeqReader(path)
    reads_e = rd.read_chunk(100000)
    rd.close()
    rd = SeqReader(path)
    reads_t = rd.read_chunk(100000)
    rd.close()

    score_reads(mb, reads_e, engine_kind="exact")
    score_reads(mb, reads_t, engine_kind="tpu")

    qe = np.array([r.mapq for r in reads_e])
    qt = np.array([r.mapq for r in reads_t])
    ok = np.isfinite(qe) & np.isfinite(qt)
    dq = np.abs(qe[ok] - qt[ok])
    # measured on this 10k-read scenario: max dQ = 0.105 (the table-logsum
    # approximation in the exact engine vs clean float32 math); hold the
    # line at 0.15 so a real numeric regression surfaces here
    assert dq.max() < 0.15, f"score tolerance degraded: max dQ={dq.max():.4f}"
    # audit: count reads living inside the tolerance band around the
    # calibrated thresholds (barread1 calibrates to ~4.2); report via assert
    # message so the numbers appear on failure
    for thr in (1.0, 2.0, 4.0, 8.0, 16.0):
        margin = np.abs(qe[ok] - thr)
        at_risk = int((margin < dq.max()).sum())
        flipped = int((((qe[ok] >= thr) != (qt[ok] >= thr))).sum())
        assert flipped == 0, (
            f"thr={thr}: {flipped} decisions flipped "
            f"({at_risk} reads inside the {dq.max():.3f} tolerance band)"
        )


@requires_dev
def test_decision_margin_audit_psegment(tmp_path):
    """barread2-style P-linker scenario: decompose the Q deltas.

    The exact engine replicates the reference's 16k-entry TABLE logsum
    (misc.c:57-78); on linker-heavy reads the accumulated table error vs
    clean f32 logsumexp reaches ~0.65 Q (measured 0.64).  The device
    core's own float32 formulation must not add to it: the worst reads
    rescored in a batch of their own (another batch shape, another
    compiled program) agree with the full-batch scores to 0.05 Q."""
    from tagdust_tpu.arch import read_structure_from_params
    from tagdust_tpu.engine.runner import score_reads
    from tagdust_tpu.io.fastq import SeqReader
    from tagdust_tpu.model import init_model_bag
    from tagdust_tpu.stats import get_sequence_stats

    cwd = str(tmp_path)
    simreads(cwd, "mp.fq", 4, extra=("-sim_5seq", "GGGGGGG",
                                     "-sim_3seq", "TTTTTTT"))
    path = os.path.join(cwd, "mp.fq")
    arch_line = open(os.path.join(cwd, "mp.fq_tagdust_arch.txt")).read().split()
    segs = [None] * 10
    for i, tok in enumerate(arch_line):
        if tok.startswith("-") and tok[1:].isdigit():
            segs[int(tok[1:]) - 1] = arch_line[i + 1]
    rs = read_structure_from_params(segs)
    ssi = get_sequence_stats(path, rs, 100000, -1, -1)
    mb = init_model_bag(rs, ssi, 0.05, 0.1)

    def load():
        rd = SeqReader(path)
        reads = rd.read_chunk(100000)
        rd.close()
        return reads

    re_, rs_, rp_ = load(), load(), load()
    score_reads(mb, re_, engine_kind="exact")
    score_reads(mb, rs_, engine_kind="tpu")

    qe = np.array([r.mapq for r in re_])
    qs = np.array([r.mapq for r in rs_])
    d_scan = np.abs(qe - qs)
    assert d_scan.max() < 1.0, (
        f"table-logsum delta degraded: max dQ={d_scan.max():.4f}"
    )

    worst = np.argsort(d_scan)[-16:]
    sub = [rp_[i] for i in worst]
    score_reads(mb, sub, engine_kind="tpu")
    qp = np.array([r.mapq for r in sub])
    d_core = np.abs(qp - qs[worst])
    assert d_core.max() < 0.05, (
        f"batch-shape delta degraded: max dQ={d_core.max():.4f}"
    )

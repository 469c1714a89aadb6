"""Device-side architecture auto-detection.

MODE_ARCH_COMP (test_architectures.c:38-44,182-184) is served by the device
engine's backward-only scorer when the resolved engine is ``tpu``: one
masked backward sweep per candidate on the device instead of the host
exact engine.  Parity pinned here:

* per-read backward scores match ExactEngine.backward_only within the
  table-logsum tolerance;
* test_architectures() picks the same winner with the same confidence
  (to 2 decimals, the logged precision) under both engines.
"""

import numpy as np

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.engine.exact import ExactEngine
from tagdust_tpu.engine.tpu import TpuEngine
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats


def make_ssi(avg=30, mx=48):
    ssi = SequenceStats()
    ssi.average_length = avg
    ssi.max_seq_len = mx
    # realistic +1-pseudocount background: tiny P(N), near-uniform ACGT
    ssi.background = np.log(
        np.array([0.24990, 0.24990, 0.24990, 0.24990, 0.0004], np.float32)
    )
    return ssi


def test_backward_scores_match_exact():
    rng = np.random.default_rng(7)
    for specs in (["B:ACGTAC,TGCATG,CCAAGG", "R:N"], ["R:N"],
                  ["P:GGGG", "B:AC,GT", "R:N", "P:TTTT"]):
        rs = build_read_structure(specs)
        mb = init_model_bag(rs, make_ssi(), 0.05, 0.1)
        ex = ExactEngine(mb)
        tp = TpuEngine(mb)
        B, L = 24, 36
        lens = rng.integers(12, L + 1, B).astype(np.int32)
        seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
        # device path: [B, Lpad] + lens mask
        dev = tp.backward_scores(seqs, lens)
        # host path: per-length buckets with the [B, L+1] terminator layout
        host = np.zeros(B, dtype=np.float32)
        for Lb in np.unique(lens):
            idxs = np.nonzero(lens == Lb)[0]
            sb = np.zeros((len(idxs), int(Lb) + 1), dtype=np.uint8)
            for k, i in enumerate(idxs):
                sb[k, :Lb] = seqs[i, :Lb]
            host[idxs] = ex.backward_only(sb, int(Lb))
        d = np.abs(dev - host)
        assert d.max() < 0.25, (specs, d.max())


def test_detection_winner_identical_both_engines(tmp_path):
    """test_architectures() picks the same architecture on the device as on
    the host exact engine, for reads simulated from a barcoded model."""
    from tagdust_tpu.config import parse_args
    from tagdust_tpu.detect import test_architectures

    rng = np.random.default_rng(11)
    bars = ["ACGTAC", "TGCATG"]
    fq = tmp_path / "det.fq"
    with open(fq, "w") as fh:
        for i in range(400):
            bc = bars[i % 2]
            body = "".join("ACGT"[b] for b in rng.integers(0, 4, 24))
            seq = bc + body
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    arch = tmp_path / "arch.txt"
    arch.write_text(
        "tagdust -1 B:ACGTAC,TGCATG -2 R:N\n"
        "tagdust -1 R:N\n"
    )

    picks = {}
    for eng in ("exact", "tpu"):
        class _Log(list):
            def __call__(self, m):
                self.append(m)

        lg = _Log()
        param = parse_args([str(fq), "-arch", str(arch), "-engine", eng,
                            "-Q", "10", "-o", str(tmp_path / f"o_{eng}")])
        rs = test_architectures(param, 0, log=lg)
        conf = [m for m in lg if "Confidence" in m]
        picks[eng] = (rs.types, [list(s) for s in rs.seqs], conf)
    assert picks["exact"] == picks["tpu"], picks
    # the barcoded architecture must win on barcoded reads
    assert picks["tpu"][0][0] == "B"

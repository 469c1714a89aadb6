"""Fallback discipline: a failing device core must surface, never be
replaced by another path.  Each test poisons the DP core and asserts the
failure propagates out of one device entry point: one-shot scoring, the
streaming window loop, and the CLI."""

import functools

import numpy as np
import pytest

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.engine import runner
from tagdust_tpu.engine import tpu as tpu_mod
from tagdust_tpu.io.fastq import Read
from tagdust_tpu.model import init_model_bag

from test_tpu_engine import make_ssi


def _mk_reads(n=8, L=24, seed=0):
    rng = np.random.default_rng(seed)
    return [Read(name=f"r{i}", seq=rng.integers(0, 4, L).astype(np.uint8),
                 qual="I" * L)
            for i in range(n)]


def _poisoned(seqs, lens):
    raise RuntimeError("poisoned DP core")


@pytest.fixture()
def poisoned_core(monkeypatch):
    """Every device engine the runner builds from here on is given a DP core
    (`TpuEngine(core=...)`) that raises, as a kernel that fails to compile
    would; the engine cache starts empty."""
    monkeypatch.setattr(
        tpu_mod, "TpuEngine",
        functools.partial(tpu_mod.TpuEngine, core=_poisoned),
    )
    monkeypatch.setattr(runner, "_ENGINE_CACHE", {})
    monkeypatch.delenv("TAGDUST_TPU_STRICT", raising=False)
    yield


def test_poisoned_core_raises_one_shot(poisoned_core):
    rs = build_read_structure(["B:ACC,GGT", "R:N"])
    mb = init_model_bag(rs, make_ssi(), 0.05, 0.1)
    with pytest.raises(RuntimeError, match="poisoned DP core"):
        runner.score_reads(mb, _mk_reads(), engine_kind="tpu")


def test_poisoned_core_raises_streaming(poisoned_core, monkeypatch):
    from types import SimpleNamespace

    from tagdust_tpu.io.batch import ReadBatch

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "16")
    monkeypatch.setenv("TAGDUST_TPU_MESH", "0")
    rs = build_read_structure(["B:ACC,GGT", "R:N"])
    mb = init_model_bag(rs, make_ssi(), 0.05, 0.1)
    param = SimpleNamespace(
        engine="tpu", rtest=False, matchstart=-1, matchend=-1,
        minlen=10, dust=0, num_threads=4,
    )
    batch = ReadBatch.from_reads(_mk_reads(n=48))
    with pytest.raises(RuntimeError, match="poisoned DP core"):
        runner.run_get_label_batch(mb, rs, batch, param, 10.0)


def test_poisoned_core_raises_on_cli_path(poisoned_core, tmp_path):
    from tagdust_tpu.cli.tagdust import main

    fq = tmp_path / "in.fq"
    with open(fq, "w") as fh:
        for r in _mk_reads(n=64, L=30):
            seq = "".join("ACGT"[c] for c in r.seq)
            fh.write(f"@{r.name}\n{seq}\n+\n{r.qual}\n")
    with pytest.raises(RuntimeError, match="poisoned DP core"):
        main([str(fq), "-1", "B:ACCGTA,GGTTAC", "-2", "R:N", "-engine", "tpu",
              "-Q", "10", "-o", str(tmp_path / "out")])

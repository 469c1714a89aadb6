"""Failure-path robustness: counter overflow and pipeline-thread faults.

* ``global_counter_sum`` must survive counters past int32 under the default
  JAX config (no ``jax_enable_x64``) — VERDICT round 2, item 8;
* a writer-thread failure (disk full, broken pipe) must RAISE on the main
  thread instead of deadlocking the depth-1 pipeline queues — ADVICE
  round 2, medium.
"""

import os
import threading

import numpy as np
import pytest


def test_global_counter_sum_past_int32(monkeypatch):
    """Counters > 2^31 survive the cross-host sum exactly: values travel as
    two int32 halves (device-collective-safe without x64) and are summed in
    numpy int64 on the host."""
    import jax
    from jax.experimental import multihost_utils

    from tagdust_tpu.parallel import multihost as mh

    seen = {}

    def fake_allgather(x):
        x = np.asarray(x)
        seen["dtype"] = x.dtype
        return np.stack([x] * 20)  # 20 identical hosts

    monkeypatch.setattr(jax, "process_count", lambda: 20)
    monkeypatch.setattr(multihost_utils, "process_allgather", fake_allgather)

    counters = {
        "total": 110_622_138 * 3,  # the reference's production log x3/host
        "success": 3_000_000_001,  # already past int32 per host
        "arch_mismatch": 0,
    }
    out = mh.global_counter_sum(counters)
    assert seen["dtype"] == np.int32  # no silent x64-off narrowing possible
    assert out == {k: v * 20 for k, v in counters.items()}


def _write_fastq(path, n):
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(f"@r{i}\nACGTACGTACGTACGTACGT\n+\n{'I' * 20}\n")


def test_writer_failure_raises_not_hangs(tmp_path, monkeypatch):
    """With maxsize-1 queues, a writer death must not leave the main thread
    blocked on write_q.put(); the error surfaces as the run's exception."""
    from tagdust_tpu.config import parse_args
    from tagdust_tpu.controller import MessageLog, hmm_controller_multiple
    from tagdust_tpu.io import writer as writer_mod

    fq = os.path.join(str(tmp_path), "in.fq")
    _write_fastq(fq, 4000)  # 4 chunks at the rtest chunk size of 1000

    calls = {"n": 0}

    def failing_write_batch(self, *a, **k):
        calls["n"] += 1
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(
        writer_mod.DemuxWriter, "write_batch_columnar", failing_write_batch
    )

    param = parse_args(
        [fq, "-o", os.path.join(str(tmp_path), "out"), "-Q", "10", "-rtest"]
    )
    result = {}

    def run():
        try:
            hmm_controller_multiple(param, log=MessageLog())
            result["exc"] = None
        except BaseException as e:  # noqa: BLE001
            result["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "controller deadlocked after writer failure"
    assert isinstance(result["exc"], OSError)
    assert calls["n"] >= 1


def test_long_read_fallback_gate(tmp_path):
    """Reads padding past 4096nt must (a) flow through the CLI on the
    device engine on the same DP core as short reads — no length gate, no
    other path, nothing announced — and (b) produce decisions identical to
    the exact engine.  The reference's only length bound is its 10k line
    buffer (tagdust2.h:96)."""
    import subprocess
    import sys

    from conftest import spawn_env

    cwd = str(tmp_path)
    rng = np.random.default_rng(7)
    bcs = ["ACAGTG", "ACTTGA"]
    with open(os.path.join(cwd, "in.fq"), "w") as fh:
        for i in range(20):
            seq = bcs[i % 2] + "".join(
                rng.choice(list("ACGT"), size=50)
            )
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
        # one read that pads to 4224 > 4096
        seq = bcs[0] + "".join(rng.choice(list("ACGT"), size=4194))
        fh.write(f"@long\n{seq}\n+\n{'I' * len(seq)}\n")

    outs = {}
    errs = {}
    for eng in ("exact", "tpu"):
        env = spawn_env(rtest=False)
        res = subprocess.run(
            [
                sys.executable, "-m", "tagdust_tpu.cli.tagdust",
                "-seed", "42", "-1", "B:ACAGTG,ACTTGA", "-2", "R:N",
                "-Q", "10", "-engine", eng,
                os.path.join(cwd, "in.fq"), "-o", os.path.join(cwd, eng),
            ],
            cwd=cwd, env=env, capture_output=True, text=True,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        errs[eng] = res.stderr
        outs[eng] = {
            f: open(os.path.join(cwd, f), "rb").read()
            for f in sorted(os.listdir(cwd))
            if f.startswith(eng) and not f.endswith("_logfile.txt")
        }
    for eng in ("exact", "tpu"):
        assert "NOTE" not in errs[eng] and "WARNING" not in errs[eng]
    ours = {k[len("tpu"):]: v for k, v in outs["tpu"].items()}
    ref = {k[len("exact"):]: v for k, v in outs["exact"].items()}
    assert set(ours) == set(ref)
    for k in ref:
        # same reads, same barcode assignment, same extracted bytes modulo
        # the engines' float Q rendering in headers
        import re

        strip = lambda b: re.sub(rb";RQ:[0-9.\-nan]+", b";RQ", b)  # noqa: E731
        assert strip(ours[k]) == strip(ref[k]), f"{k} differs across engines"

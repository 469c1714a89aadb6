"""Sanitizer pass (VERDICT round 1, item 10; SURVEY §5 valgrind row).

The reference wraps every shell regression in valgrind
(``configure.ac:45-58``).  The JAX analogue: run the production scoring
computation under ``jax_debug_nans`` (any NaN produced by any op raises at
the op) and under ``checkify`` NaN checks — on the device engine's one-shot
and sub-batched paths, over inputs that exercise the masked/padded corners
(ragged lengths, minimum length 1, all-N reads).
"""

import numpy as np
import pytest

import jax

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.logsum import p2sp
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats


@pytest.fixture(scope="module")
def engine():
    from tagdust_tpu.engine.tpu import TpuEngine

    rs = build_read_structure(["F:NN", "B:ACGTAC,TGCATG,CCAAGG", "S:TA", "R:N"])
    ssi = SequenceStats()
    ssi.average_length = 26
    ssi.max_seq_len = 40
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return TpuEngine(init_model_bag(rs, ssi, 0.05, 0.1))


def _adversarial_batch():
    """Ragged lengths + an all-N read.  Every read is long enough to
    traverse the mandatory segments: reads the model assigns probability 0
    get NaN Q *by design* (parity with the C code's -inf propagation —
    test_impossible_read_rejected_like_exact), so the sanitizer runs must
    only contain possible reads to detect *spurious* NaNs."""
    rng = np.random.default_rng(5)
    B, L = 16, 24
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    seqs[3, :] = 4  # all-N read
    lens = rng.integers(12, L + 1, B).astype(np.int32)
    return seqs, lens


def test_debug_nans_scan_engine(engine):
    seqs, lens = _adversarial_batch()
    jax.config.update("jax_debug_nans", True)
    try:
        res = engine.run_batch(seqs, lens)
    finally:
        jax.config.update("jax_debug_nans", False)
    assert np.isfinite(res.mapq).all()


def test_debug_nans_pallas_engine(engine, monkeypatch):
    """The one-shot scorer split into memory-budget sub-batches: the last
    sub-batch is padded with copies of read 0, and no padded row may
    produce a NaN either."""
    seqs, lens = _adversarial_batch()
    monkeypatch.setattr(engine, "max_batch", lambda Lp: 6)  # 16 -> 6+6+6
    jax.config.update("jax_debug_nans", True)
    try:
        res = engine.run_batch(seqs, lens)
    finally:
        jax.config.update("jax_debug_nans", False)
    assert res.mapq.shape == (16,)
    assert np.isfinite(res.mapq).all()


def test_checkify_scan_engine(engine):
    from functools import partial

    from jax.experimental import checkify

    from tagdust_tpu.engine.tpu import _forward_backward

    seqs, lens = _adversarial_batch()
    fn = jax.jit(
        checkify.checkify(
            partial(_forward_backward, engine._dev), errors=checkify.nan_checks
        )
    )
    err, out = fn(
        np.asarray(seqs, dtype=np.int32), np.asarray(lens, dtype=np.int32)
    )
    err.throw()  # raises if any op produced a NaN
    assert np.isfinite(np.asarray(out[4])).all()


def test_impossible_read_rejected_like_exact(engine):
    """A read too short to traverse the mandatory segments has P(x|M)=0:
    the C code propagates -inf into the Q math (NaN after 1-p), and the
    read is rejected by the `threshold <= Q` comparison.  Both engines must
    reproduce exactly that — this NaN is semantics, not a bug (hence
    excluded from the debug_nans runs above)."""
    from tagdust_tpu.engine.exact import ExactEngine
    from tagdust_tpu.extract import compute_q

    seqs = np.zeros((1, 4), dtype=np.uint8)
    seqs[0, :] = [0, 1, 2, 3]
    L = 1  # length-1 read under F:NN B:6nt S:TA R:N
    res_t = engine.run_batch(seqs, np.array([L], np.int32))
    ex = ExactEngine(engine.mb)
    res_e = ex.run_batch(seqs[:, : L + 1], L)
    assert not np.isfinite(res_t.f_score[0])
    assert not np.isfinite(res_e.f_score[0])
    q_e = compute_q(res_e.f_score, res_e.r_score, res_e.bar_prob)[0]
    # the `threshold <= Q` gate rejects on NaN in both engines, for any
    # threshold — the extraction outcome is ARCHITECTURE_MISMATCH
    assert not (0.0 <= res_t.mapq[0])
    assert not (0.0 <= q_e)

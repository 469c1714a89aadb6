"""Device engine (closure-lattice matmul scan) vs exact engine: decisions match.

Runs on the virtual CPU mesh (conftest).  The device engine uses clean float32
linear-space math rather than the reference's table-logsum, so scores agree
only approximately — but label paths, extraction outcomes and barcode
assignments must match.
"""

import numpy as np
import pytest

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.engine.exact import ExactEngine
from tagdust_tpu.extract import compute_q
from tagdust_tpu.logsum import p2sp
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats


def make_ssi(avg=30, mx=48):
    ssi = SequenceStats()
    ssi.average_length = avg
    ssi.max_seq_len = mx
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return ssi


ARCHS = [
    ["B:ACGTAC,TGCATG,CCAAGG", "R:N"],
    ["F:NNNN", "B:ACC,GGT", "R:N"],
    ["S:TATA", "R:N"],
]


@pytest.mark.parametrize("specs", ARCHS, ids=["+".join(a) for a in ARCHS])
def test_tpu_matches_exact_decisions(specs):
    from tagdust_tpu.engine.tpu import TpuEngine

    rs = build_read_structure(specs)
    ssi = make_ssi()
    mb = init_model_bag(rs, ssi, 0.05, 0.1)

    rng = np.random.default_rng(3)
    B, L = 64, 30
    # half structured reads (barcode + random), half fully random
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    bc = np.frombuffer(b"\x00\x01\x02\x03\x00\x01", dtype=np.uint8)
    for i in range(B // 2):
        k = min(len(rs.seqs[0][0]), L)
        for j, t in enumerate(rs.types):
            pass
        seqs[i, :k] = bc[:k]

    lens = np.full(B, L, dtype=np.int32)
    tpu = TpuEngine(mb)
    res_t = tpu.run_batch(seqs, lens)

    ex = ExactEngine(mb)
    seqs_e = np.zeros((B, L + 1), dtype=np.uint8)
    seqs_e[:, :L] = seqs
    res_e = ex.run_batch(seqs_e, L)
    q_e = compute_q(res_e.f_score, res_e.r_score, res_e.bar_prob)

    # scores close, decisions identical
    assert np.allclose(res_t.f_score, res_e.f_score, atol=0.01)
    assert np.nanmax(np.abs(res_t.mapq - q_e)) < 0.1
    assert np.array_equal(res_t.labels[:, 1 : L + 1], res_e.labels[:, 1 : L + 1])


def test_graft_entry_compiles():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert len(out) == 5


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_distributed_trainer_device_count_invariance():
    """psum-reduced BW expected counts are identical on a 1-device and an
    8-device mesh (the device analogue of the reference's thread-count
    invariance fixture, dev/test_data/thread_arch.txt)."""
    import jax
    import numpy as np

    from tagdust_tpu.parallel.mesh import DistributedTrainer, make_mesh

    from tagdust_tpu.engine.tpu import TpuEngine

    rs = build_read_structure(["B:ACGTAC,TGCATG,CCAAGG", "R:N"])
    mb = init_model_bag(rs, make_ssi(), 0.05, 0.1)
    eng = TpuEngine(mb)
    devs = jax.devices()
    rng = np.random.default_rng(5)
    B, L = 16, 24
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(10, L, B).astype(np.int32)

    t1 = DistributedTrainer(eng, make_mesh(devs[:1]))
    CT1, E1, n1 = t1.run(seqs, lens)
    t8 = DistributedTrainer(eng, make_mesh(devs))
    CT8, E8, n8 = t8.run(seqs, lens)
    assert n1 == n8 == int(lens.sum())
    np.testing.assert_allclose(E1, E8, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(CT1, CT8, rtol=1e-5, atol=1e-6)
    # every emitted base carries total posterior mass 1
    np.testing.assert_allclose(E1.sum(), float(n1), rtol=1e-4)
    # transition mass: every consumed base crosses exactly one A[c] edge
    np.testing.assert_allclose(CT1.sum(), float(n1), rtol=1e-4)


def test_resolve_engine_auto(monkeypatch):
    """-engine auto selects the device engine iff JAX's backend is a GPU;
    -rtest and explicit -engine pins override."""
    import jax

    from tagdust_tpu.config import parse_args
    from tagdust_tpu.engine import runner

    def fresh(args):
        runner._RESOLVED_AUTO.clear()
        return parse_args(["-1", "R:N", *args])

    assert runner.resolve_engine(fresh(["-engine", "tpu"])) == "tpu"
    assert runner.resolve_engine(fresh(["-engine", "exact"])) == "exact"
    # the tests pin JAX_PLATFORMS=cpu (conftest) -> auto resolves to exact
    assert runner.resolve_engine(fresh([])) == "exact"
    # a GPU backend flips auto to the device engine...
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert runner.resolve_engine(fresh([])) == "tpu"
    # ...except under -rtest, which pins the bit-exact engine
    assert runner.resolve_engine(fresh(["-rtest"])) == "exact"
    # explicit -engine tpu under rtest still honors the user
    p = fresh(["-rtest", "-engine", "tpu"])
    assert runner.resolve_engine(p) == "tpu"
    runner._RESOLVED_AUTO.clear()

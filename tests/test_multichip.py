"""Multi-device production path.

The per-device program production uses runs data-parallel over the device
mesh via `parallel.mesh.ShardedScorer`, and the production runner
(`engine.runner._score_reads_tpu`) engages the mesh automatically whenever
more than one device is visible and the batch fills every device's tile.
These tests assert, on the virtual 8-device CPU mesh:

* sharded scoring is bit-identical to single-device scoring;
* sharded decided rows are byte-identical to single-device decided rows;
* the runner's automatic mesh path returns the same results as the forced
  single-device path;
* the full CLI (`tagdust -engine tpu`) produces byte-identical output files
  under 1 and 8 devices — the device analogue of the reference's
  thread-count invariance fixture (dev/test_data/thread_arch.txt).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from test_gold_regression import run_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _flagship_engine():
    import __graft_entry__ as g

    return g._flagship_engine()


@pytest.fixture(scope="module")
def engine():
    return _flagship_engine()


def _random_batch(B=64, L=32, Lreal=28):
    rng = np.random.default_rng(7)
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, Lreal, dtype=np.int32)
    lens[:: 5] = Lreal - 7  # ragged
    return seqs, lens


def test_sharded_scan_matches_single_device(engine):
    from tagdust_tpu.parallel.mesh import ShardedScorer, make_mesh

    seqs, lens = _random_batch()
    B = seqs.shape[0]
    single = engine.run_batch(seqs, lens)
    scorer = ShardedScorer(engine, make_mesh(jax.devices()[:8]))
    out = scorer.run(seqs, lens, threshold=1.0)
    np.testing.assert_array_equal(np.asarray(out[3])[:B], single.labels)
    np.testing.assert_allclose(np.asarray(out[4])[:B], single.mapq, rtol=0, atol=0)
    # raw scores may differ in the last float bits (XLA reassociates
    # differently across batch shapes); decisions (labels, Q) must not
    np.testing.assert_allclose(np.asarray(out[0])[:B], single.f_score, rtol=1e-5)
    counts = np.asarray(out[5])
    assert counts.sum() == B  # padded rows masked out of the psum counters


def test_sharded_pallas_matches_sharded_scan(engine):
    """The streaming decided rows (decisions, keep bits, Q, DUST) sharded
    over 8 devices are byte-identical to the single-device rows."""
    from tagdust_tpu.parallel.mesh import ShardedScorer, make_mesh

    seqs, lens = _random_batch(B=32)
    sp = ShardedScorer(engine, make_mesh(jax.devices()[:8]))
    thr = engine.threshold_f32_ceil(2.0)
    rows8 = np.asarray(sp.dispatch_packed_decided(seqs, lens, thr, 10))
    rows1 = np.asarray(engine.dispatch_decided(seqs, lens, thr, 10))
    np.testing.assert_array_equal(rows8, rows1)


def test_runner_engages_mesh(engine, monkeypatch):
    """_score_reads_tpu must produce identical results with the mesh on
    (8 devices) and off (TAGDUST_TPU_MESH=0)."""
    from tagdust_tpu.engine.runner import _score_reads_tpu
    from tagdust_tpu.io.fastq import Read

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    rng = np.random.default_rng(3)

    def mk_reads():
        return [
            Read(seq=rng.integers(0, 4, rng.integers(20, 33)).astype(np.uint8))
            for _ in range(50)
        ]

    rng = np.random.default_rng(3)
    reads_mesh = mk_reads()
    rng = np.random.default_rng(3)
    reads_single = mk_reads()

    mb = engine.mb
    monkeypatch.setenv("TAGDUST_TPU_MESH", "1")
    # drop the engine cache so both runs build from mb identically
    from tagdust_tpu.engine import runner as R

    R.seed_engine(mb, engine, "tpu")
    _score_reads_tpu(mb, reads_mesh, -1, -1)
    assert getattr(engine, "_mesh_scorer", None), "mesh path not engaged"
    monkeypatch.setenv("TAGDUST_TPU_MESH", "0")
    _score_reads_tpu(mb, reads_single, -1, -1)

    for a, b in zip(reads_mesh, reads_single):
        # scores agree to float32 vectorization noise (XLA reassociates
        # differently across per-shard shapes); label decisions exactly
        assert abs(a.mapq - b.mapq) < 1e-4, (a.mapq, b.mapq)
        np.testing.assert_array_equal(a.labels, b.labels)
        for thr in (0.5, 1.0, 2.0, 4.0, 8.0):
            assert (a.mapq >= thr) == (b.mapq >= thr)


def _edittag(cwd):
    """A 4-barcode EDITTAG file from the in-repo generator."""
    from tagdust_tpu.edittag import greedy_barcodes, write_edittag

    path = os.path.join(cwd, "tags.txt")
    write_edittag(path, greedy_barcodes(4))
    return path


def test_cli_device_count_invariance(tmp_path):
    """tagdust -engine tpu: byte-identical demultiplexed outputs on 1 vs 8
    devices with default flags (calibration included); the per-device
    program is identical, so invariance exercises the sharding, padding
    and merge machinery."""
    cwd = str(tmp_path)
    run_tool(
        "simreads",
        [_edittag(cwd), "-seed", "42", "-sim_barnum", "4", "-sim_readlen", "20",
         "-sim_readlen_mod", "0", "-sim_numseq", "3000", "-sim_endloss", "0",
         "-sim_random_frac", "0.1", "-o", "dc.fq"],
        cwd,
    )
    outs = {}
    for n in (1, 8):
        from conftest import spawn_env

        env = spawn_env(
            TAGDUST_TPU_STRICT="1",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
        )
        res = subprocess.run(
            [sys.executable, "-m", "tagdust_tpu.cli.tagdust", "-seed", "42",
             "dc.fq", "-arch", "dc.fq_tagdust_arch.txt", "-engine", "tpu",
             "-o", f"dev{n}"],
            cwd=cwd, env=env, capture_output=True, text=True,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        files = {}
        for f in sorted(os.listdir(cwd)):
            if f.startswith(f"dev{n}_") and f.endswith(".fq"):
                with open(os.path.join(cwd, f), "rb") as fh:
                    files[f[len(f"dev{n}"):]] = fh.read()
        outs[n] = files
    assert outs[1].keys() == outs[8].keys()
    for k in outs[1]:
        assert outs[1][k] == outs[8][k], f"{k} differs between 1 and 8 devices"


def _lite_setup():
    """Small 2-barcode model + param stub for in-process streaming runs
    (keep S and B small)."""
    from types import SimpleNamespace

    from tagdust_tpu.arch import build_read_structure
    from tagdust_tpu.logsum import p2sp
    from tagdust_tpu.model import init_model_bag
    from tagdust_tpu.stats import SequenceStats

    rs = build_read_structure(["B:ACGTAC,TGCATG", "R:N"])
    ssi = SequenceStats()
    ssi.average_length = 24
    ssi.max_seq_len = 32
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    mb = init_model_bag(rs, ssi, 0.05, 0.1)
    param = SimpleNamespace(
        engine="tpu", rtest=False, matchstart=-1, matchend=-1,
        minlen=10, dust=0, num_threads=4,
    )
    return rs, mb, param


def _lite_batch(B=192):
    from tagdust_tpu.io.batch import ReadBatch
    from tagdust_tpu.io.fastq import Read

    rng = np.random.default_rng(11)
    reads = []
    for i in range(B):
        bc = ["ACGTAC", "TGCATG"][i % 2]
        tail = "".join(rng.choice(list("ACGT"), size=int(rng.integers(14, 25))))
        s = (bc + tail) if i % 7 else tail  # some bar-less rejects
        seq = np.frombuffer(s.encode(), dtype=np.uint8)
        code = np.zeros(seq.shape[0], dtype=np.uint8)
        for k, c in enumerate("ACGT"):
            code[seq == ord(c)] = k
        reads.append(Read(name=f"r{i}", seq=code, qual="I" * len(s)))
    return ReadBatch.from_reads(reads)


def test_streaming_composes_with_mesh(monkeypatch):
    """The production streaming loop must drive the 8-device mesh itself:
    dispatch_packed windows with DEPTH in flight,
    decisions identical to the single-device streaming run and to a
    one-window mesh run."""
    from tagdust_tpu.engine import runner as R
    from tagdust_tpu.parallel import mesh as mesh_mod

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "8")  # per device
    monkeypatch.setenv("TAGDUST_TPU_STRICT", "1")

    rs, mb, param = _lite_setup()

    calls = {"packed": 0}
    orig = mesh_mod.ShardedScorer.dispatch_packed
    orig_dec = mesh_mod.ShardedScorer.dispatch_packed_decided

    def spy(self, seqs, lens):
        calls["packed"] += 1
        return orig(self, seqs, lens)

    def spy_dec(self, seqs, lens, thr, minlen):
        calls["packed"] += 1
        return orig_dec(self, seqs, lens, thr, minlen)

    monkeypatch.setattr(mesh_mod.ShardedScorer, "dispatch_packed", spy)
    monkeypatch.setattr(
        mesh_mod.ShardedScorer, "dispatch_packed_decided", spy_dec
    )

    # mesh streaming run (8 virtual devices)
    monkeypatch.setenv("TAGDUST_TPU_MESH", "1")
    b_mesh = _lite_batch()
    R.run_get_label_batch(mb, rs, b_mesh, param, 10.0)
    assert calls["packed"] >= 3, "mesh streaming windows not dispatched"

    # single-device streaming run
    monkeypatch.setenv("TAGDUST_TPU_MESH", "0")
    b_one = _lite_batch()
    R.run_get_label_batch(mb, rs, b_one, param, 10.0)

    # one-window mesh run (the window caps at the batch)
    monkeypatch.setenv("TAGDUST_TPU_MESH", "1")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "100000")
    b_shot = _lite_batch()
    R.run_get_label_batch(mb, rs, b_shot, param, 10.0)

    for other in (b_one, b_shot):
        np.testing.assert_array_equal(b_mesh.read_type, other.read_type)
        np.testing.assert_array_equal(b_mesh.barcode, other.barcode)
        np.testing.assert_array_equal(b_mesh.seq_arena, other.seq_arena)
        np.testing.assert_array_equal(b_mesh.fingerprint, other.fingerprint)
        np.testing.assert_allclose(b_mesh.mapq, other.mapq, atol=1e-4)


def test_device_decisions_match_host_extractor(monkeypatch):
    """On-device extraction decisions vs the host
    columnar extractor, on an architecture with a fingerprint segment and a
    minlen that trips the too-short path: identical read_type, barcode,
    fingerprint keys, rewritten bytes and qualities."""
    from types import SimpleNamespace

    from tagdust_tpu.arch import build_read_structure
    from tagdust_tpu.engine import runner as R
    from tagdust_tpu.logsum import p2sp
    from tagdust_tpu.model import init_model_bag
    from tagdust_tpu.stats import SequenceStats

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "64")
    monkeypatch.setenv("TAGDUST_TPU_STRICT", "1")
    monkeypatch.setenv("TAGDUST_TPU_MESH", "0")

    rs = build_read_structure(["B:ACGTAC,TGCATG", "F:NNNNNNNN", "R:N"])
    ssi = SequenceStats()
    ssi.average_length = 30
    ssi.max_seq_len = 40
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    mb = init_model_bag(rs, ssi, 0.05, 0.1)
    param = SimpleNamespace(
        engine="tpu", rtest=False, matchstart=-1, matchend=-1,
        minlen=14, dust=0, num_threads=4,  # minlen trips some reads
    )

    def mk_batch():
        from tagdust_tpu.io.batch import ReadBatch
        from tagdust_tpu.io.fastq import Read

        rng = np.random.default_rng(23)
        reads = []
        for i in range(160):
            bc = ["ACGTAC", "TGCATG"][i % 2]
            umi = "".join(rng.choice(list("ACGT"), size=8))
            tail = "".join(
                rng.choice(list("ACGT"), size=int(rng.integers(8, 26)))
            )
            s = (bc + umi + tail) if i % 6 else (umi + tail)
            seq = np.frombuffer(s.encode(), dtype=np.uint8)
            code = np.zeros(seq.shape[0], dtype=np.uint8)
            for k, c in enumerate("ACGT"):
                code[seq == ord(c)] = k
            reads.append(Read(name=f"u{i}", seq=code, qual="I" * len(s)))
        return ReadBatch.from_reads(reads)

    results = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("TAGDUST_TPU_DEVICE_DECISIONS", mode)
        b = mk_batch()
        R.run_get_label_batch(mb, rs, b, param, 2.0)
        results[mode] = b

    dev, host = results["1"], results["0"]
    np.testing.assert_array_equal(dev.read_type, host.read_type)
    np.testing.assert_array_equal(dev.barcode, host.barcode)
    np.testing.assert_array_equal(dev.fingerprint, host.fingerprint)
    np.testing.assert_array_equal(dev.seq_arena, host.seq_arena)
    np.testing.assert_array_equal(dev.qual_arena, host.qual_arena)
    np.testing.assert_allclose(dev.mapq, host.mapq, atol=0)
    # both outcome classes present, else the comparison proves little
    assert (dev.read_type == 0).any() and (dev.read_type != 0).any()


def test_cli_streaming_device_count_invariance(tmp_path):
    """Full CLI byte identity 1-vs-8 devices with the PRODUCTION streaming
    path engaged (small tiles and windows; -Q pins the threshold so the run
    is calibration-free).  The 8-device leg streams sharded
    windows (ShardedScorer.dispatch_packed), the 1-device leg streams
    single-device windows — the file set must not notice."""
    cwd = str(tmp_path)
    run_tool(
        "simreads",
        [_edittag(cwd), "-seed", "42", "-sim_barnum", "4", "-sim_readlen", "20",
         "-sim_readlen_mod", "0", "-sim_numseq", "1500", "-sim_endloss", "0",
         "-sim_random_frac", "0.1", "-o", "sc.fq"],
        cwd,
    )
    outs = {}
    for n in (1, 8):
        from conftest import spawn_env

        env = spawn_env(
            rtest=False,
            TAGDUST_TPU_BT="8",
            TAGDUST_TPU_WINDOW="128",
            TAGDUST_TPU_STRICT="1",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
        )
        res = subprocess.run(
            [sys.executable, "-m", "tagdust_tpu.cli.tagdust", "-seed", "42",
             "sc.fq", "-arch", "sc.fq_tagdust_arch.txt", "-engine", "tpu",
             "-Q", "10", "-o", f"sdev{n}"],
            cwd=cwd, env=env, capture_output=True, text=True,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        files = {}
        for f in sorted(os.listdir(cwd)):
            if f.startswith(f"sdev{n}_") and f.endswith(".fq"):
                with open(os.path.join(cwd, f), "rb") as fh:
                    files[f[len(f"sdev{n}"):]] = fh.read()
        outs[n] = files
    assert outs[1].keys() == outs[8].keys()
    for k in outs[1]:
        assert outs[1][k] == outs[8][k], f"{k} differs between 1 and 8 devices"


def test_nibble_gate_rows_identical(monkeypatch):
    """Decided-mode rows must be byte-identical with nibble-packed and
    plain uploads (TAGDUST_TPU_NIBBLE=1/0) — the A/B lever must never
    change results."""
    from tagdust_tpu.engine import runner as R

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    rs, mb, param = _lite_setup()
    R.seed_engine(mb, R.get_engine(mb, "tpu"), "tpu")
    eng = R.get_engine(mb, "tpu")
    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 5, (16, 32)).astype(np.uint8)
    lens = rng.integers(10, 33, 16).astype(np.int32)
    rows = {}
    for nib in ("1", "0"):
        monkeypatch.setenv("TAGDUST_TPU_NIBBLE", nib)
        out = eng.dispatch_decided(seqs, lens, np.float32(2.0), 10)
        rows[nib] = np.asarray(out)
    np.testing.assert_array_equal(rows["1"], rows["0"])


@pytest.mark.parametrize("specs,minlen", [
    (["P:GGGG", "B:ACGTAC,TGCATG", "R:N"], 8),
    (["B:AC,GT", "S:TTT", "R:N"], 6),
    (["F:NNNNNN", "R:N"], 10),
    (["B:ACGTAC,TGCATG", "R:N", "P:TTTT"], 12),
])
def test_device_decisions_arch_sweep(monkeypatch, specs, minlen):
    """Device-vs-host extraction decision equality across segment-type
    combinations (P/S/F/B placements), with N and '.' codes in the reads —
    the decided mode is the default production path, so every grammar the
    host extractor handles must decide identically on device."""
    from types import SimpleNamespace

    from tagdust_tpu.arch import build_read_structure
    from tagdust_tpu.engine import runner as R
    from tagdust_tpu.io.batch import ReadBatch
    from tagdust_tpu.io.fastq import Read
    from tagdust_tpu.logsum import p2sp
    from tagdust_tpu.model import init_model_bag
    from tagdust_tpu.stats import SequenceStats

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "32")
    monkeypatch.setenv("TAGDUST_TPU_STRICT", "1")
    monkeypatch.setenv("TAGDUST_TPU_MESH", "0")

    rs = build_read_structure(specs)
    ssi = SequenceStats()
    ssi.average_length = 26
    ssi.max_seq_len = 40
    ssi.background = [float(p2sp(p)) for p in (0.26, 0.24, 0.25, 0.24, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    mb = init_model_bag(rs, ssi, 0.05, 0.1)
    param = SimpleNamespace(
        engine="tpu", rtest=False, matchstart=-1, matchend=-1,
        minlen=minlen, dust=0, num_threads=4,
    )

    def mk_batch():
        rng = np.random.default_rng(hash(tuple(specs)) & 0xFFFF)
        reads = []
        for i in range(96):
            n = int(rng.integers(12, 36))
            seq = rng.integers(0, 4, n).astype(np.uint8)
            # sprinkle N (4) and '.' (5) codes — both flow through the
            # nibble packing and the device tables
            if i % 5 == 0 and n > 4:
                seq[2] = 4
            if i % 11 == 0 and n > 6:
                seq[4] = 5
            reads.append(Read(name=f"s{i}", seq=seq, qual="I" * n))
        return ReadBatch.from_reads(reads)

    results = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("TAGDUST_TPU_DEVICE_DECISIONS", mode)
        b = mk_batch()
        R.run_get_label_batch(mb, rs, b, param, 1.0)
        results[mode] = b
    dev, host = results["1"], results["0"]
    np.testing.assert_array_equal(dev.read_type, host.read_type)
    np.testing.assert_array_equal(dev.barcode, host.barcode)
    np.testing.assert_array_equal(dev.fingerprint, host.fingerprint)
    np.testing.assert_array_equal(dev.seq_arena, host.seq_arena)
    np.testing.assert_array_equal(dev.qual_arena, host.qual_arena)

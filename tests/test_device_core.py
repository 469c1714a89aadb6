"""The core-parameterised device pipelines on the plain XLA core.

Every device entry point (one-shot scoring, packed and decided streaming
rows, score-only detection) runs the DP core handed to `TpuEngine` and one
shared post-DP code path.  These tests pin each pipeline against an
independent reference: the one-shot scorer, the host columnar extractor,
the backward scan, and the bit-exact C-parity engine.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.edittag import greedy_barcodes
from tagdust_tpu.engine.exact import ExactEngine
from tagdust_tpu.engine.tpu import TpuEngine, xla_core
from tagdust_tpu.extract import compute_q
from tagdust_tpu.logsum import p2sp
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats


def _model(segs, avg=26, mx=40):
    ssi = SequenceStats()
    ssi.average_length = avg
    ssi.max_seq_len = mx
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(build_read_structure(segs), ssi, 0.05, 0.1)


_CODE = {c: i for i, c in enumerate("ACGT")}


def _reads(barcodes, B, L, seed, tail=(12, 30)):
    """[B, L] codes: barcode + random tail for most reads, fully random
    reads for every 5th; lens ragged."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(*tail))
        if i % 5:
            bc = np.array([_CODE[c] for c in barcodes[i % len(barcodes)]])
            seqs[i, : bc.size] = bc
            n += bc.size
        lens[i] = min(n, L)
    return seqs, lens


def _exact(mb, seqs, lens):
    """Per-read labels and Q from the bit-exact engine (length buckets with
    the [B, L+1] terminator layout)."""
    ex = ExactEngine(mb)
    B, L = seqs.shape
    q = np.zeros(B)
    labels = np.zeros((B, L + 1), np.int32)
    for Lb in np.unique(lens):
        idx = np.nonzero(lens == Lb)[0]
        sb = np.zeros((idx.size, int(Lb) + 1), np.uint8)
        sb[:, :Lb] = seqs[idx, :Lb]
        res = ex.run_batch(sb, int(Lb))
        q[idx] = compute_q(res.f_score, res.r_score, res.bar_prob)
        labels[idx, : Lb + 1] = res.labels
    return labels, q


def test_packed_rows_match_run_batch():
    """One packed uint8 row per read (labels | f, r, bar, Q | DUST) decodes
    to exactly what the one-shot scorer returns."""
    mb = _model(["B:ACGTAC,TGCATG,CCAAGG", "R:N"])
    eng = TpuEngine(mb)
    seqs, lens = _reads(["ACGTAC", "TGCATG", "CCAAGG"], 24, 32, seed=1)
    ref = eng.run_batch(seqs, lens)
    got = eng.collect_packed(eng.dispatch_packed(seqs, lens), 24, 32)
    np.testing.assert_array_equal(got.labels, ref.labels)
    for a, b in ((got.f_score, ref.f_score), (got.r_score, ref.r_score),
                 (got.bar_prob, ref.bar_prob), (got.mapq, ref.mapq)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert got.dust.shape == (24, 2)


def test_decided_rows_match_host_extractor():
    """Device extraction decisions (read type, barcode, fingerprint key,
    keep bits) equal the host columnar extractor run on the one-shot
    labels, on an architecture with a fingerprint and a tripping minlen."""
    from tagdust_tpu.extract import apply_device_decisions, extract_batch_columnar
    from tagdust_tpu.io.batch import ReadBatch
    from tagdust_tpu.io.fastq import Read

    mb = _model(["B:ACGTAC,TGCATG", "F:NNNNNN", "R:N"], avg=30)
    eng = TpuEngine(mb)
    seqs, lens = _reads(["ACGTAC", "TGCATG"], 40, 40, seed=2, tail=(8, 30))
    thr, minlen = 2.0, 12

    def batch():
        return ReadBatch.from_reads(
            [Read(name=f"r{i}", seq=seqs[i, : lens[i]].copy(),
                  qual="I" * int(lens[i])) for i in range(len(lens))]
        )

    host = batch()
    one = eng.run_batch(seqs, lens)
    host.mapq[:] = one.mapq.astype(np.float64)
    extract_batch_columnar(mb, mb.rs, host, one.labels, minlen, thr)

    dev = batch()
    rows = eng.dispatch_decided(seqs, lens, eng.threshold_f32_ceil(thr), minlen)
    apply_device_decisions(
        dev, eng.collect_decided(rows, len(lens), 40), eng.required_finger_len()
    )
    np.testing.assert_array_equal(dev.read_type, host.read_type)
    np.testing.assert_array_equal(dev.barcode, host.barcode)
    np.testing.assert_array_equal(dev.fingerprint, host.fingerprint)
    np.testing.assert_array_equal(dev.seq_arena, host.seq_arena)
    assert (dev.read_type == 0).any() and (dev.read_type != 0).any()


def test_score_only_matches_backward_scan():
    """Detection's score-only sweep equals the full core's logP_b (the same
    shared backward recurrence, no stacks)."""
    mb = _model(["P:GGG", "B:ACGTAC,TGCATG", "R:N"])
    eng = TpuEngine(mb)
    seqs, lens = _reads(["ACGTAC", "TGCATG"], 16, 32, seed=3)
    _, logpb, _, _ = xla_core(eng._dev)(
        jnp.asarray(seqs.astype(np.int32)), jnp.asarray(lens)
    )
    np.testing.assert_allclose(
        eng.backward_scores(seqs, lens), np.asarray(logpb), rtol=1e-6,
        atol=1e-5,
    )


def test_ragged_long_reads_match_exact():
    """Lp=150 with ragged lengths: labels equal the exact engine's and Q
    agrees within the table-logsum tolerance."""
    mb = _model(["B:ACGT,TGCA", "R:N"], avg=120, mx=160)
    eng = TpuEngine(mb)
    seqs, lens = _reads(["ACGT", "TGCA"], 8, 150, seed=4, tail=(96, 146))
    res = eng.run_batch(seqs, lens)
    labels, q = _exact(mb, seqs, lens)
    assert res.labels.shape[1] == 151
    for b in range(8):
        n = int(lens[b])
        np.testing.assert_array_equal(
            res.labels[b, 1 : n + 1].astype(np.int32), labels[b, 1 : n + 1]
        )
    assert np.nanmax(np.abs(res.mapq - q)) < 0.15


@pytest.mark.parametrize("n_barcodes", [8, 24, 48])
def test_core_decisions_match_exact(n_barcodes):
    """Device-core label paths equal the exact engine's, and Q agrees
    within the table-logsum tolerance, from small lattices to the
    48-barcode one (S=591 states)."""
    bcs = greedy_barcodes(n_barcodes)
    mb = _model([f"B:{','.join(bcs)}", "R:N"], avg=30, mx=48)
    eng = TpuEngine(mb)
    seqs, lens = _reads(bcs, 16, 32, seed=n_barcodes, tail=(14, 26))
    res = eng.run_batch(seqs, lens)
    labels, q = _exact(mb, seqs, lens)
    for b in range(16):
        n = int(lens[b])
        np.testing.assert_array_equal(
            res.labels[b, 1 : n + 1].astype(np.int32), labels[b, 1 : n + 1]
        )
    assert np.nanmax(np.abs(res.mapq - q)) < 0.15


@pytest.mark.parametrize("B,cap", [(131072, 40960), (868928, 60928),
                                   (50000, 60928), (1000, 200), (16, 6)])
def test_block_rows_same_shape_on_any_device_count(B, cap):
    """Blocks are whole tiles within the cap, pad each block by less than a
    tile, and come in a multiple of SPLIT when the batch is large: 1, 2, 4
    or 8 devices, one block each per window, then need no padded block."""
    eng = TpuEngine(_model(["B:ACGTAC,TGCATG", "R:N"]))
    blk = eng.block_rows(B, cap)
    bt = min(eng.default_batch_tile(), cap, B)
    n_blk = -(-B // blk)
    assert blk <= cap and blk % bt == 0
    assert n_blk <= -(-(-(-B // cap)) // eng.SPLIT) * eng.SPLIT
    for n_dev in (2, 4, 8):
        windows = -(-n_blk // n_dev)
        if n_blk % eng.SPLIT == 0:
            assert windows * n_dev == n_blk  # no padded blocks
    assert n_blk * blk - B < n_blk * bt  # under one tile of padding per block


def test_bytes_per_read_is_xla_count_and_bounds_windows():
    """bytes_per_read is XLA's own memory count of the program, linear in
    the batch, and max_batch keeps a dispatch within the budget."""
    eng = TpuEngine(_model(["B:ACGTAC,TGCATG,CCAAGG", "R:N"]))
    per = eng.bytes_per_read("decided", 32)
    B = 3 * eng.PROBE_TILES * eng.default_batch_tile()
    fn, specs = eng._program("decided", 32, B)
    assert specs[0].shape == (B, 16)  # nibble-packed upload
    m = fn.lower(*specs).compile().memory_analysis()
    big = (m.temp_size_in_bytes + m.argument_size_in_bytes
           + m.output_size_in_bytes) / B
    assert 0.9 * per <= big <= per * 1.001
    cap = eng.max_batch(32, "decided", depth=3)
    assert cap % eng.default_batch_tile() == 0
    assert cap * per <= eng.memory_budget_bytes() / 3


def test_float32_core_moves_a_near_tie_under_q10(tmp_path):
    """With ``-Q 10`` the threshold is 0 (the reference's quirk), so every
    read's label path decides its file.  READ36509 is a label-DP near tie:
    the device core in plain float32 (the CPU; no TF32) files it in
    ``_un`` where the exact engine's table arithmetic files it under
    CGCGAT.  Not every read the device decides differently from the exact
    engine under ``-Q 10`` is a TF32 effect.  The input is reads 36490-36529
    of ``simreads -seed 42 -sim_barnum 20 -sim_readlen 50 -sim_readlen_mod 0
    -sim_endloss 0 -sim_random_frac 0.1 -sim_error_rate 0.02`` over
    ``greedy_barcodes(20)`` (the input of chip_smoke.py)."""
    import os

    from tagdust_tpu.cli.tagdust import main

    fq = os.path.join(os.path.dirname(__file__), "data", "q10_near_tie.fq")
    arch = ["-1", f"B:{','.join(greedy_barcodes(20))}", "-2", "R:N"]

    def files_of(label):
        out = {}
        for f in os.listdir(tmp_path):
            if f.startswith(label + "_") and f.endswith(".fq"):
                lines = (tmp_path / f).read_text().splitlines()
                for i in range(0, len(lines), 4):
                    out[lines[i].split(";")[0]] = f[len(label):]
        return out

    for eng in ("exact", "tpu"):
        main([fq, *arch, "-engine", eng, "-Q", "10",
              "-o", str(tmp_path / eng)])
    ex, dv = files_of("exact"), files_of("tpu")
    assert len(ex) == len(dv) == 40
    moved = {n for n in ex if ex[n] != dv[n]}
    assert moved == {"@READ36509"}
    assert ex["@READ36509"] == "_BC_CGCGAT.fq"
    assert dv["@READ36509"] == "_un.fq"

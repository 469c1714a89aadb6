"""Batch orchestration over the DP engines: bucketing, scoring, extraction.

Plays the role of the reference's ``run_pHMM`` thread fan-out
(``barcode_hmm.c:1895-2029``): score every read, convert scores to Q, decode
labels, extract, then run the artifact/DUST filters.  Reads are bucketed by
length so each engine call sees a rectangular ``[B, L]`` batch; per-read
results are independent of the bucketing, exactly as the reference results
are independent of its thread split.

The thread-slice geometry (``interval = numseq/num_threads``,
``barcode_hmm.c:1911-1922``) is still emulated where it is observable: the
artifact filter's 4-wide batching has a per-slice remainder path
(``barcode_hmm.c:2496-2579``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..constants import EXTRACT_FAIL_LOW_COMPLEXITY, EXTRACT_SUCCESS
from ..extract import compute_q, extract_batch
from ..filters import dust_reads, match_to_reference
from ..io.fastq import Read
from ..model import ModelBag
from .exact import ExactEngine

_F32 = np.float32


def thread_slices(numseq: int, num_threads: int) -> List[tuple]:
    """barcode_hmm.c:1911-1922."""
    interval = int(float(numseq) / float(num_threads))
    slices = [(t * interval, t * interval + interval) for t in range(num_threads)]
    s, _ = slices[-1]
    slices[-1] = (s, numseq)
    return slices


def _build_batches(reads: List[Read], matchstart: int, matchend: int):
    """Group read indices by effective DP length; build [B, L+1] buffers with
    the position after the subsequence (terminator 'A' or the next real
    char), as read by the backward pass."""
    buckets: Dict[int, List[int]] = {}
    for idx, r in enumerate(reads):
        L = r.len
        if matchstart != -1 or matchend != -1:
            L = matchend - matchstart
        buckets.setdefault(L, []).append(idx)
    out = []
    for L, idxs in buckets.items():
        B = len(idxs)
        seqs = np.zeros((B, L + 1), dtype=np.uint8)
        for bi, idx in enumerate(idxs):
            r = reads[idx]
            if matchstart != -1 or matchend != -1:
                sub = r.seq[matchstart : matchend + 1]
                seqs[bi, : sub.shape[0]] = sub
            else:
                seqs[bi, : r.len] = r.seq
        out.append((L, idxs, seqs))
    return out


_ENGINE_CACHE: dict = {}
_RESOLVED_AUTO: dict = {}


def resolve_engine(param) -> str:
    """Map ``-engine {auto,exact,tpu}`` to a concrete engine kind.

    ``auto`` (the default) selects the device engine when JAX's backend is
    a GPU: a default-flag run on a GPU host takes the device path, not the
    host C-parity engine.  Exceptions keeping ``exact``:

    * explicit ``-engine exact``;
    * ``-rtest`` — the deterministic gold mode pins the bit-exact engine so
      outputs stay bit-identical to the reference's ``*_rtest`` builds.

    A JAX backend that fails to start raises.
    """
    eng = getattr(param, "engine", "auto")
    if eng == "tpu":
        return "tpu"
    if eng != "auto" or getattr(param, "rtest", False):
        return "exact"
    kind = _RESOLVED_AUTO.get("kind")
    if kind is None:
        from ..jax_env import jax

        kind = "tpu" if jax.default_backend() == "gpu" else "exact"
        _RESOLVED_AUTO["kind"] = kind
    return kind


def _engine_key(mb: ModelBag, kind: str):
    """The cache key shape for get_engine.  Single source of truth — tests
    that pre-seed the cache must go through seed_engine so they cannot
    drift when the key grows a component."""
    dig = getattr(mb, "_digest_cache", None)
    if dig is None:
        dig = mb._digest_cache = mb.digest()
    return (dig, kind)


def seed_engine(mb: ModelBag, eng, kind: str = "tpu") -> None:
    """Install a pre-built engine into the cache under the canonical key
    (test hook — keeps fixtures in sync with _engine_key's shape)."""
    _ENGINE_CACHE[_engine_key(mb, kind)] = eng


def get_engine(mb: ModelBag, kind: str):
    """Engines (and their jitted device programs) are cached by model
    CONTENT, so repeated controller invocations with the same architecture
    (calibration -> production, or back-to-back runs in one process) reuse
    the compiled pipeline instead of recompiling per ModelBag object."""
    key = _engine_key(mb, kind)
    if key not in _ENGINE_CACHE:
        if kind == "tpu":
            from .tpu import TpuEngine

            _ENGINE_CACHE[key] = TpuEngine(mb)
        else:
            _ENGINE_CACHE[key] = ExactEngine(mb)
    return _ENGINE_CACHE[key]


def score_reads(
    mb: ModelBag,
    reads: List[Read],
    matchstart: int = -1,
    matchend: int = -1,
    want_labels: bool = True,
    engine: Optional[ExactEngine] = None,
    engine_kind: str = "exact",
):
    """backward + posterior decode + Q for every read; stores mapq (and
    labels) on the reads.  Mirrors do_label_thread / do_probability_estimation
    (barcode_hmm.c:2174-2340)."""
    if engine_kind == "tpu":
        return _score_reads_tpu(mb, reads, matchstart, matchend, want_labels)
    eng = engine or get_engine(mb, "exact")
    for L, idxs, seqs in _build_batches(reads, matchstart, matchend):
        if L <= 0:
            for idx in idxs:
                reads[idx].mapq = float("nan")
            continue
        res = eng.run_batch(seqs, L)
        q = compute_q(res.f_score, res.r_score, res.bar_prob)
        for bi, idx in enumerate(idxs):
            reads[idx].mapq = float(q[bi])
            if want_labels:
                reads[idx].labels = res.labels[bi]


def _mesh_scorer(eng, batch: int):
    """Cached ShardedScorer over all local devices (production multi-device
    path — the device analogue of run_pHMM's thread fan-out, with
    psum-reduced outcome counters).  Returns None on single-device hosts,
    when the batch is too small to give every device a tile, or when
    disabled via TAGDUST_TPU_MESH=0."""
    from ..jax_env import jax

    if os.environ.get("TAGDUST_TPU_MESH", "1") == "0":
        return None
    n = len(jax.devices())
    if n < 2 or batch < n * eng.default_batch_tile():
        return None
    scorer = getattr(eng, "_mesh_scorer", None)
    if scorer is None:
        from ..parallel.mesh import ShardedScorer, make_mesh

        scorer = eng._mesh_scorer = ShardedScorer(eng, make_mesh())
    return scorer


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    """x padded to n rows with copies of its row 0 (zero rows can be
    impossible reads -> deliberate NaN Q, hostile to jax_debug_nans)."""
    if x.shape[0] == n:
        return x
    return np.concatenate(
        [x, np.broadcast_to(x[:1], (n - x.shape[0],) + x.shape[1:])]
    )


def _run_sharded(scorer, eng, seqs, lens_arr, want_labels):
    """Score one padded batch over the device mesh.  Each device scores
    blocks of the size `TpuEngine.run_batch` dispatches on one device
    (`TpuEngine.block_rows`), so every device runs the program shape one
    device runs."""
    from .tpu import TpuBatchResult

    B, Lp = seqs.shape
    step = scorer.n * eng.block_rows(B, eng.max_batch(Lp))
    parts = [[] for _ in range(5)]
    for s in range(0, B, step):
        nb = min(step, B - s)
        out = scorer.run(
            _pad_rows(seqs[s : s + nb], step),
            _pad_rows(lens_arr[s : s + nb], step),
        )
        for i in range(5):
            if i == 3 and not want_labels:
                continue  # skip the device->host label transfer
            parts[i].append(np.asarray(out[i])[:nb])
    cat = lambda p: p[0] if len(p) == 1 else np.concatenate(p)  # noqa: E731
    return TpuBatchResult(
        f_score=cat(parts[0]),
        r_score=cat(parts[1]),
        bar_prob=cat(parts[2]),
        labels=cat(parts[3]) if want_labels else None,
        mapq=cat(parts[4]),
    )


def _pad_tpu_batch(seqs: np.ndarray, lens_arr: np.ndarray):
    """Pad [B, L] inputs to compile-cache-friendly shapes: length bucketed to
    multiples of 32, batch to powers of two up to 32k then 32k granules.
    Pad rows are copies of read 0 (zero rows can be impossible reads ->
    deliberate NaN Q in discarded rows, hostile to jax_debug_nans)."""
    B, L = seqs.shape
    Lpad = max(((L + 31) // 32) * 32, 32)
    if B <= 32768:
        Bpad = 1 << max(8, (B - 1).bit_length())
    else:
        Bpad = ((B + 32767) // 32768) * 32768
    out = np.zeros((Bpad, Lpad), dtype=np.uint8)
    out[:B, :L] = seqs
    lens = np.ones(Bpad, dtype=np.int32)
    lens[:B] = lens_arr
    if Bpad > B:
        out[B:] = out[0]
        lens[B:] = lens[0]
    return out, lens


def score_arrays_tpu(eng, seqs: np.ndarray, lens_arr: np.ndarray,
                     want_labels: bool = True):
    """Score one already-padded [Bpad, Lpad] batch on the device engine.

    With more than one visible device the batch is sharded data-parallel
    over the full device mesh (`parallel/mesh.py`), running the same
    per-device program; decisions are device-count-invariant (asserted by
    tests/test_multichip.py)."""
    scorer = _mesh_scorer(eng, seqs.shape[0])
    if scorer is not None:
        return _run_sharded(scorer, eng, seqs, lens_arr, want_labels)
    return eng.run_batch(seqs, lens_arr, want_labels=want_labels)


# padded-length ladder for _score_reads_tpu's buckets.  Every rung used is
# a separately compiled program shape, so _choose_rungs picks at most
# TAGDUST_TPU_LEN_BUCKETS (default 3) rungs that minimize the total padded
# bases.
_LEN_LADDER = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
               3072, 4096)


def _choose_rungs(lens: np.ndarray) -> list:
    """Pick <= TAGDUST_TPU_LEN_BUCKETS ladder rungs covering every length,
    minimizing sum(padded length) — the DP compute is linear in the padded
    length, so this directly minimizes device work under the compile-count
    budget.  The rung covering the max length is always included."""
    import itertools

    Lmax = int(lens.max(initial=1))
    top = int(np.searchsorted(_LEN_LADDER, max(Lmax, 1)))
    if top >= len(_LEN_LADDER):
        return [((Lmax + 31) // 32) * 32]
    cands = [lp for lp in _LEN_LADDER[: top + 1] if lp >= int(lens.min())]
    # covering invariant: _LEN_LADDER[top] >= Lmax >= lens.min(), so the
    # top rung always survives the filter
    assert cands, "length ladder must cover lens.min()"
    max_b = max(1, int(os.environ.get("TAGDUST_TPU_LEN_BUCKETS", "3")))
    if len(cands) <= max_b:
        return cands
    # exact padded-base cost per candidate subset via per-rung counts
    idx = np.searchsorted(np.asarray(cands), lens)
    cnt = np.bincount(idx, minlength=len(cands)).astype(np.int64)
    best, best_cost = None, None
    last = len(cands) - 1
    for sub in itertools.combinations(range(last), max_b - 1):
        chosen = list(sub) + [last]
        cost = 0
        j = 0
        for i in range(len(cands)):
            while chosen[j] < i:
                j += 1
            cost += int(cnt[i]) * cands[chosen[j]]
        if best_cost is None or cost < best_cost:
            best, best_cost = chosen, cost
    return [cands[i] for i in best]


def _score_reads_tpu(mb, reads, matchstart, matchend, want_labels=True):
    """Device path over per-read objects (calibration/detection consumers).

    Reads are scored in LENGTH BUCKETS: calibration's emitted reads carry
    the model's geometric length tail (avg 55 -> p50 ~90, max ~700 on the
    bench arch), so padding the whole 400k-read batch to the max wastes
    ~8x the DP compute and shrinks the memory-budget sub-batches ~12x.  Each
    bucket pads to the _LEN_LADDER rung covering its longest read and
    scores independently; results scatter back by original index."""
    eng = get_engine(mb, "tpu")
    B = len(reads)
    if not B:
        return None
    sub = matchstart != -1 or matchend != -1
    lens = np.fromiter(
        ((matchend - matchstart) if sub else r.len for r in reads),
        dtype=np.int32, count=B,
    )
    ladder = _choose_rungs(lens)
    bucket_of = np.searchsorted(np.asarray(ladder), lens)

    mapq_out = np.empty(B, dtype=np.float32)
    labels_out = None
    for b, Lp in enumerate(ladder):
        idxs = np.nonzero(bucket_of == b)[0]
        if idxs.size == 0:
            continue
        seqs = np.zeros((idxs.size, Lp), dtype=np.uint8)
        for bi, i in enumerate(idxs):
            r = reads[int(i)]
            if sub:
                s = r.seq[matchstart:matchend]
                seqs[bi, : s.shape[0]] = s
            else:
                seqs[bi, : r.len] = r.seq
        pseqs, plens = _pad_tpu_batch(seqs, lens[idxs])
        res = score_arrays_tpu(eng, pseqs, plens, want_labels)
        mapq_out[idxs] = res.mapq[: idxs.size]
        if res.labels is not None:
            if labels_out is None:
                labels_out = np.zeros(
                    (B, ladder[-1] + 1), dtype=res.labels.dtype
                )
            labels_out[idxs, : res.labels.shape[1]] = res.labels[: idxs.size]
    for i, r in enumerate(reads):
        r.mapq = float(mapq_out[i])
        if labels_out is not None:
            r.labels = labels_out[i]
    return labels_out


def run_get_label(
    mb: ModelBag,
    rs,
    reads: List[Read],
    param,
    confidence_threshold: float,
    contaminants=None,
) -> None:
    """MODE_GET_LABEL (do_label_thread, barcode_hmm.c:2269-2360)."""
    kind = resolve_engine(param)
    labels_mat = score_reads(
        mb, reads, param.matchstart, param.matchend, want_labels=True,
        engine_kind=kind,
    )
    # extraction is a vectorised pass over the [B, Lpad+1] label matrix
    # instead of a per-base Python walk per read (both engines; equality
    # with the per-read extract_read path is asserted by tests).  Moderate
    # slices keep the numpy temporaries in reused (warm) malloc blocks —
    # first-touch page faults on fresh huge buffers are expensive on some
    # hosts.
    SL = 16384
    for s in range(0, len(reads), SL):
        grp = reads[s : s + SL]
        if labels_mat is not None:
            mat = labels_mat[s : s + SL]
        else:
            # exact engine: per-read label arrays -> one padded matrix
            wid = max(
                (r.labels.shape[0] if r.labels is not None else 1)
                for r in grp
            )
            mat = np.zeros((len(grp), wid), dtype=np.int32)
            for i, r in enumerate(grp):
                if r.labels is not None:
                    mat[i, : r.labels.shape[0]] = r.labels
        extract_batch(
            mb,
            rs,
            grp,
            mat,
            param.minlen,
            confidence_threshold,
            param.matchstart,
            param.matchend,
        )
    _apply_filters(reads, param, contaminants)


def run_rna_dust(reads: List[Read], param, contaminants=None) -> None:
    """MODE for pure R:N architectures (do_rna_dust, barcode_hmm.c:2370-2395)."""
    for r in reads:
        r.read_type = EXTRACT_SUCCESS
    _apply_filters(reads, param, contaminants)


def _apply_filters(reads: List[Read], param, contaminants) -> None:
    if contaminants is not None:
        on_device = resolve_engine(param) == "tpu"
        for s, e in thread_slices(len(reads), param.num_threads):
            match_to_reference(
                reads[s:e], contaminants, param.filter_error, device=on_device
            )
    if param.dust:
        SL = 16384
        for s in range(0, len(reads), SL):
            dust_reads(reads[s : s + SL], param.dust)


def _score_batch_columnar(mb, batch, matchstart, matchend):
    """Score a columnar ReadBatch on the exact engine; fills batch.mapq and
    returns the [B, Lpad+1] label matrix."""
    B = batch.B
    full_lens = batch.lens
    sub = matchstart != -1 or matchend != -1
    # exact engine: length-bucketed batches gathered from the arena
    eng = get_engine(mb, "exact")
    dec_lens = (
        np.full(B, matchend - matchstart, dtype=np.int64) if sub else full_lens
    )
    Lmax = int(dec_lens.max(initial=0))
    labels_out = np.zeros((B, Lmax + 1), dtype=np.int32)
    cap = max(batch.seq_arena.shape[0] - 1, 0)
    order = np.argsort(dec_lens, kind="stable")
    uls, starts = np.unique(dec_lens[order], return_index=True)
    bounds = list(starts) + [B]
    for k, L in enumerate(uls):
        idxs = order[bounds[k] : bounds[k + 1]]
        L = int(L)
        if L <= 0:
            batch.mapq[idxs] = float("nan")
            continue
        # [Bb, L+1] window incl. the position after the subsequence
        # (terminator or next char), as read by the backward pass
        base = batch.seq_off[:-1][idxs] + (matchstart if sub else 0)
        if sub:
            vlen = np.clip(
                np.minimum(full_lens[idxs], matchend + 1) - matchstart, 0, None
            )
        else:
            vlen = full_lens[idxs]
        pos = np.arange(L + 1, dtype=np.int64)[None, :]
        seqs_b = batch.seq_arena[
            np.minimum(base[:, None] + pos, cap)
        ].copy()
        seqs_b[pos >= vlen[:, None]] = 0
        res = eng.run_batch(seqs_b, L)
        q = compute_q(res.f_score, res.r_score, res.bar_prob)
        batch.mapq[idxs] = q.astype(np.float64)
        labels_out[idxs, : L + 1] = res.labels
    return labels_out


def _label_tpu_streaming(mb, rs, batch, param, confidence_threshold) -> None:
    """Pipelined device labeling: score in fixed windows with up to DEPTH
    dispatches in flight, extracting window k on the host while the device
    computes k+1..k+DEPTH (the host<->device analogue of the reference's
    popen decompression overlap, io.c:459-606).

    With more than one visible device the SAME loop drives the whole mesh:
    each window is sharded data-parallel over the devices and runs the
    identical per-device packed program (`ShardedScorer.dispatch_packed`),
    so the multi-device production path keeps every single-device
    optimization — DEPTH dispatches in flight, one packed fetch per window,
    async device->host copies, device DUST.  The window size scales by the
    device count (same per-device memory budget), matching the reference's
    count-invariant thread fan-out (barcode_hmm.c:1895-2029).

    A device failure raises."""
    from collections import deque

    from ..extract import extract_batch_columnar
    from ..io.batch import padded_matrix

    B = batch.B
    if not B:
        return
    matchstart, matchend = param.matchstart, param.matchend
    sub = matchstart != -1 or matchend != -1
    eng = get_engine(mb, "tpu")
    full_lens = batch.lens
    Lmax = int(
        (matchend - matchstart) if sub else int(full_lens.max(initial=1))
    )
    Lpad = max(((Lmax + 31) // 32) * 32, 32)
    scorer = _mesh_scorer(eng, B)  # None on single-device hosts
    n_dev = scorer.n if scorer is not None else 1
    DEPTH = int(os.environ.get("TAGDUST_TPU_PIPELINE_DEPTH", "3"))
    rfl = eng.required_finger_len()
    # DEVICE-DECIDED mode (default): the extraction decision tree runs on
    # the device alongside the DP and labels never leave the device — the
    # host receives decisions + keep bits and only rewrites bytes
    # (extract.apply_device_decisions).  Gated off for subrange decodes and
    # >27nt fingerprints (host extractor keeps those exact), or via
    # TAGDUST_TPU_DEVICE_DECISIONS=0.
    decided = (
        not sub
        and rfl <= 27
        and os.environ.get("TAGDUST_TPU_DEVICE_DECISIONS", "1") == "1"
    )
    # Per-device window W1: the chunk cut into `block_rows` blocks within
    # the memory budget shared by DEPTH windows in flight
    # (TAGDUST_TPU_WINDOW overrides the cap).  A window is one block per
    # device; W1 does not depend on the device count.
    BT = eng.default_batch_tile()
    wenv = os.environ.get("TAGDUST_TPU_WINDOW")
    cap = (
        max(int(wenv) // BT * BT, BT)
        if wenv
        else eng.max_batch(
            Lpad, "decided" if decided else "packed", depth=DEPTH
        )
    )
    W1 = eng.block_rows(B, cap)
    W = W1 * n_dev

    cap = max(batch.seq_arena.shape[0] - 1, 0)

    def _window(s: int, e: int):
        n = e - s
        Wp = W
        lens_w = np.ones(Wp, dtype=np.int32)
        if sub:
            off = batch.seq_off[s:e] + matchstart
            w = np.clip(
                np.minimum(full_lens[s:e], matchend) - matchstart, 0, None
            )
            pos = np.arange(Lpad, dtype=np.int64)[None, :]
            seqs = batch.seq_arena[
                np.minimum(off[:, None] + pos, cap)
            ].copy()
            seqs[pos >= w[:, None]] = 0
            lens_w[:n] = matchend - matchstart
        else:
            seqs = padded_matrix(
                batch.seq_arena, batch.seq_off[s : e + 1], full_lens[s:e],
                Lpad, 0,
            )
            lens_w[:n] = full_lens[s:e]
        if Wp > n:
            seqs = _pad_rows(seqs, Wp)
            lens_w[n:] = lens_w[0]
        return seqs, lens_w

    from ..jax_env import jax

    inflight: deque = deque()  # dispatched, compute possibly running
    ready: deque = deque()  # compute done, device->host copy in flight

    dust_dev = None
    if not sub:
        # device DUST variants (extracted, raw); the sub-range path keeps
        # host dust (its label-buffer quirks differ)
        dust_dev = np.empty((B, 2), dtype=np.float32)

    if decided:
        from ..extract import apply_device_decisions

        thr32 = eng.threshold_f32_ceil(confidence_threshold)
        minlen = int(param.minlen)

    def _extract(s, e, out):
        win = batch.slice(s, e)
        if decided:
            res = eng.collect_decided(out, e - s, Lpad)
            if dust_dev is not None:
                dust_dev[s:e] = res["dust"]
            apply_device_decisions(win, res, rfl)
            return
        res = eng.collect_packed(out, e - s, Lpad)
        if dust_dev is not None and res.dust is not None:
            dust_dev[s:e] = res.dust
        win.mapq[:] = res.mapq.astype(np.float64)
        extract_batch_columnar(
            mb, rs, win, res.labels, param.minlen, confidence_threshold,
            matchstart, matchend,
        )
        if win.fp_big:
            batch.fp_big.update({s + k: v for k, v in win.fp_big.items()})
            batch.fingerprint[s:e][list(win.fp_big)] = -2

    def _stage():
        # two-stage consume: block on the oldest dispatch, START its
        # device->host copy, then extract the PREVIOUS window whose copy has
        # been in flight meanwhile — the fetch then finds the bytes already
        # on the host, its round trip hidden behind the extraction work
        s, e, out = inflight.popleft()
        jax.block_until_ready(out)
        try:
            out.copy_to_host_async()
        except Exception:
            pass  # fetch-on-demand still correct
        ready.append((s, e, out))
        if len(ready) > 1:
            _extract(*ready.popleft())

    if decided:
        if scorer is not None:
            dispatch = lambda s_, l_: scorer.dispatch_packed_decided(  # noqa: E731
                s_, l_, thr32, minlen
            )
        else:
            dispatch = lambda s_, l_: eng.dispatch_decided(  # noqa: E731
                s_, l_, thr32, minlen
            )
    else:
        dispatch = (
            scorer.dispatch_packed
            if scorer is not None
            else eng.dispatch_packed
        )
    for s in range(0, B, W):
        e = min(s + W, B)
        seqs, lens_w = _window(s, e)
        inflight.append((s, e, dispatch(seqs, lens_w)))
        if len(inflight) >= DEPTH:
            _stage()
    while inflight:
        _stage()
    while ready:
        _extract(*ready.popleft())
    batch.dust_device = dust_dev


def run_get_label_batch(
    mb: ModelBag,
    rs,
    batch,
    param,
    confidence_threshold: float,
    contaminants=None,
) -> None:
    """MODE_GET_LABEL over a columnar ReadBatch (the production hot path)."""
    from ..extract import extract_batch_columnar
    from ..filters import dust_batch_columnar, match_to_reference_columnar

    kind = resolve_engine(param)
    batch.dust_device = None
    if kind == "tpu":
        _label_tpu_streaming(mb, rs, batch, param, confidence_threshold)
    else:
        labels_mat = _score_batch_columnar(
            mb, batch, param.matchstart, param.matchend
        )
        extract_batch_columnar(
            mb,
            rs,
            batch,
            labels_mat,
            param.minlen,
            confidence_threshold,
            param.matchstart,
            param.matchend,
        )
    # extraction outcome decides which sequence the dust filter would see:
    # extracted (spacered) for successes, raw for rejects — captured BEFORE
    # the artifact filter rewrites read_type (seq state is unaffected by it)
    was_success = batch.read_type == EXTRACT_SUCCESS
    if contaminants is not None:
        match_to_reference_columnar(
            batch, contaminants, param.filter_error,
            device=resolve_engine(param) == "tpu",
        )
    if param.dust:
        dd = getattr(batch, "dust_device", None)
        if dd is not None:
            score = np.where(was_success, dd[:, 0], dd[:, 1])
            with np.errstate(invalid="ignore"):
                batch.read_type[score > param.dust] = (
                    EXTRACT_FAIL_LOW_COMPLEXITY
                )
        else:
            dust_batch_columnar(batch, param.dust)


def run_rna_dust_batch(batch, param, contaminants=None) -> None:
    """Pure R:N architectures over a columnar ReadBatch."""
    from ..filters import dust_batch_columnar, match_to_reference_columnar

    batch.read_type[:] = EXTRACT_SUCCESS
    if contaminants is not None:
        match_to_reference_columnar(
            batch, contaminants, param.filter_error,
            device=resolve_engine(param) == "tpu",
        )
    if param.dust:
        dust_batch_columnar(batch, param.dust)


def run_get_prob(
    mb: ModelBag, seq_list: List[np.ndarray], engine_kind: str = "exact"
) -> np.ndarray:
    """MODE_GET_PROB for calibration: mapq per raw sequence.

    With ``engine_kind='tpu'`` the threshold is calibrated on the same
    scoring function production uses (and the 400k-read sweep runs on
    device), straight from the sequence arrays — no per-read Python
    objects on the 400k-read default path."""
    if engine_kind == "tpu":
        return _score_seq_arrays_tpu(mb, seq_list)
    reads = [Read(seq=s) for s in seq_list]
    score_reads(mb, reads, want_labels=False, engine_kind=engine_kind)
    return np.array([r.mapq for r in reads], dtype=np.float32)


def _score_seq_arrays_tpu(mb, seq_list) -> np.ndarray:
    """Array-native GET_PROB: the length-bucketed device sweep of
    `_score_reads_tpu` without `Read` object wrappers (scores only)."""
    B = len(seq_list)
    if not B:
        return np.zeros(0, dtype=np.float32)
    eng = get_engine(mb, "tpu")
    lens = np.fromiter(
        (s.shape[0] for s in seq_list), dtype=np.int32, count=B
    )
    ladder = _choose_rungs(lens)
    bucket_of = np.searchsorted(np.asarray(ladder), lens)
    mapq_out = np.empty(B, dtype=np.float32)
    for b, Lp in enumerate(ladder):
        idxs = np.nonzero(bucket_of == b)[0]
        if idxs.size == 0:
            continue
        sq = np.zeros((idxs.size, Lp), dtype=np.uint8)
        for bi, i in enumerate(idxs):
            s = seq_list[int(i)]
            sq[bi, : s.shape[0]] = s
        pseqs, plens = _pad_tpu_batch(sq, lens[idxs])
        res = score_arrays_tpu(eng, pseqs, plens, want_labels=False)
        mapq_out[idxs] = res.mapq[: idxs.size]
    return mapq_out

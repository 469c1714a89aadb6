"""Device DP engine: batched scaled forward/backward over the closure lattice.

Consumes the closure-compiled lattice (`engine/lattice.py`).  One DP step for
a batch of reads is a single dense matmul:

    W[b, (s,c)] = v[b,s] * onehot(c_b)[c]        (outer product)
    v[i]        = W @ A'                          (A': [5S, S])

i.e. the per-base transition-matrix selection is folded into a one-hot
expansion of the source vector, so the whole step is one
``[B,5S] x [5S, S+K]`` contraction (the K extra columns carry the
entry-only flows used for the barcode probability).  The backward pass uses
the transposed stack over the reversed sequence; per-position label
posteriors, the optimal-accuracy label DP (max-plus over the
label-compatibility matrix, mirroring ``barcode_hmm.c:4451-4514``) and the
traceback all stay on device.  Per-step max-rescaling keeps linear-space
probabilities in float32 range; per-read log-scales accumulate alongside.

The DP is a *core*, ``core(seqs_i32, lens) -> (f_log, logP_b, labels, tp)``
(``tp`` = the entry-flow totals), handed to the engine as a parameter.
Everything after it — barcode probability, random-model score, Q, device
DUST, the extraction decisions and the row packing — is one plain-jnp code
path, whichever core runs under it.  `xla_core` is the plain reference core
and the production core.

Ragged batches: reads are right-padded; padded steps freeze the carry via
masks, so one compiled program serves a whole length bucket.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..jax_env import jax
import jax.numpy as jnp

from .lattice import Lattice, compile_lattice
from ..model import ModelBag

# Precision of every DP matmul: DEFAULT, which is TF32 inputs with float32
# accumulation on the GPU's tensor cores (plain float32 on the CPU).  Chosen
# over HIGHEST (slower) and bf16 inputs (Q moves up to the gate's bound) by
# the decision-identity gate against the exact engine; TF32 also moves a
# few label-DP near ties that float32 keeps.  The measurements are in
# PERF.md.
DP_PRECISION = jax.lax.Precision.DEFAULT


def _mm(a, b):
    return jnp.matmul(a, b, precision=DP_PRECISION)


@dataclass
class TpuBatchResult:
    f_score: np.ndarray  # [B] log P(x|M), natural log
    r_score: np.ndarray  # [B] log P(x|R)
    bar_prob: np.ndarray  # [B] log barcode probability
    labels: np.ndarray  # [B, Lpad+1] label path
    mapq: np.ndarray  # [B] Q values
    dust: Optional[np.ndarray] = None  # [B, 2] device DUST (extracted, raw)


def dust_scores_device(seqs, labels, lens, is_r_label):
    """Device replica of the DUST score (filters._dust_scores_core /
    barcode_hmm.c:2424-2453) over the first-64nt window, returning BOTH
    variants per read as [B, 2] float32:

    * column 0: on the extracted sequence (non-R-labelled bases = spacers) —
      what the filter sees for successfully extracted reads;
    * column 1: on the raw sequence — what it sees for rejected reads.

    The host picks per read by the post-extraction outcome.  Keys use the
    same 2-bit packing as the host core (pair counts are invariant under key
    relabeling); counts come from a one-hot [B, pos, 64] reduction.
    """
    B, Lp = seqs.shape
    W = 64
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    ln = jnp.minimum(lens, W).astype(jnp.int32)[:, None]
    if Lp >= W:
        arr = seqs[:, :W]
        lab = labels[:, 1 : W + 1]
    else:
        arr = jnp.pad(seqs, ((0, 0), (0, W - Lp)))
        lab = jnp.pad(labels, ((0, 0), (0, W - Lp)))[:, 1 : W + 1]
    non_r = jnp.take(
        jnp.asarray(~is_r_label), jnp.clip(lab, 0, is_r_label.shape[0] - 1)
    )
    beyond = pos >= ln
    b2 = (arr & 3).astype(jnp.int32)
    key = jnp.zeros((B, W), dtype=jnp.int32)
    key = key.at[:, 2:].set((b2[:, 2:] << 4) | (b2[:, 1:-1] << 2) | b2[:, :-2])

    def one(is_sp):
        real = ~is_sp
        lead = jnp.where(
            real.any(axis=1), jnp.argmax(real, axis=1), ln[:, 0]
        ).astype(jnp.int32)
        degenerate = (lead + 1) >= lens
        after = pos >= (lead + 2)[:, None]
        sp_after = is_sp & after
        first_sp = jnp.where(
            sp_after.any(axis=1), jnp.argmax(sp_after, axis=1), W
        ).astype(jnp.int32)
        counted = after & (pos < first_sp[:, None])
        oh = jax.nn.one_hot(jnp.where(counted, key, W + 1), W, dtype=jnp.float32)
        c = jnp.sum(oh, axis=1)  # [B, 64]
        s = jnp.sum(c * (c - 1.0) * 0.5, axis=1)
        ntrip = counted.sum(axis=1).astype(jnp.float32)
        c_final = lead.astype(jnp.float32) + 2.0 + ntrip
        denom = jnp.where(c_final == 3.0, jnp.nan, c_final - 3.0)
        return jnp.where(degenerate, 0.0, s / denom * 10.0)

    d_ext = one(non_r | beyond)
    d_raw = one(beyond)
    return jnp.stack([d_ext, d_raw], axis=1)


def nibble_uploads() -> bool:
    """Ship sequence uploads nibble-packed (2 bases/byte)?  Default on;
    TAGDUST_TPU_NIBBLE=0 reverts to plain uint8 uploads (A/B lever — the
    win depends on the host->device link's bytes/s vs the packing cost)."""
    return os.environ.get("TAGDUST_TPU_NIBBLE", "1") == "1"


def unpack_nibbles_device(sp, Lp: int):
    """Device inverse of TpuEngine.pack_nibbles: [B, Lp/2] packed uint8 ->
    [B, Lp] codes.  THE one unpack — the layout (base 2k in the low nibble,
    2k+1 in the high) must match the host pack everywhere."""
    B = sp.shape[0]
    lo = sp & 0xF
    hi = sp >> 4
    return jnp.stack([lo, hi], axis=2).reshape(B, Lp)


def _expand(v, oh, S):
    """[B,S] x [B,5] -> [B, 5S] with layout (c, s)."""
    return (oh[:, :, None] * v[:, None, :]).reshape(v.shape[0], 5 * S)


def backward_scan(Abwd, end, S, onehot, active, with_stack):
    """THE rescaled backward recurrence over the closure lattice — the one
    definition shared by the reference core (`xla_core`), the detection
    scorer (_backward_scores) and the distributed Baum-Welch counts
    (parallel/mesh.py) so a numerics change (the m>0 clamp, the 1e-38
    floor) can never diverge between them.

    Returns (bfin, bls_fin, bwd_stack, bls_stack); the stacks are None
    when ``with_stack`` is False (score-only consumers skip the stack).
    ``bwd_stack[j]`` is the backward vector over positions j+1.. (``end``
    at the last position): the scan runs in reverse and stacks the carry
    it receives, so the stack is written once, in place, in position
    order."""
    B = onehot.shape[0]

    def bwd_step(carry, x):
        bv, ls = carry  # [B,S], [B]
        oh, act = x
        bn = _mm(_expand(bv, oh, S), Abwd)  # [B,S]
        m = jnp.max(bn, axis=1, keepdims=True)
        m = jnp.where(m > 0, m, 1.0)
        bn = bn / m
        nls = ls + jnp.log(m[:, 0])
        bv = jnp.where(act[:, None], bn, bv)
        nls = jnp.where(act, nls, ls)
        return (bv, nls), (carry if with_stack else None)

    b0 = jnp.broadcast_to(end[None, :], (B, S))
    ls0 = jnp.zeros((B,), jnp.float32)
    xs_b = (jnp.swapaxes(onehot, 0, 1), active.T)
    (bfin, bls_fin), ys = jax.lax.scan(
        bwd_step, (b0, ls0), xs_b, reverse=True
    )
    if not with_stack:
        return bfin, bls_fin, None, None
    bwd_stack, bls_stack = ys
    return bfin, bls_fin, bwd_stack, bls_stack


def _dp_core(lat_dev, seqs, lens):
    """The plain DP core over the closure lattice: the backward scan, the
    forward scan with the fused label DP, and the traceback.
    seqs [B, Lpad] int32, lens [B] int32 ->
    (f_log [B], logP_b [B], labels [B, Lpad+1] int32, tp [B, K])."""
    Afwd = lat_dev["Afwd"]  # [5S, S+K]  (fused A | Aent)
    Abwd = lat_dev["Abwd"]  # [5S, S]    (transposed stack)
    end = lat_dev["end"]  # [S]
    Lmap = lat_dev["Lmap"]  # [S, H+1]
    tmat = lat_dev["tmat"]  # [H, H]
    begin = lat_dev["begin"]
    S = lat_dev["S"]
    K = lat_dev["K"]

    B, Lpad = seqs.shape
    H = tmat.shape[0]

    pos = jnp.arange(Lpad)
    active = pos[None, :] < lens[:, None]  # [B, Lpad]
    onehot = jax.nn.one_hot(seqs, 5, dtype=jnp.float32)  # [B, Lpad, 5]

    # ---------------- backward scan (reversed) ----------------
    bfin, bls_fin, bwd_stack, bls_stack = backward_scan(
        Abwd, end, S, onehot, active, with_stack=True
    )
    ls0 = jnp.zeros((B,), jnp.float32)  # forward scan's initial log-scale

    logP_b = jnp.log(jnp.maximum(bfin[:, begin], 1e-38)) + bls_fin

    # ------- forward scan: posterior reduction + fused label DP -------
    # (the label DP is the optimal-accuracy recursion of barcode_hmm.c:4451,
    #  fused into the forward sweep to avoid materialising the posterior
    #  stack)
    ent_sel = lat_dev["ent_sel"]  # [S, K] one-hot gather of bwd values
    jidx = jnp.arange(H, dtype=jnp.int32)[None, :]

    def fwd_step(carry, x):
        v, ls, tp, dp = carry  # [B,S], [B], [B,K], [B,H]
        oh, act, bw, bls = x
        Y = _mm(_expand(v, oh, S), Afwd)  # [B, S+K]
        vn = Y[:, :S]
        ve = Y[:, S:]
        # clamp: on inactive (padded) steps the stale scales can make the
        # exponent overflow; inf * 0 posteriors would produce masked-away
        # NaNs that still trip jax_debug_nans (active values are << e^60)
        w = jnp.exp(jnp.minimum(ls + bls - logP_b, 60.0))  # [B]
        post = vn * bw
        plab = _mm(post, Lmap) * w[:, None]
        tpn = tp + ve * _mm(bw, ent_sel) * w[:, None]
        m = jnp.max(vn, axis=1, keepdims=True)
        m = jnp.where(m > 0, m, 1.0)
        vn2 = vn / m
        nls = ls + jnp.log(m[:, 0])
        v = jnp.where(act[:, None], vn2, v)
        nls = jnp.where(act, nls, ls)
        tp = jnp.where(act[:, None], tpn, tp)
        # label DP step
        scores = dp[:, :, None] * tmat[None, :, :]  # [B,c,j]
        mv = jnp.argmax(scores, axis=1).astype(jnp.int32)
        mx = jnp.max(scores, axis=1)
        diag = dp * jnp.diagonal(tmat)[None, :]
        mv = jnp.where(diag == mx, jidx, mv)
        ndp = plab[:, :H] + mx
        dp = jnp.where(act[:, None], ndp, dp)
        mv = jnp.where(act[:, None], mv, jidx)
        return (v, nls, tp, dp), mv.astype(jnp.int8)

    v0 = jnp.zeros((B, S), jnp.float32).at[:, begin].set(1.0)
    tp0 = jnp.zeros((B, K), jnp.float32)
    dp0 = jnp.zeros((B, H), jnp.float32)
    xs_f = (jnp.swapaxes(onehot, 0, 1), active.T, bwd_stack, bls_stack)
    (vfin, fls_fin, total_ent, dpfin), path = jax.lax.scan(
        fwd_step, (v0, ls0, tp0, dp0), xs_f
    )
    f_lin = jnp.maximum(_mm(vfin, end), 1e-38)
    f_log = jnp.log(f_lin) + fls_fin
    last = jnp.argmax(dpfin, axis=1).astype(jnp.int32)

    def tb_step(move, pth):
        nm = jnp.take_along_axis(pth.astype(jnp.int32), move[:, None], axis=1)[:, 0]
        return nm, nm

    _, lab_rev = jax.lax.scan(tb_step, last, path[::-1])
    labels = jnp.concatenate([lab_rev[::-1], last[None, :]], axis=0).T
    return f_log, logP_b, labels, total_ent


def xla_core(lat_dev) -> Callable:
    """The plain reference core (two `lax.scan`s XLA compiles for any
    backend), with the engine's lattice tensors bound."""
    return functools.partial(_dp_core, lat_dev)


def _r_scores(lat_dev, seqs, lens):
    """log P(x|R): the random model over the active bases."""
    avg_len = lat_dev["avg_len"]
    active = jnp.arange(seqs.shape[1])[None, :] < lens[:, None]
    bg_l = jnp.log(lat_dev["bg"])
    return (
        jnp.sum(jnp.where(active, bg_l[seqs], 0.0), axis=1)
        + lens.astype(jnp.float32) * jnp.log1p(-1.0 / avg_len)
        + jnp.log(1.0 / avg_len)
    )


def score_batch(lat_dev, core, seqs, lens):
    """The post-DP scoring shared by every core: seqs [B, Lp] int codes ->
    (f_log, r_log, bar_log, labels, mapq)."""
    seqs = seqs.astype(jnp.int32)
    f_log, _, labels, tp = core(seqs, lens)
    bar_log = lat_dev["bar_fn"](tp)
    r_log = _r_scores(lat_dev, seqs, lens)
    return f_log, r_log, bar_log, labels, _q_from_scores(f_log, r_log, bar_log)


def _forward_backward(lat_dev, seqs, lens):
    """Full scoring on the plain core. seqs [B, Lpad] int32, lens [B] int32."""
    return score_batch(lat_dev, xla_core(lat_dev), seqs, lens)


def _backward_scores(lat_dev, seqs, lens):
    """Backward-only log P(x|M) — the device MODE_ARCH_COMP scorer
    (do_arch_comparison, barcode_hmm.c:2111-2148): just the backward scan of
    the core, no posterior/label work and no per-step stacks, so
    architecture detection costs one sweep per candidate."""
    Abwd = lat_dev["Abwd"]
    end = lat_dev["end"]
    begin = lat_dev["begin"]
    S = lat_dev["S"]
    B, Lpad = seqs.shape
    pos = jnp.arange(Lpad)
    active = pos[None, :] < lens[:, None]
    onehot = jax.nn.one_hot(seqs, 5, dtype=jnp.float32)

    bfin, bls_fin, _, _ = backward_scan(
        Abwd, end, S, onehot, active, with_stack=False
    )
    return jnp.log(jnp.maximum(bfin[:, begin], 1e-38)) + bls_fin


def _q_from_scores(f_log, r_log, bar_log):
    """Q exactly as do_label_thread computes it (barcode_hmm.c:2318-2336):
    p_wrong==0 -> 40, ==1 -> 0, else -10*log10(p_wrong) UNCLAMPED — Q above
    40 (and NaN for a negative p_wrong) flows through like the C double
    math.  An upper clamp here cost |dQ| up to 3.6 vs the exact engine on
    high-confidence reads."""
    denom = jnp.logaddexp(f_log, r_log)
    p_wrong = 1.0 - jnp.exp(bar_log + f_log - denom)
    return jnp.where(
        p_wrong == 0.0,
        40.0,
        jnp.where(p_wrong == 1.0, 0.0, -10.0 * jnp.log10(p_wrong)),
    )


class TpuEngine:
    """Batched device scorer for one compiled model.

    ``core`` is the DP core (see the module docstring); by default the
    plain `xla_core`."""

    # Share of the device's memory limit that the buffers of one program
    # (above all the backward stack) may take, summed over the dispatches
    # in flight; backends that report no limit (the CPU) get a fixed budget.
    MEMORY_FRACTION = 0.25
    HOST_BUDGET_BYTES = 1 << 30
    # A batch is cut into a multiple of SPLIT equal blocks (block_rows).
    SPLIT = 8
    # bytes_per_read compiles its probe for this many tiles of reads.
    PROBE_TILES = 64

    def __init__(
        self,
        mb: ModelBag,
        lattice: Optional[Lattice] = None,
        core: Optional[Callable] = None,
    ):
        self.mb = mb
        lat = lattice or compile_lattice(mb)
        self.lat = lat
        S = lat.S
        K = lat.Aent.shape[2]
        ent_state = np.zeros(K, dtype=np.int32)
        k = 0
        si = 0
        for j, m in enumerate(mb.models):
            for f in range(m.num_hmms):
                if m.num_hmms > 1:
                    ent_state[k] = si  # M(j,f,0)
                    ent_state[k + 1] = si + 1  # I(j,f,0)
                    k += 2
                si += 2 * m.num_cols
        Lmap = np.zeros((S, lat.num_labels + 1), dtype=np.float32)
        for s in range(S):
            Lmap[s, lat.state_label[s]] = 1.0
        ent_sel = np.zeros((S, K), dtype=np.float32)
        for k in range(K):
            ent_sel[ent_state[k], k] = 1.0

        # fused step matrices, layout (c, s) on the contraction axis
        # Afwd[(c,s), t] = A[c][s, t] ; extra K columns = Aent
        Afwd = np.concatenate([lat.A, lat.Aent], axis=2)  # [5, S, S+K]
        Afwd = Afwd.reshape(5 * S, S + K)
        # Abwd[(c,t), s] = A[c][s, t]
        Abwd = np.swapaxes(lat.A, 1, 2).reshape(5 * S, S)

        bar_segments = lat.bar_segments

        def bar_fn(total_ent):
            B = total_ent.shape[0]
            if total_ent.shape[1] == 0:
                return jnp.zeros((B,), jnp.float32)
            per_f = total_ent[:, 0::2] + total_ent[:, 1::2]
            logs = jnp.log(jnp.maximum(per_f, 1e-38))
            out = jnp.zeros((B,), jnp.float32)
            col = 0
            for (lab0, Hn, j) in bar_segments:
                seg = logs[:, col : col + Hn]
                norm = jax.scipy.special.logsumexp(seg, axis=1)
                best = jnp.max(seg[:, : Hn - 1], axis=1) - norm
                out = out + best
                col += Hn
            return jnp.minimum(out, 0.0)

        self._dev = {
            "Afwd": jnp.asarray(Afwd),
            "Abwd": jnp.asarray(Abwd),
            "end": jnp.asarray(lat.end),
            "Lmap": jnp.asarray(Lmap),
            "ent_state": jnp.asarray(ent_state),
            "ent_sel": jnp.asarray(ent_sel),
            "tmat": jnp.asarray(lat.tmatrix),
            "bg": jnp.asarray(lat.background),
            "avg_len": jnp.float32(lat.avg_len),
            "begin": lat.begin,
            "S": S,
            "K": K,
            "bar_fn": bar_fn,
        }
        self.core = core if core is not None else xla_core(self._dev)
        self._fns: dict = {}

    def backward_scores(self, seqs: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """[B] backward-only log P(x|M) for architecture auto-detection
        (MODE_ARCH_COMP, test_architectures.c:182-184) — one masked backward
        sweep on device, no labels, no posterior stack."""
        if "bscore" not in self._fns:
            self._fns["bscore"] = jax.jit(
                functools.partial(_backward_scores, self._dev)
            )
        out = self._fns["bscore"](
            jnp.asarray(seqs.astype(np.int32)),
            jnp.asarray(lens.astype(np.int32)),
        )
        return np.asarray(out)

    # ---------------- batch geometry ----------------
    def default_batch_tile(self) -> int:
        """Granularity (reads) of streaming windows and mesh shards: every
        window is a whole number of tiles per device, so a run compiles a
        handful of window shapes.  Override: TAGDUST_TPU_BT (multiples of
        8; small tiles keep the CPU tests' windows small)."""
        bt = os.environ.get("TAGDUST_TPU_BT")
        if bt:
            return max(int(bt) // 8 * 8, 8)
        return 256

    def _program(self, program: str, Lp: int, B: int):
        """(jitted fn, argument specs for B reads) of one of the engine's
        device programs: "score" (one-shot scoring), "packed" or "decided"
        (streaming rows)."""
        spec = jax.ShapeDtypeStruct
        w = Lp // 2 if Lp % 2 == 0 and nibble_uploads() else Lp
        lens = spec((B,), jnp.int32)
        if program == "score":
            return self._get_upload(Lp)[0], [spec((B, w), jnp.uint8), lens]
        if program == "packed":
            return self._get_packed(Lp)[0], [spec((B, Lp), jnp.uint8), lens]
        return self._get_decided(Lp)[0], [
            spec((B, w), jnp.uint8), lens, spec((), jnp.float32),
            spec((), jnp.int32),
        ]

    def bytes_per_read(self, program: str, Lp: int) -> float:
        """Device bytes one read of padded length Lp takes in ``program``
        (see _program): XLA's own count for the program compiled at
        PROBE_TILES tiles of reads (temporaries, arguments and outputs),
        divided by the reads.  Fixed costs are spread over the probe's
        reads, so the figure errs high.  Cached per program and Lp."""
        key = ("bytes", program, Lp)
        if key not in self._fns:
            B = self.PROBE_TILES * self.default_batch_tile()
            fn, specs = self._program(program, Lp, B)
            m = fn.lower(*specs).compile().memory_analysis()
            self._fns[key] = (
                m.temp_size_in_bytes
                + m.argument_size_in_bytes
                + m.output_size_in_bytes
            ) / B
        return self._fns[key]

    def memory_budget_bytes(self) -> int:
        """Device bytes the engine's buffers may take on one device:
        MEMORY_FRACTION of the device's reported memory limit."""
        stats = jax.devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        if not limit:
            return self.HOST_BUDGET_BYTES
        return int(limit * self.MEMORY_FRACTION)

    def max_batch(self, Lp: int, program: str = "score",
                  depth: int = 1) -> int:
        """Most reads of padded length Lp one dispatch of ``program`` may
        hold on one device with ``depth`` dispatches in flight, in whole
        tiles."""
        gran = self.default_batch_tile()
        b = self.memory_budget_bytes() // max(depth, 1)
        b = int(b // self.bytes_per_read(program, Lp))
        return max(b // gran * gran, gran)

    def block_rows(self, B: int, cap: int) -> int:
        """Reads per device per dispatch for a batch of B reads, at most
        ``cap``: B cut into a multiple of SPLIT equal blocks of whole tiles.
        It depends on B and cap only, never on the device count: 1, 2, 4 or
        8 devices share the blocks without padding rows, and every device
        runs the program shape that one device runs.  On a GPU a read's
        result can depend on the batch shape (the GEMMs are tuned per
        shape), so equal shapes are what keep the output independent of
        the device count."""
        bt = min(self.default_batch_tile(), cap, B)
        k = -(-B // cap)
        k = -(-k // self.SPLIT) * self.SPLIT
        return min(-(-B // (k * bt)) * bt, cap)

    # ---------------- jitted pipelines ----------------
    def _lab_dtype(self):
        return jnp.int8 if self._lab_bytes() == 1 else jnp.int32

    def _get_scorer(self, Lp: int):
        """(jitted, raw) full scorer: (seqs_u8 [B, Lp], lens) ->
        (f_log, r_log, bar_log, labels [B, Lp+1], mapq).  The raw fn is what
        `parallel/mesh.py` wraps per shard under shard_map."""
        key = ("score", Lp)
        if key not in self._fns:
            lat_dev, core, lab_dtype = self._dev, self.core, self._lab_dtype()

            def full(seqs_u8, lens):
                f, r, b, lab, q = score_batch(lat_dev, core, seqs_u8, lens)
                return f, r, b, lab.astype(lab_dtype), q

            self._fns[key] = (jax.jit(full), full)
        return self._fns[key]

    def _get_upload(self, Lp: int):
        """(jitted scorer on uploaded rows, pack): with ``pack`` the rows
        arrive nibble-packed (half the host->device bytes — the calibration
        sweep's dominant transfer)."""
        pack = Lp % 2 == 0 and nibble_uploads()
        key = ("upload", Lp, pack)
        if key not in self._fns:
            _, full = self._get_scorer(Lp)
            if pack:
                self._fns[key] = jax.jit(
                    lambda sp, ln: full(unpack_nibbles_device(sp, Lp), ln)
                )
            else:
                self._fns[key] = jax.jit(full)
        return self._fns[key], pack

    def run_batch(
        self, seqs: np.ndarray, lens: np.ndarray, want_labels: bool = True
    ) -> TpuBatchResult:
        """One-shot scoring of seqs [B, Lp] (codes, zero-padded), lens [B].

        The batch is scored in equal blocks of `block_rows` reads within
        the memory budget (the last one padded with copies of read 0, so
        every dispatch of this batch compiles ONE program).
        ``want_labels=False`` skips the device->host label transfer —
        calibration only consumes Q."""
        B, Lp = seqs.shape
        fn, pack = self._get_upload(Lp)
        blk = self.block_rows(B, self.max_batch(Lp))
        if B % blk:
            # pad with copies of read 0: zero-filled length-1 pad reads can
            # be impossible under the model (P(x|M)=0 -> deliberate NaN Q),
            # which would leak NaNs into the discarded rows and trip
            # jax_debug_nans
            pad = blk - B % blk
            seqs = np.concatenate(
                [seqs, np.broadcast_to(seqs[:1], (pad, Lp))], axis=0
            )
            lens = np.concatenate([lens, np.broadcast_to(lens[:1], (pad,))])
        outs = []
        for s in range(0, seqs.shape[0], blk):
            sb = seqs[s : s + blk].astype(np.uint8)
            outs.append(
                fn(
                    jnp.asarray(self.pack_nibbles(sb) if pack else sb),
                    jnp.asarray(lens[s : s + blk].astype(np.int32)),
                )
            )
        f_log, r_log, bar_log, labels, mapq = (
            outs[0]
            if len(outs) == 1
            else tuple(jnp.concatenate(parts, axis=0) for parts in zip(*outs))
        )
        return TpuBatchResult(
            f_score=np.asarray(f_log)[:B],
            r_score=np.asarray(r_log)[:B],
            bar_prob=np.asarray(bar_log)[:B],
            labels=np.asarray(labels)[:B] if want_labels else None,
            mapq=np.asarray(mapq)[:B],
        )

    def _get_packed(self, Lp: int):
        """(jitted, raw) variant returning ONE uint8 buffer per batch:
        [B, lab_bytes*(Lp+1) + 24] = bitcast labels | bitcast (f, r, bar, q,
        dust_ext, dust_raw).

        One packed array means one device->host fetch per window instead of
        six.  The raw fn is what `parallel/mesh.py` wraps per shard under
        shard_map — the multi-device streaming path runs the SAME packed
        program per device."""
        key = ("packed", Lp)
        if key not in self._fns:
            _, full = self._get_scorer(Lp)
            is_r = self._is_r_label()

            def full_packed(seqs_u8, lens):
                f, r, b, lab, q = full(seqs_u8, lens)
                dust = dust_scores_device(
                    seqs_u8.astype(jnp.int32), lab.astype(jnp.int32), lens,
                    is_r,
                )
                sc = jnp.stack([f, r, b, q], axis=1)  # [B, 4] f32
                sc = jnp.concatenate([sc, dust], axis=1)  # [B, 6] f32
                scb = jax.lax.bitcast_convert_type(sc, jnp.uint8).reshape(
                    sc.shape[0], 24
                )
                if lab.dtype == jnp.int8:
                    labb = lab.astype(jnp.uint8)  # values are 0..H, lossless
                else:
                    labb = jax.lax.bitcast_convert_type(
                        lab.astype(jnp.int32), jnp.uint8
                    ).reshape(lab.shape[0], -1)
                return jnp.concatenate([labb, scb], axis=1)

            self._fns[key] = (jax.jit(full_packed), full_packed)
        return self._fns[key]

    def dispatch_packed(self, seqs: np.ndarray, lens: np.ndarray):
        """Asynchronously dispatch one packed-pipeline batch; returns the
        packed device array WITHOUT blocking — callers overlap host work
        (extraction of the previous window) with device compute and the
        result transfer."""
        fn, _ = self._get_packed(seqs.shape[1])
        return fn(
            jnp.asarray(seqs.astype(np.uint8)),
            jnp.asarray(lens.astype(np.int32)),
        )

    def required_finger_len(self) -> int:
        """Total F-segment length — delegates to the ONE definition in
        extract.py so the device gate and the host extractors agree."""
        from ..extract import required_finger_length

        return required_finger_length(self.mb.rs)

    def _label_tables(self) -> dict:
        """Per-label decode tables for the on-device extraction decisions —
        the SAME tables the host columnar extractor uses
        (extract.label_decode_tables); cached per engine."""
        cached = getattr(self, "_lab_tables_cache", None)
        if cached is None:
            from ..extract import label_decode_tables

            cached = self._lab_tables_cache = label_decode_tables(
                self.mb, self.mb.rs
            )
        return cached

    def _lab_bytes(self) -> int:
        """Bytes per label in packed rows: int8 whenever the label alphabet
        allows (values 0..H fit 127), else int32.  THE one cutoff shared by
        the scorer, the packed-row code and the collector — mismatched
        copies would slice packed rows at wrong offsets."""
        n_labels = int(np.asarray(self._dev["Lmap"]).shape[1])
        return 1 if n_labels + 1 <= 127 else 4

    def _get_decided(self, Lp: int):
        """Packed pipeline WITH the per-read extraction decisions computed
        on device (extract_reads' decision tree, barcode_hmm.c:3203-3304,
        evaluated on the label path while it is still resident):

        * pass/fail vs the confidence threshold (f32-ceiled so the compare
          equals the host's float64 semantics exactly),
        * per-R-segment minimum-length check,
        * barcode segment+alternative id with null-N rejection,
        * fingerprint 2-bit key packing (<= 27 F bases; two uint32 halves),
        * the keep-bit mask (label-is-R per position) the host needs for
          the spacer rewrite.

        One uint8 row per read:
        ``keep_bits[Lp/8] | read_type[1] | bar_mem i32[4] | fp_lo u32[4] |
        fp_hi u32[4] | q f32[4] | dust f32[8]`` — Lp/8 + 25 bytes, vs
        lab_bytes*(Lp+1) + 24 for the label-carrying row: the host no
        longer downloads (or walks) labels at all, and the raw f/r/bar
        scores stay on device too (production only consumes Q).
        Returns ``(jitted, raw)``.
        """
        nib = nibble_uploads()
        key = ("decided", Lp, nib)
        if key not in self._fns:
            assert Lp % 8 == 0
            _, full = self._get_scorer(Lp)
            T = self._label_tables()
            nlab = T["seg"].shape[0]
            is_R = jnp.asarray(T["is_R"])
            is_B = jnp.asarray(T["is_B"])
            is_F = jnp.asarray(T["is_F"])
            null_b = jnp.asarray(T["null_b"])
            alt_t = jnp.asarray(T["alt"])
            seg_t = jnp.asarray(T["seg"])
            is_r_full = self._is_r_label()
            rfl = self.required_finger_len()

            from ..constants import (
                EXTRACT_FAIL_ARCHITECTURE_MISMATCH,
                EXTRACT_FAIL_BAR_FINGER_NOT_FOUND,
                EXTRACT_FAIL_READ_TOO_SHORT,
                EXTRACT_SUCCESS,
            )

            bitw = jnp.asarray(
                [128, 64, 32, 16, 8, 4, 2, 1], dtype=jnp.int32
            )

            def full_decided(seqs_in, lens, thr32, minlen):
                # with TAGDUST_TPU_NIBBLE=1 inputs arrive nibble-packed
                # (2 bases/byte, codes 0-5 fit 4 bits): half the
                # host->device bytes for one unpack on the device
                seqs_u8 = (
                    unpack_nibbles_device(seqs_in, Lp) if nib else seqs_in
                )
                f, r, b, lab, q = full(seqs_u8, lens)
                seqs = seqs_u8.astype(jnp.int32)
                dust = dust_scores_device(
                    seqs, lab.astype(jnp.int32), lens, is_r_full
                )
                B = seqs.shape[0]
                labd = jnp.clip(lab.astype(jnp.int32)[:, 1:], 0, nlab - 1)
                pos = jnp.arange(Lp, dtype=jnp.int32)[None, :]
                valid = pos < lens[:, None]
                keep = jnp.take(is_R, labd)  # [B, Lp] bool (unmasked)
                tR = keep & valid
                tB = jnp.take(is_B, labd) & valid
                tF = jnp.take(is_F, labd) & valid

                # keep bits, big-endian within each byte (np.unpackbits order)
                keep_bytes = jnp.sum(
                    keep.reshape(B, Lp // 8, 8).astype(jnp.int32)
                    * bitw[None, None, :],
                    axis=2,
                ).astype(jnp.uint8)

                passed = q >= thr32  # NaN -> False, like the host compare

                fingerlen = jnp.sum(tF.astype(jnp.int32), axis=1)
                has_b = tB.any(axis=1)
                last_b = jnp.where(
                    has_b, Lp - 1 - jnp.argmax(tB[:, ::-1], axis=1), 0
                )
                lab_last = jnp.take_along_axis(
                    labd, last_b[:, None], axis=1
                )[:, 0]
                bar = jnp.where(has_b, jnp.take(alt_t, lab_last), -1)
                mem = jnp.where(has_b, jnp.take(seg_t, lab_last), -1)
                hb = jnp.where(
                    has_b, jnp.where(jnp.take(null_b, lab_last), -1, 1), 0
                )

                # too-short: every maximal R run must reach minlen
                idxs = jnp.broadcast_to(pos, tR.shape)
                last_nonr = jax.lax.cummax(
                    jnp.where(tR, -1, idxs), axis=1
                )
                runlen = idxs - last_nonr
                nxt = jnp.pad(tR[:, 1:], ((0, 0), (0, 1)))
                run_end = tR & ~nxt
                too_short = jnp.any(run_end & (runlen < minlen), axis=1)

                # fingerprint key: 2-bit packed F bases, two uint32 halves
                if rfl and rfl <= 27:
                    cum = jnp.cumsum(tF.astype(jnp.int32), axis=1)
                    shift = 2 * (fingerlen[:, None] - cum)  # at F positions
                    bits = (seqs[:, :Lp] & 3).astype(jnp.uint32)
                    sh_lo = jnp.clip(shift, 0, 31).astype(jnp.uint32)
                    lo = jnp.sum(
                        jnp.where(tF & (shift < 32), bits << sh_lo, 0),
                        axis=1, dtype=jnp.uint32,
                    )
                    sh_hi = jnp.clip(shift - 32, 0, 31).astype(jnp.uint32)
                    hi = jnp.sum(
                        jnp.where(tF & (shift >= 32), bits << sh_hi, 0),
                        axis=1, dtype=jnp.uint32,
                    )
                else:
                    lo = jnp.zeros((B,), jnp.uint32)
                    hi = jnp.zeros((B,), jnp.uint32)

                finger_ok = fingerlen == rfl
                if rfl:
                    core = jnp.where(
                        hb == 1,
                        finger_ok & (bar != -1),
                        jnp.where(hb == 0, finger_ok, False),
                    )
                else:
                    core = jnp.where(hb == 1, bar != -1, hb == 0)
                success = passed & ~too_short & core
                read_type = jnp.where(
                    passed,
                    jnp.where(
                        too_short,
                        EXTRACT_FAIL_READ_TOO_SHORT,
                        jnp.where(
                            success,
                            EXTRACT_SUCCESS,
                            EXTRACT_FAIL_BAR_FINGER_NOT_FOUND,
                        ),
                    ),
                    EXTRACT_FAIL_ARCHITECTURE_MISMATCH,
                ).astype(jnp.uint8)
                bar_mem = jnp.where(
                    success & (hb == 1), (mem << 16) | bar, -1
                ).astype(jnp.int32)

                u8 = lambda x: jax.lax.bitcast_convert_type(  # noqa: E731
                    x, jnp.uint8
                ).reshape(B, -1)
                return jnp.concatenate(
                    [
                        keep_bytes,
                        read_type[:, None],
                        u8(bar_mem[:, None]),
                        u8(lo[:, None]),
                        u8(hi[:, None]),
                        u8(q[:, None]),
                        u8(dust),
                    ],
                    axis=1,
                )

            self._fns[key] = (jax.jit(full_decided), full_decided)
        return self._fns[key]

    @staticmethod
    def pack_nibbles(seqs: np.ndarray) -> np.ndarray:
        """[B, Lp] codes (0-5) -> [B, Lp/2] nibble-packed uint8."""
        return (seqs[:, 0::2] | (seqs[:, 1::2] << 4)).astype(np.uint8)

    def dispatch_decided(
        self, seqs: np.ndarray, lens: np.ndarray, thr32, minlen: int
    ):
        """Asynchronous dispatch of the decided-mode pipeline (labels never
        leave the device; the host receives decisions + keep bits; the
        upload is nibble-packed)."""
        fn, _ = self._get_decided(seqs.shape[1])
        up = seqs.astype(np.uint8)
        if nibble_uploads():
            up = self.pack_nibbles(up)
        return fn(
            jnp.asarray(up),
            jnp.asarray(lens.astype(np.int32)),
            jnp.float32(thr32),
            jnp.int32(minlen),
        )

    @staticmethod
    def threshold_f32_ceil(thr: float) -> np.float32:
        """Smallest float32 >= thr: makes the device compare
        ``q_f32 >= thr32`` decide exactly like the host's float64
        ``thr <= float64(q_f32)`` for every representable q."""
        t32 = np.float32(thr)
        if float(t32) < float(thr):
            t32 = np.nextafter(t32, np.float32(np.inf), dtype=np.float32)
        return t32

    def collect_decided(self, out, n: int, Lp: int) -> dict:
        """Parse one fetched decided-mode window back to host arrays."""
        a = np.asarray(out)[:n]
        kb = Lp // 8
        keep = np.unpackbits(
            np.ascontiguousarray(a[:, :kb]), axis=1
        ).astype(bool)
        read_type = a[:, kb].astype(np.int64)
        bar_mem = np.ascontiguousarray(a[:, kb + 1 : kb + 5]).view(np.int32)[
            :, 0
        ]
        lo = np.ascontiguousarray(a[:, kb + 5 : kb + 9]).view(np.uint32)[:, 0]
        hi = np.ascontiguousarray(a[:, kb + 9 : kb + 13]).view(np.uint32)[:, 0]
        fp_key = (hi.astype(np.int64) << 32) | lo.astype(np.int64)
        sc = np.ascontiguousarray(a[:, kb + 13 : kb + 25]).view(np.float32)
        return {
            "keep": keep,
            "read_type": read_type,
            "bar_mem": bar_mem,
            "fp_key": fp_key,
            "mapq": sc[:, 0],
            "dust": sc[:, 1:3],
        }

    def _is_r_label(self) -> np.ndarray:
        """[n_labels+2] bool: does label index li label an R-segment base?"""
        cached = getattr(self, "_is_r_cache", None)
        if cached is None:
            n_labels = int(np.asarray(self._dev["Lmap"]).shape[1])
            out = np.zeros(n_labels + 2, dtype=bool)
            lab_tab = np.asarray(self.mb.label, dtype=np.int64)
            types = self.mb.rs.types if self.mb.rs is not None else []
            for li in range(min(n_labels + 2, lab_tab.shape[0])):
                seg = int(lab_tab[li]) & 0xFFFF
                if seg < len(types) and types[seg] == "R":
                    out[li] = True
            cached = self._is_r_cache = out
        return cached

    def collect_packed(self, out, n: int, Lp: int) -> TpuBatchResult:
        """Convert one fetched packed window back to host-side arrays."""
        a = np.asarray(out)[:n]
        lab_bytes = self._lab_bytes()
        lw = lab_bytes * (Lp + 1)
        labs = np.ascontiguousarray(a[:, :lw])
        labels = (
            labs.view(np.int8)
            if lab_bytes == 1
            else labs.view(np.int32).reshape(n, Lp + 1)
        )
        sc = np.ascontiguousarray(a[:, lw : lw + 24]).view(np.float32)
        return TpuBatchResult(
            f_score=sc[:, 0],
            r_score=sc[:, 1],
            bar_prob=sc[:, 2],
            labels=labels,
            mapq=sc[:, 3],
            dust=sc[:, 4:6],
        )

"""Device-side batched Myers bit-parallel edit distance.

The device expression of the reference's bit-parallel intra-read
parallelism (``bmp_single``, ``misc.c:718-765``; inventory SURVEY.md §2.4
item 2): the 64-bit pattern words live as uint32 lane pairs, one lane per
read, and the recurrence scans the *shared* contaminant text — so one
`lax.scan` advances every read's automaton simultaneously.

Semantics match :func:`tagdust_tpu.filters._bpm_batch` exactly (asserted by
tests): patterns capped at 63 symbols, spacer symbols skip the match masks
but occupy bit positions, best (substring) distance over all text positions.
"""

from __future__ import annotations

import functools

import numpy as np

from ..jax_env import jax
import jax.numpy as jnp

_U32 = jnp.uint32
_ONE = np.uint32(1)


def _add64(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = (lo < alo).astype(_U32)
    hi = ahi + bhi + carry
    return lo, hi


def _shl1(lo, hi):
    return lo << _ONE, (hi << _ONE) | (lo >> np.uint32(31))


@functools.partial(jax.jit, static_argnames=("text_len",))
def _scan_text(text, active, B4lo, B4hi, m, text_len):
    """text [T] int32 (padded), active [T] bool, B4* [B, 4] uint32,
    m [B] int32 (1..63).  Returns best distance k [B] int32."""
    B = m.shape[0]
    m64 = jnp.maximum(m.astype(jnp.int32), 1)
    # shift amounts clamped to < 32 before the where-select (XLA evaluates
    # both branches; uint32 shifts >= 32 are undefined)
    in_lo = m64 <= 32
    sh_lo = jnp.clip(m64 - 1, 0, 31).astype(_U32)
    sh_hi = jnp.clip(m64 - 33, 0, 31).astype(_U32)
    mask_lo = jnp.where(in_lo, _ONE << sh_lo, np.uint32(0))
    mask_hi = jnp.where(in_lo, np.uint32(0), _ONE << sh_hi)
    # VP = (1 << m) - 1
    shv_lo = jnp.clip(m64, 0, 31).astype(_U32)
    shv_hi = jnp.clip(m64 - 32, 0, 31).astype(_U32)
    vp_lo = jnp.where(
        m64 >= 32, np.uint32(0xFFFFFFFF), (_ONE << shv_lo) - _ONE
    )
    vp_hi = jnp.where(m64 <= 32, np.uint32(0), (_ONE << shv_hi) - _ONE)
    zeros = jnp.zeros((B,), _U32)

    def step(carry, x):
        vplo, vphi, vnlo, vnhi, diff, k = carry
        sym, act = x
        blo = B4lo[:, sym]
        bhi = B4hi[:, sym]
        xlo = blo | vnlo
        xhi = bhi | vnhi
        slo, shi = _add64(vplo, vphi, xlo & vplo, xhi & vphi)
        d0lo = (slo ^ vplo) | xlo
        d0hi = (shi ^ vphi) | xhi
        hnlo = vplo & d0lo
        hnhi = vphi & d0hi
        hplo = vnlo | ~(vplo | d0lo)
        hphi = vnhi | ~(vphi | d0hi)
        x2lo, x2hi = _shl1(hplo, hphi)
        nvnlo = x2lo & d0lo
        nvnhi = x2hi & d0hi
        h2lo, h2hi = _shl1(hnlo, hnhi)
        nvplo = h2lo | ~(x2lo | d0lo)
        nvphi = h2hi | ~(x2hi | d0hi)
        hit_p = ((hplo & mask_lo) | (hphi & mask_hi)) != 0
        hit_n = ((hnlo & mask_lo) | (hnhi & mask_hi)) != 0
        ndiff = diff + hit_p.astype(jnp.int32) - hit_n.astype(jnp.int32)
        nk = jnp.minimum(k, ndiff)
        out = (
            jnp.where(act, nvplo, vplo),
            jnp.where(act, nvphi, vphi),
            jnp.where(act, nvnlo, vnlo),
            jnp.where(act, nvnhi, vnhi),
            jnp.where(act, ndiff, diff),
            jnp.where(act, nk, k),
        )
        return out, None

    init = (vp_lo, vp_hi, zeros, zeros, m64, m64)
    (_, _, _, _, _, k), _ = jax.lax.scan(step, init, (text, active))
    return k


def bpm_batch_device(text: np.ndarray, B4: np.ndarray, m: np.ndarray):
    """Device analogue of filters._bpm_batch: one uint32-pair lane per read.

    ``text`` [n] uint8 contaminant, ``B4`` [B, 4] uint64 host-built pattern
    masks, ``m`` [B] capped pattern lengths (>=1).
    """
    n = text.shape[0]
    Tpad = ((n + 63) // 64) * 64
    text_p = np.zeros(Tpad, dtype=np.int32)
    text_p[:n] = text.astype(np.int32) & 0x3
    active = np.zeros(Tpad, dtype=bool)
    active[:n] = True
    B4lo = (B4 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    B4hi = (B4 >> np.uint64(32)).astype(np.uint32)
    k = _scan_text(
        jnp.asarray(text_p),
        jnp.asarray(active),
        jnp.asarray(B4lo),
        jnp.asarray(B4hi),
        jnp.asarray(m.astype(np.int32)),
        Tpad,
    )
    return np.asarray(k)

"""Float32 log-space arithmetic bit-compatible with the reference C build.

The reference performs every dynamic-programming accumulation in float32
log space using a 16,000-entry lookup table rounded to 0.001 nat
(``misc.c:57-78``, ``misc.h:45-53``):

    logsum(a, b) = max                       if min == -inf or max-min >= 15.7
                 = max + T[(int)((max-min)*1000.0f)]  otherwise
    T[i] = (float) log(1 + exp(-i / 1000.0))

``prob2scaledprob``/``scaledprob2prob`` (``misc.c:85-105``) convert through
float32: p2sp(x) = float32(log(float64(float32(x)))) with 0 -> -inf, and
sp2p(x) = float32(exp(float64(x))) with -inf -> 0.

All helpers here operate on numpy float32 arrays and reproduce the exact
rounding behaviour (truncation toward zero of the table index, float32
addition order is the caller's responsibility).  This module is the numerics
substrate for the deterministic "exact" engine; the device engine
uses true log-sum-exp instead.
"""

import math

import numpy as np

LOGSUM_SIZE = 16000
SCALE = np.float32(1000.0)
NEG_INF = np.float32(-np.inf)

# Table computed like init_logsum (misc.c:57-63): double math through libm
# (math.exp/math.log, NOT numpy's vectorised kernels, and log(1+x) rather
# than log1p — the reference uses plain log()), float storage.
LOGSUM_TABLE = np.array(
    [math.log(1.0 + math.exp(-i / 1000.0)) for i in range(LOGSUM_SIZE)],
    dtype=np.float32,
)

_F32 = np.float32
_F64 = np.float64


def p2sp(x) -> np.float32:
    """prob2scaledprob for scalars: float32(log(float64(float32(x))))."""
    xf = _F32(x)
    if xf == 0.0:
        return NEG_INF
    return _F32(math.log(float(xf)))


def p2sp_arr(x) -> np.ndarray:
    """Vectorised prob2scaledprob (libm log per element)."""
    xf = np.asarray(x, dtype=np.float32)
    flat = xf.ravel()
    out = np.empty(flat.shape, dtype=np.float32)
    for i, v in enumerate(flat):
        out[i] = NEG_INF if v == 0.0 else _F32(math.log(float(v)))
    return out.reshape(xf.shape)


def sp2p(x) -> np.float32:
    """scaledprob2prob for scalars: float32(exp(float64(x)))."""
    xf = _F32(x)
    if np.isneginf(xf):
        return _F32(0.0)
    return _F32(math.exp(float(xf)))


def sp2p_arr(x) -> np.ndarray:
    """Vectorised scaledprob2prob via libm exp (bit-exact vs C)."""
    xf = np.asarray(x, dtype=np.float32)
    flat = xf.ravel()
    out = np.empty(flat.shape, dtype=np.float32)
    for i, v in enumerate(flat):
        out[i] = _F32(0.0) if np.isneginf(v) else _F32(math.exp(float(v)))
    return out.reshape(xf.shape)


def logsum(a, b):
    """Exact-table logsum on float32 scalars or same-shape arrays.

    Mirrors misc.c:72-78 including index truncation.  Shapes broadcast.
    """
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    mx = np.maximum(a, b)
    mn = np.minimum(a, b)
    with np.errstate(invalid="ignore", over="ignore"):
        d = (mx - mn).astype(np.float32)
        shortcut = np.isneginf(mn) | (d >= np.float32(15.7))
        idx = (d * SCALE).astype(np.float32)
        # C (int) cast truncates toward zero; values are >= 0 here.
        ii = np.where(shortcut, 0, np.nan_to_num(idx, nan=0.0, posinf=0.0))
        ii = ii.astype(np.int32)
        ii = np.clip(ii, 0, LOGSUM_SIZE - 1)
        res = (mx + LOGSUM_TABLE[ii]).astype(np.float32)
    out = np.where(shortcut, mx, res).astype(np.float32)
    if out.ndim == 0:
        return np.float32(out)
    return out

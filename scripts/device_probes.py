#!/usr/bin/env python
"""Device probes behind the precision choice and the streaming window design.

On the flagship architecture (20 barcodes of 6nt + read segment, S=255) at
B=16384 random reads of padded length 64:

* ``precision``: the one-shot scorer (DP core + Q) with its DP matmuls at
  HIGHEST (float32), DEFAULT (TF32 on the GPU) and bf16 inputs with float32
  accumulation, timed in turns (HIGHEST, DEFAULT, BF16, BF16, DEFAULT,
  HIGHEST); labels and Q of DEFAULT and BF16 compared with HIGHEST.
* ``shape``: the decided-rows program on the same reads at 4096, 8192 and
  16384 rows (does a read's row depend on the batch shape?), and at 16384
  rows rolled by 4096 (on its row position within one shape?).

Needs a GPU: exits non-zero on any other backend.
Usage:  python scripts/device_probes.py [precision] [shape]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, LP = 16384, 64


def _inputs():
    import numpy as np

    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 4, (B, LP)).astype(np.uint8)
    lens = np.full(B, 56, dtype=np.int32)
    return seqs, lens


def precision(jax):
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _flagship_engine
    from tagdust_tpu.engine import tpu

    seqs, lens = _inputs()
    seqs_d, lens_d = jnp.asarray(seqs), jnp.asarray(lens)
    P = jax.lax.Precision

    def bf16_mm(a, b):
        return jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    fns, outs = {}, {}
    saved = tpu._mm
    for name, prec, mm in (("HIGHEST", P.HIGHEST, None),
                           ("DEFAULT", P.DEFAULT, None),
                           ("BF16", P.DEFAULT, bf16_mm)):
        tpu.DP_PRECISION = prec
        tpu._mm = mm or saved
        eng = _flagship_engine()  # traced now, with this precision
        fn, _ = eng._get_scorer(LP)
        t0 = time.perf_counter()
        outs[name] = jax.block_until_ready(fn(seqs_d, lens_d))
        print(f"precision {name}: compile + first run "
              f"{time.perf_counter() - t0:.2f} s")
        fns[name] = fn
    tpu._mm, tpu.DP_PRECISION = saved, P.DEFAULT

    NB = 8
    for name in ("HIGHEST", "DEFAULT", "BF16", "BF16", "DEFAULT", "HIGHEST"):
        fn = fns[name]
        jax.block_until_ready(fn(seqs_d, lens_d))
        t0 = time.perf_counter()
        jax.block_until_ready([fn(seqs_d, lens_d) for _ in range(NB)])
        print(f"precision {name}: {NB * B / (time.perf_counter() - t0):.0f} "
              f"reads/s")
    ref_lab, ref_q = np.asarray(outs["HIGHEST"][3]), np.asarray(outs["HIGHEST"][4])
    for name in ("DEFAULT", "BF16"):
        lab, q = np.asarray(outs[name][3]), np.asarray(outs[name][4])
        same = (lab == ref_lab).all(axis=1).mean()
        dq = np.nanmax(np.abs(q - ref_q))
        print(f"precision {name} vs HIGHEST: labels same on {100 * same:.3f}% "
              f"of reads, max|dQ| {dq:.3f}")


def shape(jax):
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _flagship_engine

    eng = _flagship_engine()
    seqs, lens = _inputs()
    fn, _ = eng._get_decided(LP)
    thr = jnp.float32(eng.threshold_f32_ceil(10.0))
    minlen = jnp.int32(10)

    def rows(sq, ln):
        sp = jnp.asarray(eng.pack_nibbles(sq))
        return np.asarray(fn(sp, jnp.asarray(ln), thr, minlen))

    full = rows(seqs, lens)
    for n in (4096, 8192):
        same = (rows(seqs[:n], lens[:n]) == full[:n]).all(axis=1).sum()
        print(f"shape {n} rows vs 16384 rows: identical bytes on {same}/{n} "
              f"reads")
    rolled = np.roll(rows(np.roll(seqs, 4096, 0), np.roll(lens, 4096)),
                     -4096, 0)
    same = (rolled == full).all(axis=1).sum()
    print(f"shape 16384 rows rolled by 4096 vs unrolled: identical bytes on "
          f"{same}/{B} reads")


def main():
    from tagdust_tpu.jax_env import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"device_probes: needs a GPU, JAX found {dev.platform}")
    which = sys.argv[1:] or ["precision", "shape"]
    for name in which:
        {"precision": precision, "shape": shape}[name](jax)


if __name__ == "__main__":
    main()

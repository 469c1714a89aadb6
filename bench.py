#!/usr/bin/env python
"""Benchmark: device DP pipeline throughput (reads/s on one device).

Times the decided-mode pipeline the CLI streams (`TpuEngine.dispatch_decided`:
DP core, Q, device DUST, extraction decisions, packed rows) on the flagship
architecture (20 barcodes of 6nt + read segment, S=255 lattice states) at
B=16384 reads of padded length 64, inputs staged on the device once.
Needs a GPU: exits non-zero on any other backend.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "reads/s", "device": {...}, ...}
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import numpy as np

    from tagdust_tpu.jax_env import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {dev.platform}")

    import jax.numpy as jnp

    from __graft_entry__ import _flagship_engine

    eng = _flagship_engine()
    rng = np.random.default_rng(0)
    B, L = 16384, 64
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, 56, dtype=np.int32)
    fn, _ = eng._get_decided(L)
    seqs_d = jnp.asarray(eng.pack_nibbles(seqs))
    lens_d = jnp.asarray(lens)
    thr = jnp.float32(eng.threshold_f32_ceil(10.0))
    minlen = jnp.int32(10)

    def run():
        return fn(seqs_d, lens_d, thr, minlen)

    t0 = time.perf_counter()
    jax.block_until_ready(run())  # compile
    compile_s = time.perf_counter() - t0
    # sustained throughput: a pipeline of batches, blocked once at the end
    NB = 8
    jax.block_until_ready([run() for _ in range(2)])
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready([run() for _ in range(NB)])
        times.append(time.perf_counter() - t0)
    rates = sorted(NB * B / t for t in times)
    rps = rates[len(rates) // 2]
    print(
        json.dumps(
            {
                "metric": "reads/s, device DP pipeline (decided rows, "
                          "20x6nt barcodes, B=16384, Lp=64)",
                "value": rps,
                "unit": "reads/s",
                "trial_rates": rates,
                "compile_seconds": compile_s,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()

"""Scaling-efficiency bench: sharded scoring reads/s vs device count.

Measures `parallel.mesh.ShardedScorer` (the production multi-device path,
wired into `engine.runner._score_reads_tpu`) on the flagship 20-barcode
architecture at 1/2/4/8 devices and reports parallel efficiency relative
to 1 device.  Needs at least two devices and exits non-zero otherwise.

``--force-cpu`` runs on a virtual 8-device CPU mesh instead: virtual
devices share the host's cores, so those numbers measure the sharding
machinery's overhead, not device scaling (stated in the output).
Usage:  python bench_multichip.py [--batch 16384] [--len 48] [--force-cpu]
"""

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--len", dest="length", type=int, default=48)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--force-cpu", action="store_true")
    args = ap.parse_args()

    if args.force_cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tagdust_tpu.jax_env import jax

    devices = jax.devices()
    if len(devices) < 2:
        sys.exit(
            f"bench_multichip: needs >= 2 devices, JAX found {len(devices)} "
            f"{devices[0].platform} device(s)"
        )

    import numpy as np

    import __graft_entry__ as g
    from tagdust_tpu.parallel.mesh import ShardedScorer, make_mesh

    platform = devices[0].platform
    eng = g._flagship_engine()
    rng = np.random.default_rng(0)
    B, L = args.batch, args.length
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L - 4, dtype=np.int32)

    results = {}
    counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    for n in counts:
        scorer = ShardedScorer(eng, make_mesh(devices[:n]))
        out = scorer.run(seqs, lens)  # warmup/compile
        jax.block_until_ready(out[:5])
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = scorer.run(seqs, lens)
            jax.block_until_ready(out[:5])
        dt = (time.perf_counter() - t0) / args.reps
        rps = B / dt
        results[n] = rps
        print(
            json.dumps(
                {
                    "devices": n,
                    "platform": platform,
                    "device_kind": devices[0].device_kind,
                    "reads_per_s": rps,
                    "scaling_efficiency": rps / (results[1] * n),
                    "note": (
                        "virtual host devices share CPU cores"
                        if platform == "cpu"
                        else "real devices"
                    ),
                }
            )
        )


if __name__ == "__main__":
    main()

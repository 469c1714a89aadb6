"""End-to-end CLI throughput bench: reads/s through the full production
pipeline (read -> score -> extract -> filter -> write), not just the device
kernel.

Generates (and caches) a simreads input, then times
`hmm_controller_multiple` exactly as the CLI drives it.  Default: a fixed
-Q threshold (calibration is a one-time cost amortised over a whole run).
With --calibration the run uses DEFAULT flags instead — no -Q, so every
trial pays the reference's 400k-simulated-read threshold calibration
(calibrateQ.c:47) — and the calibration stage is timed separately inside
each trial.  Prints one JSON line per configuration with every trial's
wall time.

The first pass in a process pays one-time costs that say nothing about
sustained throughput and are excluded by the warmup run: jit compile or
persistent-cache load of the device programs, and first-touch page faults
of the working set (see tagdust_tpu._tune_malloc).
Measured trials run back-to-back in the same process, each a complete CLI
run (fresh controller, fresh output files): the steady state a production
service or a >=10M-read run sits in.

Usage:
  python bench_e2e.py [--reads 1000000] [--engine tpu|exact|both]
                      [--trials 3] [--readlen 50]
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def make_input(n_reads: int, readlen: int, barnum: int) -> str:
    """simreads input (cached in the temp dir) over the in-repo barcode set
    (tagdust_tpu.edittag: 6nt, pairwise edit distance >= 3)."""
    from tagdust_tpu.edittag import greedy_barcodes, write_edittag

    key = hashlib.md5(f"{n_reads}:{readlen}:{barnum}".encode()).hexdigest()[:10]
    base = os.path.join(tempfile.gettempdir(), f"tagdust_e2e_{key}")
    fq = base + ".fq"
    arch = fq + "_tagdust_arch.txt"
    if not (os.path.exists(fq) and os.path.exists(arch)):
        tags = base + "_tags.txt"
        write_edittag(tags, greedy_barcodes(barnum))
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        subprocess.run(
            [sys.executable, "-m", "tagdust_tpu.cli.simreads", tags,
             "-seed", "42", "-sim_barnum", str(barnum),
             "-sim_readlen", str(readlen), "-sim_readlen_mod", "0",
             "-sim_numseq", str(n_reads), "-sim_endloss", "0",
             "-sim_random_frac", "0.1", "-o", fq],
            check=True, env=env, cwd=tempfile.gettempdir(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
    return fq


def run_once(
    fq: str, engine: str, outdir: str, calibration: bool = False,
    q: float = 10.0,
) -> dict:
    import tagdust_tpu.controller as ctl
    from tagdust_tpu.config import parse_args
    from tagdust_tpu.controller import MessageLog, hmm_controller_multiple
    from tagdust_tpu.io.fastq import SeqReader
    from tagdust_tpu.io.writer import DemuxWriter

    out = os.path.join(outdir, f"bench_{engine}")
    args = [fq, "-arch", fq + "_tagdust_arch.txt", "-o", out]
    if calibration:
        # default flags: no -Q -> the 400k-sim threshold calibration runs
        # (calibrateQ.c:47); -seed pins the sim stream so trials compare
        args += ["-seed", "42"]
    else:
        args += ["-Q", str(q)]
    if engine != "auto":
        args += ["-engine", engine]
    param = parse_args(args)
    log = MessageLog()
    # per-stage cumulative times.  The pipeline is
    # threaded — reader and writer run concurrently with the main-thread
    # label/extract stage — so these are CPU-occupancy numbers per stage,
    # not additive wall-time slices; "seconds" is the end-to-end wall time.
    stages = {
        "stats_prepass": 0.0,
        "calibration": 0.0,
        "label_extract": 0.0,
        "parse": 0.0,
        "write": 0.0,
    }

    def timed(key, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            stages[key] += time.perf_counter() - t0
            return r

        return wrap

    patches = []

    def patch(obj, name, key):
        orig = getattr(obj, name)
        patches.append((obj, name, orig))
        setattr(obj, name, timed(key, orig))

    patch(ctl, "estimate_q_threshold", "calibration")
    patch(ctl, "get_sequence_stats", "stats_prepass")
    patch(ctl, "run_get_label_batch", "label_extract")
    patch(SeqReader, "read_chunk_batch", "parse")
    patch(DemuxWriter, "write_batch_columnar", "write")
    devnull = open(os.devnull, "w")
    old_err, sys.stderr = sys.stderr, devnull  # silence the run log
    try:
        t0 = time.perf_counter()
        hmm_controller_multiple(param, log=log)
        dt = time.perf_counter() - t0
    finally:
        sys.stderr = old_err
        devnull.close()
        for obj, name, orig in patches:
            setattr(obj, name, orig)
    total = 0
    for m in log.messages:
        # "[stamp]\t<N>\ttotal input reads\n"
        if "total input reads" in m:
            total = int(m.split("]", 1)[1].strip().split("\t")[0])
    return {
        "seconds": dt,
        "reads": total,
        "calibration_seconds": stages["calibration"],
        "stage_seconds": {k: round(v, 2) for k, v in stages.items()},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1000000)
    ap.add_argument("--readlen", type=int, default=50)
    ap.add_argument("--barnum", type=int, default=8)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument(
        "--engine", default="tpu", choices=["tpu", "exact", "auto", "both"]
    )
    ap.add_argument(
        "--q", type=float, default=10.0,
        help="pinned -Q threshold for non-calibration runs",
    )
    ap.add_argument(
        "--calibration", action="store_true",
        help="default-flag runs: no -Q, each trial pays the 400k-sim "
             "threshold calibration (timed separately)",
    )
    args = ap.parse_args()

    fq = make_input(args.reads, args.readlen, args.barnum)
    engines = ["tpu", "exact"] if args.engine == "both" else [args.engine]
    for engine in engines:
        trials = []
        warmup = None
        for t in range(args.trials + 1):
            with tempfile.TemporaryDirectory() as outdir:
                r = run_once(
                    fq, engine, outdir, calibration=args.calibration,
                    q=args.q,
                )
            if t == 0:
                warmup = round(r["seconds"], 2)
                continue
            trials.append(r)
        secs = [r["seconds"] for r in trials]
        reads = trials[0]["reads"]
        best = reads / min(secs)
        med = reads / statistics.median(secs)
        flags = (
            "default flags incl. calibration"
            if args.calibration
            else f"-Q {args.q:g}"
        )
        rec = {
            "metric": f"e2e CLI reads/s ({engine} engine, {flags}, "
                      f"{args.barnum}x6nt barcodes, {args.readlen}nt reads)",
            "value": round(med, 1),
            "unit": "reads/s",
            "best": round(best, 1),
            "reads": reads,
            "trial_seconds": [round(s, 2) for s in secs],
            "warmup_seconds_excluded": warmup,
        }
        if args.calibration:
            rec["calibration_seconds"] = [
                round(r["calibration_seconds"], 2) for r in trials
            ]
        med_s = statistics.median(secs)
        rec["stage_seconds"] = min(
            trials, key=lambda r: abs(r["seconds"] - med_s)
        )["stage_seconds"]
        print(json.dumps(rec))
        sys.stdout.flush()


if __name__ == "__main__":
    main()

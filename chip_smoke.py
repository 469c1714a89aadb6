#!/usr/bin/env python
"""Smoke run of the device path on an NVIDIA GPU.

One process, one card: the CLI (`tagdust_tpu.cli.tagdust.main`, in-process,
``-engine tpu``) over a 1M-read simulated run with 20 barcodes, checked
against the bit-exact C-parity engine.  Phases:

  (a) device check: JAX's first device must be a GPU; prints its kind, the
      device count, and ``nvidia-smi``'s name and power limit;
  (b) input: a 20-barcode 6nt set at pairwise edit distance >= 3
      (`tagdust_tpu.edittag`, fixed seed), 1M reads from `simreads`
      (child process, no JAX), and a two-candidate arch file;
  (c) the CLI on the 1M reads with ``-Q 10``, with default flags (the
      400k-read threshold calibration scores on the device), and with
      architecture detection over the two candidates; prints reads/s,
      compile seconds and peak device memory for each run; then XLA's
      count of bytes per read, the streaming window it yields, and the
      peak device memory against the engine's stated memory share;
  (d) the plain reference: ``-engine exact`` on the first 200k reads,
      compared read by read with a device run on the same reads, both with
      default flags (each engine calibrates its threshold): same output
      file and extracted sequence except reads whose exact-engine Q lies
      within max|dQ| of the threshold (plus the gap between the two
      calibrated thresholds), and max|dQ| <= 0.15.  Then both with
      ``-Q 10``: at most 20 reads decided differently away from the
      threshold, and how many of those the float32 core on the CPU (a child
      process with JAX_PLATFORMS=cpu) moves too.

``--cards 4`` runs only the multi-device phase: the CLI on the 1M reads
sharded over all four cards (the default mesh path), then with
TAGDUST_TPU_MESH=0 on one card in the same process, with ``-Q 10`` and
with default flags; the output files must be byte-identical.

Any failed phase exits non-zero before the last line.  The last line of
stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
Usage:  python chip_smoke.py [--cards 4]
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_READS = 1_000_000
N_HEAD = 200_000
FIRST_CHUNK = 131_072  # the CLI's first chunk (controller.py)
MAX_DQ = 0.15
# -Q 10: reads of the N_HEAD that may be decided differently away from the
# threshold (0.01%); a bound that catches a precision regression, not the
# single near ties float32 itself moves.
Q10_AWAY_MAX = 20


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def device_check(jax, want_count):
    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu", f"JAX's first device is {d.platform}, not gpu")
    check(
        len(devs) >= want_count,
        f"{len(devs)} devices visible, the phase needs {want_count}",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {d.device_kind} x{len(devs)}")
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}")
    return d


def make_input(tmp):
    from tagdust_tpu.edittag import greedy_barcodes, write_edittag

    bcs = greedy_barcodes(24)
    tags = os.path.join(tmp, "tags.txt")
    write_edittag(tags, bcs[:20])
    fq = os.path.join(tmp, "reads.fq")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "tagdust_tpu.cli.simreads", tags,
         "-seed", "42", "-sim_barnum", "20", "-sim_readlen", "50",
         "-sim_readlen_mod", "0", "-sim_numseq", str(N_READS),
         "-sim_endloss", "0", "-sim_random_frac", "0.1",
         "-sim_error_rate", "0.02", "-o", fq],
        cwd=tmp, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    check(res.returncode == 0, f"simreads failed: {res.stderr[-2000:]}")
    print(f"input: {N_READS} reads simulated in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    arch = fq + "_tagdust_arch.txt"
    # second candidate: 4 barcodes the reads do not carry
    arch2 = os.path.join(tmp, "two_arch.txt")
    with open(arch) as fh, open(arch2, "w") as out:
        out.write(fh.read().strip() + "\n")
        out.write(f"tagdust -1 B:{','.join(bcs[20:])} -2 R:N in.fq -o out.fq\n")
    head = os.path.join(tmp, "head.fq")
    with open(fq) as fh, open(head, "w") as out:
        for i, line in enumerate(fh):
            if i >= 4 * N_HEAD:
                break
            out.write(line)
    return fq, arch, arch2, head


class CompileClock:
    """Sums JAX's backend-compile durations (jax.monitoring events)."""

    def __init__(self, jax):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.total += duration


def run_cli(jax, clock, tmp, label, args, env=None):
    """tagdust main() in-process in ``tmp``; returns the log's read count."""
    from tagdust_tpu.cli.tagdust import main

    old_env = dict(os.environ)
    os.environ.update(env or {})
    old_cwd = os.getcwd()
    os.chdir(tmp)
    c0 = clock.total
    t0 = time.perf_counter()
    try:
        main(args + ["-o", label])
    except SystemExit as e:
        raise PhaseError(f"{label}: tagdust exited with {e.code!r}") from e
    finally:
        os.chdir(old_cwd)
        os.environ.clear()
        os.environ.update(old_env)
    dt = time.perf_counter() - t0
    with open(os.path.join(tmp, f"{label}_logfile.txt")) as fh:
        log = fh.read()
    m = re.search(r"\t(\d+)\ttotal input reads", log)
    check(m is not None, f"{label}: no read count in the logfile")
    n = int(m.group(1))
    stats = jax.devices()[0].memory_stats() or {}
    print(
        f"{label}: {n} reads in {dt:.2f} s = {n / dt:.0f} reads/s; "
        f"compile {clock.total - c0:.2f} s; "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}"
    )
    return n, log


_RQ = re.compile(r";RQ:([^;\s]+)$")


def read_outputs(tmp, label):
    """{read name: (output file, sequence, Q)} over all of a run's files."""
    out = {}
    for f in sorted(os.listdir(tmp)):
        if not (f.startswith(label + "_") and f.endswith(".fq")):
            continue
        with open(os.path.join(tmp, f)) as fh:
            lines = fh.read().splitlines()
        for i in range(0, len(lines) - 3, 4):
            m = _RQ.search(lines[i])
            check(m is not None, f"{f}: header without RQ: {lines[i]}")
            name = lines[i][: m.start()]
            out[name] = (f[len(label):], lines[i + 1], float(m.group(1)))
    return out


def threshold(log):
    """The per-file confidence threshold a run used (its logfile)."""
    m = re.search(r"\n\[[^]]*\]\t(\S+)\tselected threshold", log)
    check(m is not None, "no selected threshold in the logfile")
    return float(m.group(1))


def compare_runs(tmp, ex_label, dv_label, thr_ex, thr_dv):
    """Read-by-read comparison of a device run with the exact run; checks
    max|dQ| <= MAX_DQ.  Returns (exact outputs, the reads decided
    differently — other output file or extracted sequence — whose
    exact-engine Q lies farther than max|dQ| from the threshold, the band
    widened by the gap between the two engines' calibrated thresholds)."""
    import math

    ex = read_outputs(tmp, ex_label)
    dv = read_outputs(tmp, dv_label)
    check(len(ex) == N_HEAD, f"exact run wrote {len(ex)} of {N_HEAD} reads")
    check(set(ex) == set(dv), "the two runs wrote different read sets")
    max_dq = max(abs(ex[n][2] - dv[n][2]) for n in ex
                 if math.isfinite(ex[n][2]) and math.isfinite(dv[n][2]))
    band = max_dq + abs(thr_ex - thr_dv)
    moved = [n for n in ex if ex[n][:2] != dv[n][:2]]
    away = [n for n in moved if abs(ex[n][2] - thr_ex) > band]
    print(f"reference {dv_label}: {len(ex)} reads, thresholds exact {thr_ex} "
          f"device {thr_dv}, max|dQ| {max_dq:.2f} (Q printed to 2 "
          f"decimals), {len(moved)} reads decided differently, "
          f"{len(away)} of them farther than {band:.2f} from the threshold")
    check(max_dq <= MAX_DQ, f"max|dQ| {max_dq} > {MAX_DQ}")
    return ex, away


def cpu_witness(tmp, head, arch, names, ex):
    """The device engine in a child process on the CPU (float32 matmuls,
    no TF32) with ``-Q 10`` over just the reads ``names``: prints how many
    of them plain float32 decides differently from the exact engine too,
    and how many only the card's TF32 matmuls move."""
    want = set(names)
    with open(head) as fh, open(os.path.join(tmp, "witness.fq"), "w") as out:
        rec = []
        for line in fh:
            rec.append(line)
            if len(rec) == 4:
                if rec[0].rstrip("\n") in want:
                    out.writelines(rec)
                rec = []
    res = subprocess.run(
        [sys.executable, "-m", "tagdust_tpu.cli.tagdust", "witness.fq",
         "-arch", arch, "-engine", "tpu", "-Q", "10", "-o", "cpuq10"],
        cwd=tmp, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
    )
    check(res.returncode == 0, f"CPU witness failed: {res.stderr[-2000:]}")
    cpu = read_outputs(tmp, "cpuq10")
    check(set(cpu) == want, "the CPU witness wrote other reads")
    only = [n for n in names if cpu[n][:2] == ex[n][:2]]
    print(f"witness: float32 on the CPU decides {len(names) - len(only)} of "
          f"those {len(names)} reads differently from the exact engine too; "
          f"{len(only)} move on the card only, e.g. {only[:2]}")


def reference_phase(jax, clock, tmp, head, arch):
    """The plain reference on the first N_HEAD reads.  With default flags
    (each engine calibrates its own threshold, as a user's run does) every
    read must be decided alike except near the threshold.  With ``-Q 10``
    (threshold 0, the reference's quirk) every read's label path decides
    its file, and label-DP near ties move even in plain float32
    (tests/test_device_core.py::test_float32_core_moves_a_near_tie_under_q10):
    at most Q10_AWAY_MAX reads may be decided differently away from the
    threshold, and `cpu_witness` prints how many of them TF32 alone moves."""
    args = [head, "-arch", arch, "-seed", "42"]
    _, log_ex = run_cli(jax, clock, tmp, "ex200k", args + ["-engine", "exact"])
    _, log_dv = run_cli(jax, clock, tmp, "dv200k", args + ["-engine", "tpu"])
    _, away = compare_runs(tmp, "ex200k", "dv200k", threshold(log_ex),
                           threshold(log_dv))
    check(not away, f"{len(away)} reads decided differently away from the "
          f"threshold, e.g. {away[:3]}")
    args = [head, "-arch", arch, "-Q", "10"]
    _, log_ex = run_cli(jax, clock, tmp, "exq10", args + ["-engine", "exact"])
    _, log_dv = run_cli(jax, clock, tmp, "dvq10", args + ["-engine", "tpu"])
    ex, away = compare_runs(tmp, "exq10", "dvq10", threshold(log_ex),
                            threshold(log_dv))
    if away:
        cpu_witness(tmp, head, arch, away, ex)
    check(len(away) <= Q10_AWAY_MAX,
          f"-Q 10: {len(away)} reads decided differently away from the "
          f"threshold, more than {Q10_AWAY_MAX}")


def memory_check(jax, chunk):
    """XLA's count of the streaming program's bytes per read on this card,
    the window it yields for a ``chunk``-read chunk, and the peak device
    memory so far against the stated share (TpuEngine.MEMORY_FRACTION) of
    the device's limit."""
    from tagdust_tpu.engine import runner
    from tagdust_tpu.engine.tpu import TpuEngine

    stats = jax.devices()[0].memory_stats() or {}
    limit, peak = stats.get("bytes_limit"), stats.get("peak_bytes_in_use")
    check(limit and peak, f"no memory stats: {stats}")
    engs = [e for e in runner._ENGINE_CACHE.values()
            if isinstance(e, TpuEngine)]
    check(engs, "no device engine was built")
    for eng in engs:
        per = eng.bytes_per_read("decided", 64)
        cap = eng.max_batch(64, "decided", depth=3)
        print(f"memory: {per:.0f} B per read (decided rows, Lp=64, XLA's "
              f"count) -> at most {cap} reads per window; a {chunk}-read "
              f"chunk streams in windows of {eng.block_rows(chunk, cap)}")
    frac = TpuEngine.MEMORY_FRACTION
    print(f"memory: peak {peak} B = {peak / limit:.3f} of bytes_limit "
          f"{limit} (budget {frac})")
    check(peak <= frac * limit, f"peak {peak} B above {frac} of {limit} B")


def one_card(jax, clock, tmp):
    fq, arch, arch2, head = make_input(tmp)
    n, _ = run_cli(jax, clock, tmp, "q10",
                   [fq, "-arch", arch, "-engine", "tpu", "-Q", "10"])
    check(n == N_READS, f"q10: {n} reads")
    n, log = run_cli(jax, clock, tmp, "dflt",
                     [fq, "-arch", arch, "-engine", "tpu", "-seed", "42"])
    check(n == N_READS, f"dflt: {n} reads")
    check("Selected Threshold::" in log, "dflt: no calibrated threshold")
    n, log = run_cli(jax, clock, tmp, "det",
                     [fq, "-arch", arch2, "-engine", "tpu", "-Q", "10"])
    check(n == N_READS, f"det: {n} reads")
    check("Confidence" in log, "det: no architecture detection")
    check(f"B:{open(arch).read().split('B:')[1].split()[0]}" in log,
          "det: detection did not pick the simulated architecture")
    memory_check(jax, N_READS - FIRST_CHUNK)
    reference_phase(jax, clock, tmp, head, arch)


def four_cards(jax, clock, tmp):
    """The CLI on the 1M reads over four cards (the default mesh path) and
    with TAGDUST_TPU_MESH=0 on one card, with -Q 10 and with default flags
    (threshold calibration on the mesh): byte-identical output files."""
    fq, arch, _, _ = make_input(tmp)
    from tagdust_tpu.engine import runner

    def files(label):
        return {
            f[len(label):]: open(os.path.join(tmp, f), "rb").read()
            for f in sorted(os.listdir(tmp))
            if f.startswith(label + "_") and f.endswith(".fq")
        }

    for flags in (["-Q", "10"], ["-seed", "42"]):
        tag = "q10" if "-Q" in flags else "dflt"
        args = [fq, "-arch", arch, "-engine", "tpu"] + flags
        run_cli(jax, clock, tmp, f"mesh{tag}", args)
        meshes = [getattr(e, "_mesh_scorer", None)
                  for e in runner._ENGINE_CACHE.values()]
        check(any(m is not None and m.n == 4 for m in meshes),
              "the mesh run did not shard over 4 devices")
        run_cli(jax, clock, tmp, f"one{tag}", args,
                env={"TAGDUST_TPU_MESH": "0"})
        a, b = files(f"mesh{tag}"), files(f"one{tag}")
        check(a.keys() == b.keys(), "mesh and one-card runs wrote other files")
        diff = [k for k in a if a[k] != b[k]]
        check(not diff, f"{tag}: files differ between 4 cards and 1 card: "
              f"{diff}")
        print(f"cards {tag}: {len(a)} output files byte-identical, 4 cards "
              f"vs 1 card")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from tagdust_tpu.jax_env import jax

    clock = CompileClock(jax)
    dev = device_check(jax, args.cards)
    with tempfile.TemporaryDirectory() as tmp:
        if args.cards == 4:
            four_cards(jax, clock, tmp)
        else:
            one_card(jax, clock, tmp)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    try:
        main()
    except PhaseError as e:
        sys.exit(f"chip_smoke: FAILED: {e}")

"""Multi-host execution groundwork (VERDICT round 1, item 8; SURVEY §5
"Distributed communication backend" row).

The reference is strictly single-node (pthreads, barcode_hmm.c:1895-2029).
The device scale-out story has two layers:

* **within a process**: the device mesh (`parallel.mesh`) — data-parallel
  read sharding over the devices local to this host, wired into the runner;
* **across hosts** (this module): `jax.distributed` initialization plus
  per-host *input* sharding — each process owns the read chunks with
  ``global_chunk_index % process_count == process_index``, boundary-skips
  the rest (``SeqReader.skip_chunk`` -> ``td_skip_fastq``: no arena copies,
  no nuc encoding), and writes its own output shard (``<out>.h<pid>_...``)
  plus a per-chunk byte-range sidecar; at the end host 0 interleaves the
  shards back into the reference's single demultiplexed file set
  (:func:`merge_output_shards`).  Outcome counters are summed across hosts
  with a collective so every host's logfile reports the global totals.
  The merged file set is byte-identical to a single-process run's
  (process-count invariance, asserted by tests/test_multihost.py on a
  2-process CPU gloo rig).

Stats, calibration and architecture detection run ONCE on host 0 and are
broadcast (controller.py:_once_on_host0) — they are deterministic given
``-seed``, so this saves duplicated work without changing results.
"""

from __future__ import annotations

import sys
from typing import Optional


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize jax.distributed (idempotent) and return
    (process_index, process_count).

    With no arguments, jax.distributed auto-detects cluster environments
    (SLURM, ...); explicit coordinator/nprocs/procid serve
    manual launches and the CPU test rig.
    """
    from ..jax_env import jax

    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id

    # Detect a pre-existing client (e.g. an auto-detected single-process
    # one) so explicit -coordinator/-nprocs/-procid can override it.
    # jax._src.distributed is a private API that moves between releases, so
    # inspect it best-effort and otherwise rely on initialize() raising
    # RuntimeError when a client already exists (ADVICE round 2).
    client_known = None  # None = could not determine
    try:
        from jax._src import distributed as _dist

        client_known = _dist.global_state.client is not None
        if (
            client_known
            and kwargs
            and num_processes is not None
            and _dist.global_state.num_processes != num_processes
        ):
            jax.distributed.shutdown()
            client_known = False
    except Exception:  # noqa: BLE001 — private-API drift
        pass
    if client_known is not True:
        try:
            jax.distributed.initialize(**kwargs)
        except RuntimeError as e:
            if "already initialized" not in str(e).lower():
                raise
    if (
        num_processes is not None
        and num_processes > 1
        and jax.process_count() != num_processes
    ):
        raise SystemExit(
            f"ERROR: multi-host init requested {num_processes} processes "
            f"but the backend reports {jax.process_count()} — a JAX backend "
            "was initialized before tagdust started (check that no library "
            "touches jax.devices() at import time)."
        )
    return jax.process_index(), jax.process_count()


def global_counter_sum(counters: dict) -> dict:
    """Sum an ordered int-counter dict across all processes (the cross-host
    analogue of the reference's join-then-reduce on log_information,
    barcode_hmm.c:354-385).  No-op for single-process runs."""
    import jax

    if jax.process_count() == 1:
        return dict(counters)
    import numpy as np
    from jax.experimental import multihost_utils

    keys = sorted(counters)
    # ship each int64 counter as two int32 halves: without jax_enable_x64
    # (the default) a device int64 array silently narrows to int32, which
    # would truncate counters past ~2.1e9 reads — exactly the multi-host
    # production scale (VERDICT round 2, item 8).  The halves survive the
    # int32 collective exactly; the sum happens host-side in numpy int64.
    vals = np.asarray([int(counters[k]) for k in keys], dtype=np.int64)
    lo = (vals & 0xFFFFFFFF).astype(np.int32)
    hi = (vals >> 32).astype(np.int32)
    allv = np.asarray(
        multihost_utils.process_allgather(np.stack([lo, hi]))
    )  # [P, 2, len(keys)] int32
    parts = allv.astype(np.int64)
    per_host = (parts[:, 0] & 0xFFFFFFFF) | (parts[:, 1] << 32)
    tot = per_host.sum(axis=0)
    return {k: int(tot[i]) for i, k in enumerate(keys)}


def broadcast_obj(obj, is_source: bool):
    """Broadcast a picklable object from process 0 to all processes.

    Used to compute stats / calibration thresholds / arch detection ONCE
    (on host 0) instead of redundantly on every host: two
    ``broadcast_one_to_all`` rounds — payload length, then the pickled
    bytes.  Returns the object on every process."""
    import pickle

    import jax
    import numpy as np

    if jax.process_count() == 1:
        return obj
    from jax.experimental import multihost_utils

    payload = pickle.dumps(obj) if is_source else b""
    n = multihost_utils.broadcast_one_to_all(
        np.array([len(payload)], dtype=np.int32)
    )
    buf = np.zeros(int(n[0]), dtype=np.uint8)
    if is_source:
        buf[:] = np.frombuffer(payload, dtype=np.uint8)
    buf = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    return pickle.loads(buf.tobytes())


def _barrier_with_timeout(name: str, timeout_s: float) -> None:
    """Cross-host barrier that FAILS LOUDLY instead of hanging forever.

    A host that died before reaching the barrier (malformed input aborts
    are made symmetric upstream, but output errors — ENOSPC in the writer
    thread, say — kill only the owning host) must not leave the survivors
    blocked in an untimed collective.  The coordination-service barrier
    carries an explicit timeout and also errors out early when the
    coordinator declares a peer dead (missed heartbeats), either way
    surfacing a SystemExit with the barrier name.  Falls back to
    ``sync_global_devices`` when the distributed client is unreachable
    (private-API drift) — that path keeps the old untimed behavior."""
    try:
        from jax._src import distributed as _dist

        client = _dist.global_state.client
    except Exception:  # noqa: BLE001 — private-API drift
        client = None
    if client is not None:
        try:
            client.wait_at_barrier(name, int(timeout_s * 1000))
        except Exception as e:  # noqa: BLE001 — timeout or dead peer
            sys.stderr.write(
                f"[ERROR]\tcross-host barrier '{name}' failed after "
                f"{timeout_s:.0f}s — a peer process likely died "
                f"(its logfile has the original error): {e}\n"
            )
            raise SystemExit(1)
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def merge_output_shards(base_outfile: str, pid: int, nproc: int) -> None:
    """Interleave the per-host output shards back into the reference's
    single demultiplexed file set (io.c:757-1029 contract).

    Every host wrote ``<base>.h<p><suffix>`` shard files plus a sidecar
    index of per-chunk byte ranges (io/writer.py:mark_chunk).  After a
    cross-host barrier, host 0 concatenates each output file's chunks in
    GLOBAL chunk order — chunk c lives in host ``c % nproc``'s shard — so
    the merged bytes equal a single-process run's exactly, then removes
    the shards.  Requires the hosts to share a filesystem (true on pods
    with a shared scratch; per-host object stores need a gather step
    instead).

    The barrier times out (``TAGDUST_TPU_BARRIER_TIMEOUT_S``, default
    900 s) so an asymmetric host death fails the run loudly rather than
    hanging the pod."""
    import json
    import os

    timeout_s = float(os.environ.get("TAGDUST_TPU_BARRIER_TIMEOUT_S", "900"))
    _barrier_with_timeout("tagdust:shards-written", timeout_s)
    if pid != 0:
        return
    shards = []
    for p in range(nproc):
        sc = f"{base_outfile}.h{p}.chunks.json"
        try:
            with open(sc) as fh:
                shards.append(json.load(fh)["files"])
        except FileNotFoundError:
            shards.append({})  # host owned no chunks
    suffixes = sorted({s for sh in shards for s in sh})
    for suffix in suffixes:
        segs = []  # (chunk_idx, host, start, end)
        for p, sh in enumerate(shards):
            for ci, a, b in sh.get(suffix, []):
                segs.append((ci, p, a, b))
        segs.sort()
        handles = {}
        try:
            with open(base_outfile + suffix, "wb") as out:
                for ci, p, a, b in segs:
                    fh = handles.get(p)
                    if fh is None:
                        fh = handles[p] = open(
                            f"{base_outfile}.h{p}{suffix}", "rb"
                        )
                    fh.seek(a)
                    out.write(fh.read(b - a))
        finally:
            for fh in handles.values():
                fh.close()
    for p, sh in enumerate(shards):
        for suffix in sh:
            try:
                os.remove(f"{base_outfile}.h{p}{suffix}")
            except FileNotFoundError:
                pass
        try:
            os.remove(f"{base_outfile}.h{p}.chunks.json")
        except FileNotFoundError:
            pass

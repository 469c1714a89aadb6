"""Multi-device scale-out: data-parallel read sharding over a device mesh.

The reference's only parallelism is a pthread fan-out over reads with
per-thread model copies and a join-then-reduce step
(``barcode_hmm.c:1895-2029``).  The device equivalent implemented here:

* HMM parameter tensors (the compiled lattice) are **replicated** to every
  device;
* read batches are **sharded on the batch axis** across the mesh
  (`jax.sharding.NamedSharding` over a 1-D ``reads`` mesh axis);
* per-outcome counters and architecture posteriors are reduced with
  ``psum`` (`shard_map`), the collective analogue of the reference's
  join-then-reduce.

Reads never split across devices: the sequence axis is the scan dimension
of the per-device DP (SURVEY.md §2.4).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from ..jax_env import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.tpu import TpuEngine


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=("reads",))


class ShardedScorer:
    """Data-parallel scorer: each device runs the engine's own per-device
    program (`TpuEngine._get_scorer`, `_get_packed`, `_get_decided`) on its
    batch shard, plus a psum-reduced outcome histogram (the distributed
    analogue of ``log_information`` counting, barcode_hmm.c:354-385)."""

    def __init__(self, engine: TpuEngine, mesh: Optional[Mesh] = None):
        self.engine = engine
        self.mesh = mesh or make_mesh()
        self.n = int(self.mesh.devices.size)
        self._cache: dict = {}

    def _outcome_counts(self, mapq, valid, threshold):
        # outcome accounting reduced across devices (psum == the reference's
        # join-then-reduce, barcode_hmm.c:1987-1992); padded reads masked out
        accept = (mapq >= threshold) & valid
        reject = (mapq < threshold) & valid
        counts = jnp.stack(
            [
                jnp.sum(accept.astype(jnp.int32)),
                jnp.sum(reject.astype(jnp.int32)),
            ]
        )
        return jax.lax.psum(counts, "reads")

    def _get_fn(self, Lp: int):
        key = ("score", Lp)
        if key in self._cache:
            return self._cache[key]
        _, full = self.engine._get_scorer(Lp)

        def per_shard(seqs, lens, valid, threshold):
            f_log, r_log, bar_log, labels, mapq = full(seqs, lens)
            counts = self._outcome_counts(mapq, valid, threshold)
            return f_log, r_log, bar_log, labels, mapq, counts

        fn = jax.jit(
            shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=(P("reads", None), P("reads"), P("reads"), P()),
                out_specs=(
                    P("reads"),
                    P("reads"),
                    P("reads"),
                    P("reads", None),
                    P("reads"),
                    P(),
                ),
                check_vma=False,
            )
        )
        self._cache[key] = fn
        return fn

    # ---------------- packed streaming dispatch ----------------
    def _get_packed_fn(self, Lp: int):
        """Per-shard PACKED program under shard_map: each device runs the
        exact single-device packed pipeline (labels|scores|DUST bitcast into
        one uint8 row per read, engine/tpu.py:_get_packed) on its batch
        shard.  This is what lets the production streaming loop
        (engine/runner.py:_label_tpu_streaming) keep its DEPTH-in-flight
        windows, single-fetch results and async copies when the mesh is
        engaged — the multi-device path is the single-device path times n,
        not a different program."""
        key = ("packed", Lp)
        if key not in self._cache:
            _, raw = self.engine._get_packed(Lp)
            self._cache[key] = jax.jit(
                shard_map(
                    raw,
                    mesh=self.mesh,
                    in_specs=(P("reads", None), P("reads")),
                    out_specs=P("reads", None),
                    check_vma=False,
                )
            )
        return self._cache[key]

    def _get_decided_fn(self, Lp: int):
        """Per-shard DECIDED program (on-device extraction decisions,
        engine/tpu.py:_get_decided) under shard_map — threshold and minlen
        ride along as replicated scalars."""
        from ..engine.tpu import nibble_uploads

        key = ("decided", Lp, nibble_uploads())
        if key not in self._cache:
            _, raw = self.engine._get_decided(Lp)
            self._cache[key] = jax.jit(
                shard_map(
                    raw,
                    mesh=self.mesh,
                    in_specs=(P("reads", None), P("reads"), P(), P()),
                    out_specs=P("reads", None),
                    check_vma=False,
                )
            )
        return self._cache[key]

    def _put_rows(self, seqs: np.ndarray, lens: np.ndarray):
        if seqs.shape[0] % self.n:
            raise ValueError(
                f"window {seqs.shape[0]} not a multiple of {self.n} devices"
            )
        seqs_d = jax.device_put(
            jnp.asarray(seqs), NamedSharding(self.mesh, P("reads", None))
        )
        lens_d = jax.device_put(
            jnp.asarray(lens.astype(np.int32)),
            NamedSharding(self.mesh, P("reads")),
        )
        return seqs_d, lens_d

    def dispatch_packed_decided(
        self, seqs: np.ndarray, lens: np.ndarray, thr32, minlen: int
    ):
        """Mesh analogue of TpuEngine.dispatch_decided (uploads are
        nibble-packed like the single-device path)."""
        from ..engine.tpu import nibble_uploads

        fn = self._get_decided_fn(seqs.shape[1])
        up = seqs.astype(np.uint8)
        if nibble_uploads():
            up = self.engine.pack_nibbles(up)
        seqs_d, lens_d = self._put_rows(up, lens)
        return fn(seqs_d, lens_d, jnp.float32(thr32), jnp.int32(minlen))

    def dispatch_packed(self, seqs: np.ndarray, lens: np.ndarray):
        """Asynchronously dispatch one packed window sharded over the mesh;
        returns the sharded device array without blocking (the mesh
        analogue of TpuEngine.dispatch_packed).  B must be a multiple of
        the device count — the streaming windows guarantee it."""
        fn = self._get_packed_fn(seqs.shape[1])
        return fn(*self._put_rows(seqs.astype(np.uint8), lens))

    def run(self, seqs: np.ndarray, lens: np.ndarray, threshold: float = 0.0):
        """Returns (f_log, r_log, bar_log, labels, mapq, counts); the first
        five are defined for the first ``len(seqs)`` rows (padding rows may
        follow), counts covers only the real reads."""
        fn = self._get_fn(seqs.shape[1])
        B = seqs.shape[0]
        pad = (-B) % self.n
        if pad:
            # copies of read 0, not zero rows — see TpuEngine.run_batch
            seqs = np.concatenate(
                [seqs, np.broadcast_to(seqs[:1], (pad, seqs.shape[1]))]
            )
            lens = np.concatenate([lens, np.broadcast_to(lens[:1], (pad,))])
        valid = np.zeros(seqs.shape[0], dtype=bool)
        valid[:B] = True
        seqs_d, lens_d = self._put_rows(seqs.astype(np.uint8), lens)
        valid_d = jax.device_put(
            jnp.asarray(valid), NamedSharding(self.mesh, P("reads"))
        )
        return fn(seqs_d, lens_d, valid_d, jnp.float32(threshold))


def _expected_lattice_counts(lat_dev, seqs, lens):
    """Device-side Baum-Welch expectations in lattice state space.

    Returns (CT [5, S, S], E [5, S], n_scored): posterior transition-mass
    per (base, src, dst) and posterior emission counts per (base, state).
    The per-step outer products run as [S, B] x [B, S] matmuls.
    Invariant (asserted by tests): E.sum() == sum(lens) — each emitted base
    carries total posterior mass 1.
    """
    Afwd = lat_dev["Afwd"]  # [5S, S+K]
    Abwd = lat_dev["Abwd"]
    end = lat_dev["end"]
    A3 = lat_dev["A3"]  # [5, S, S] raw step matrices
    begin = lat_dev["begin"]
    S = lat_dev["S"]

    B, Lpad = seqs.shape
    pos = jnp.arange(Lpad)
    active = pos[None, :] < lens[:, None]
    onehot = jax.nn.one_hot(seqs, 5, dtype=jnp.float32)

    from ..engine.tpu import _expand, backward_scan

    def expand(v, oh):
        return _expand(v, oh, S)

    # the ONE shared backward recurrence (engine/tpu.py:backward_scan) —
    # training counts see bit-the-same backward values as production scores
    bfin, bls_fin, bwd_stack, bls_stack = backward_scan(
        Abwd, end, S, onehot, active, with_stack=True
    )
    logP = jnp.log(jnp.maximum(bfin[:, begin], 1e-38)) + bls_fin

    def kahan_add(acc, comp, inc):
        # compensated accumulation: float32 running sums would silently drop
        # increments once acc > ~2^24 x increment (tens of millions of
        # emitted bases — exactly the scale this distributed path targets)
        y = inc - comp
        t = acc + y
        comp = (t - acc) - y
        return t, comp

    def fwd_step(carry, x):
        v, ls, CT, CTc, E, Ec = carry
        oh, act, bw, bls = x
        W = expand(v, oh)  # [B, 5S]
        vn = W @ Afwd[:, :S]
        # exponent clamped so padded steps cannot overflow to inf (inf * 0
        # masks to NaN and trips jax_debug_nans; active values are tiny)
        w = jnp.exp(jnp.minimum(ls + bls - logP, 60.0)) * act  # [B]
        # transition posterior: A[c][s,t] * v[s] * b[t] * w, batch-summed
        Y = jnp.einsum("bx,bt->xt", W * w[:, None], bw)  # [5S, S]
        CT, CTc = kahan_add(CT, CTc, Y.reshape(5, S, S) * A3)
        # emission posterior at the new position, scattered by base
        occ = vn * bw * w[:, None]  # [B, S]
        E, Ec = kahan_add(E, Ec, jnp.einsum("bc,bs->cs", oh, occ))
        m = jnp.max(vn, axis=1, keepdims=True)
        m = jnp.where(m > 0, m, 1.0)
        v = jnp.where(act[:, None], vn / m, v)
        ls = jnp.where(act, ls + jnp.log(m[:, 0]), ls)
        return (v, ls, CT, CTc, E, Ec), None

    v0 = jnp.zeros((B, S), jnp.float32).at[:, begin].set(1.0)
    ls0 = jnp.zeros((B,), jnp.float32)
    CT0 = jnp.zeros((5, S, S), jnp.float32)
    E0 = jnp.zeros((5, S), jnp.float32)
    xs_f = (jnp.swapaxes(onehot, 0, 1), active.T, bwd_stack, bls_stack)
    (_, _, CT, _, E, _), _ = jax.lax.scan(
        fwd_step, (v0, ls0, CT0, CT0, E0, E0), xs_f
    )
    return CT, E, jnp.sum(lens)


class DistributedTrainer:
    """MODE_TRAIN over the mesh: per-shard Baum-Welch expected counts in
    lattice space, reduced with psum — the collective analogue of the
    reference's per-thread count merge (`copy_estimated_parameter`,
    barcode_hmm.c:5694-5744, reduced at :1977-1992)."""

    def __init__(self, engine: TpuEngine, mesh: Optional[Mesh] = None):
        self.engine = engine
        self.mesh = mesh or make_mesh()
        lat_dev = dict(engine._dev)
        lat_dev["A3"] = jnp.asarray(engine.lat.A)  # [5, S, S]

        def per_shard(seqs, lens):
            CT, E, n = _expected_lattice_counts(lat_dev, seqs, lens)
            CT = jax.lax.psum(CT, "reads")
            E = jax.lax.psum(E, "reads")
            n = jax.lax.psum(n, "reads")
            return CT, E, n

        self._fn = jax.jit(
            shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=(P("reads", None), P("reads")),
                out_specs=(P(), P(), P()),
                check_vma=False,
            )
        )

    def run(self, seqs: np.ndarray, lens: np.ndarray):
        n = self.mesh.devices.size
        B = seqs.shape[0]
        pad = (-B) % n
        if pad:
            seqs = np.concatenate([seqs, np.zeros((pad, seqs.shape[1]), seqs.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
        seqs_d = jax.device_put(
            jnp.asarray(seqs.astype(np.int32)),
            NamedSharding(self.mesh, P("reads", None)),
        )
        lens_d = jax.device_put(
            jnp.asarray(lens.astype(np.int32)),
            NamedSharding(self.mesh, P("reads")),
        )
        CT, E, total = self._fn(seqs_d, lens_d)
        return np.asarray(CT), np.asarray(E), int(total)

    def expected_segment_counts(self, seqs: np.ndarray, lens: np.ndarray):
        """Full distributed MODE_TRAIN step: device expectations, psum
        reduce, then mapping back to the reference's per-segment count
        arrays — feed the result to `engine.train.reestimate`."""
        from ..engine.train import lattice_counts_to_counts

        CT, E, _ = self.run(seqs, lens)
        return lattice_counts_to_counts(self.engine.mb, CT, E)

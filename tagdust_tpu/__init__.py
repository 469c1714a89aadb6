"""tagdust_tpu — an accelerator read-classification / demultiplexing framework.

A ground-up rebuild of the capabilities of TagDust2 (Lassmann, BMC
Bioinformatics 16:24, 2015) in JAX, running on NVIDIA GPUs:

* the user-facing *read architecture* DSL (``-1 B:AC,GG -2 R:N`` ...) compiles
  into dense profile-HMM parameter tensors (`tagdust_tpu.model`),
* the per-read forward/backward + max-posterior labeling dynamic program runs
  batched on the device via JAX/XLA (`tagdust_tpu.engine`),
* a bit-exact deterministic engine (`tagdust_tpu.engine.exact`) reproduces the
  reference's ``-DRTEST`` float32 lookup-table arithmetic for golden
  regression tests,
* host-side IO streams FASTQ/FASTA/SAM batches into device buffers and writes
  demultiplexed per-barcode files with the reference's exact naming and header
  conventions (`tagdust_tpu.io`),
* scale-out happens through `jax.sharding` data-parallel meshes with `psum`
  reductions for counters and posteriors (`tagdust_tpu.parallel`).
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep large allocations on the (warm) glibc heap instead of fresh mmaps.

    The columnar pipeline churns through ~100MB-class numpy temporaries per
    chunk.  glibc serves blocks >128KB from fresh mmap()s by default, so every
    chunk pays first-touch page faults for its whole working set; on
    virtualised hosts (nested EPT) faults can run at ~50MB/s — 100x slower
    than warm memory.  Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes the
    heap grow once and stay warm (a large gain for repeated 200MB
    alloc+fill on virtualised hosts).  Trades peak-RSS trimming for throughput;
    disable with TAGDUST_TPU_MALLOC_REUSE=0."""
    import os
    import sys

    if os.environ.get("TAGDUST_TPU_MALLOC_REUSE", "1") != "1":
        return
    if not sys.platform.startswith("linux"):
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass  # musl / restricted environments: default allocator behaviour


_tune_malloc()

"""Multi-file demultiplexing orchestrator.

Re-implements ``hmm_controller_multiple`` (``barcode_hmm.c:51-460``):
per-file architecture resolution (CLI arch for file 0, ``-arch``
auto-detection or the default ``R:N`` otherwise), the barcode-in-one-file
check, output-overwrite refusal, per-file stats + threshold calibration +
model build, the chunked streaming loop with cross-file count/name
consistency checks, per-file engine dispatch (pure ``R:N`` -> filter-only),
outcome merging (max across files; barcode propagated to file 0), writing,
and the end-of-run outcome accounting / human-readable summary
(``barcode_hmm.c:354-433``).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from .arch import (
    ReadStructure,
    build_read_structure,
    qc_read_structure,
    read_structure_from_params,
)
from .calibrate import estimate_q_threshold
from .constants import (
    EXTRACT_FAIL_AMBIGIOUS_BARCODE,
    EXTRACT_FAIL_ARCHITECTURE_MISMATCH,
    EXTRACT_FAIL_BAR_FINGER_NOT_FOUND,
    EXTRACT_FAIL_LOW_COMPLEXITY,
    EXTRACT_FAIL_MATCHES_ARTIFACTS,
    EXTRACT_FAIL_READ_TOO_SHORT,
    EXTRACT_SUCCESS,
)
from .detect import test_architectures
from .engine.runner import (
    run_get_label_batch,
    run_get_prob,
    run_rna_dust_batch,
)
from .io.fastq import SeqReader, read_fasta_contaminants
from .io.writer import DemuxWriter, existing_output_files
from .model import init_model_bag
from .namecheck import compare_read_names
from .stats import get_sequence_stats


class MessageLog:
    """append_message (misc.c:285-335): timestamped lines, echoed to stderr,
    flushed to <out>_logfile.txt at teardown (interface.c:709-726)."""

    def __init__(self):
        self.messages: List[str] = []

    def __call__(self, msg: str) -> None:
        stamp = time.strftime("[%Y-%m-%d %H:%M:%S]\t")
        sys.stderr.write(stamp + msg)
        self.messages.append(stamp + msg)

    def flush(self, outfile: Optional[str]) -> None:
        if outfile:
            with open(f"{outfile}_logfile.txt", "w") as fh:
                fh.write("".join(self.messages) + "\n")


def hmm_controller_multiple(param, log: Optional[MessageLog] = None) -> None:
    log = log or MessageLog()
    nfiles = param.infiles

    # multi-host: each process owns chunks with index % nproc == pid,
    # skip-parses the rest (io/fastq.py:skip_chunk), and writes its own
    # output shard; stats / calibration / arch detection run ONCE on host 0
    # and broadcast; counters are summed across hosts and host 0 merges the
    # shards back into the reference's single file set at the end
    # (parallel/multihost.py)
    pid, nproc = 0, 1
    final_outfile = param.outfile
    if getattr(param, "multihost", False):
        from .parallel.multihost import init_multihost

        pid, nproc = init_multihost(
            param.coordinator, param.num_processes, param.process_id
        )
        if nproc > 1 and param.outfile:
            param.outfile = f"{param.outfile}.h{pid}"
            log(
                f"Multi-host run: process {pid}/{nproc}; "
                f"output shard prefix {param.outfile}\n"
            )
            # a crashed earlier run may have left this host's sidecar behind;
            # a stale index would corrupt the end-of-run shard merge
            try:
                os.remove(f"{param.outfile}.chunks.json")
            except FileNotFoundError:
                pass

    def _once_on_host0(compute):
        """Run `compute` on host 0 and broadcast the result; other hosts
        receive it (or a host-0 failure, surfaced as SystemExit)."""
        if nproc == 1:
            return compute()
        from .parallel.multihost import broadcast_obj

        if pid == 0:
            exc = None
            try:
                payload = ("ok", compute())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                exc = e
                payload = ("err", f"{type(e).__name__}: {e}")
            out = broadcast_obj(payload, True)
            if exc is not None:
                raise exc
            return out[1]
        status, data = broadcast_obj(None, False)
        if status == "err":
            log(f"host 0 failed: {data}\n")
            log.flush(param.outfile)
            raise SystemExit(1)
        return data

    cli_rs = read_structure_from_params(param.segments)

    def _resolve_read_structures() -> List[ReadStructure]:
        out: List[ReadStructure] = []
        for i in range(nfiles):
            if i == 0 and cli_rs.num_segments:
                rs = cli_rs
            elif param.arch_file:
                rs = test_architectures(param, i, log=log)
            else:
                rs = build_read_structure(["R:N"])
                qc_read_structure(rs)
            out.append(rs)
        return out

    read_structures = _once_on_host0(_resolve_read_structures)

    barcode_present = 0
    read_present = [0] * nfiles
    for i, rs in enumerate(read_structures):
        for j in range(rs.num_segments):
            if rs.types[j] == "B":
                barcode_present |= 1 << i
            if rs.types[j] == "R":
                read_present[i] += 1

    if bin(barcode_present).count("1") > 1:
        log("Barcodes seem to be in both architectures... \n")
        log.flush(param.outfile)
        raise SystemExit(1)

    num_out_reads = sum(read_present)
    for i in range(nfiles):
        if barcode_present & (1 << i):
            # refuse on the FINAL (merged) names: that's the file set the
            # user receives (shards are transient under -multihost)
            found = existing_output_files(
                final_outfile, read_structures[i], num_out_reads, param.multiread
            )
            if found:
                log.flush(param.outfile)
                raise SystemExit("Error: some output files already exists.\n")

    param.num_query = 1000 if param.rtest else 1000001
    # streaming chunk size: the reference reads 1,000,001-read batches
    # (barcode_hmm.c:165-175); output bytes are chunk-size invariant (the
    # writer appends per chunk).  Production matches the reference's 1M
    # batches: the device streaming pipeline drains its in-flight windows
    # at every chunk boundary, so fewer/bigger chunks keep the overlap
    # (A/B on 10M reads: 262144 -> 1M chunks cut e2e wall ~25%); the
    # reader/writer threads still overlap across chunks via the queues.
    # Peak memory is ~4 chunks of arenas (~5x the per-chunk input bytes).
    # RTEST keeps the reference's 1000-read batches for determinism
    # parity; stats keeps num_query.
    read_chunk = param.num_query
    first_chunk = read_chunk
    env_chunk = os.environ.get("TAGDUST_TPU_CHUNK")
    if not param.rtest:
        read_chunk = int(env_chunk or 1000000)
        first_chunk = min(
            read_chunk,
            int(os.environ.get("TAGDUST_TPU_FIRST_CHUNK", "131072")),
        )
    elif env_chunk:
        # explicit override honoured in RTEST too: the chunk-invariance
        # tests (the reference's thread_test.sh analogue) sweep chunk sizes
        # and assert byte-identical output (stats/calibration still consume
        # num_query reads, so the RNG stream is chunk-size independent)
        read_chunk = first_chunk = int(env_chunk)

    def _compute_stats_thresholds():
        stats = []
        for i in range(nfiles):
            stats.append(
                get_sequence_stats(
                    param.infile[i],
                    read_structures[i],
                    param.num_query,
                    param.matchstart,
                    param.matchend,
                    sam_filter=param.filter,
                )
            )

        thresholds = [0.0] * nfiles
        if not param.confidence_threshold:
            # calibrate on the engine production will score with
            from .engine.runner import resolve_engine

            kind = resolve_engine(param)

            def _get_prob(mb, seq_list):
                return run_get_prob(mb, seq_list, engine_kind=kind)

            for i in range(nfiles):
                log(f"Determining threshold for read{i}.\n")
                thresholds[i] = estimate_q_threshold(
                    param, read_structures[i], stats[i], _get_prob
                )
                log(f"Selected Threshold:: {thresholds[i]:f}\n")
        # NOTE: with -Q given the reference leaves confidence_thresholds[] at
        # 0.0 and uses those per-file values (barcode_hmm.c:102, :314).
        return stats, thresholds

    stats, thresholds = _once_on_host0(_compute_stats_thresholds)

    model_bags = [
        init_model_bag(
            read_structures[i], stats[i], param.sequencer_error_rate, param.indel_frequency
        )
        for i in range(nfiles)
    ]

    contaminants = None
    contaminant_names = None
    if param.reference_fasta:
        contaminant_names, contaminants = read_fasta_contaminants(param.reference_fasta)
    mer_hash = [0] * (len(contaminants) if contaminants else 0)

    readers = [
        SeqReader(param.infile[i], sam_filter=param.filter) for i in range(nfiles)
    ]

    counters = {
        "total": 0,
        "success": 0,
        "bar_finger": 0,
        "too_short": 0,
        "arch_mismatch": 0,
        "artifact": 0,
        "low_complexity": 0,
    }

    writer: Optional[DemuxWriter] = None
    # read_structure used by the writer: the barcoded file's, else the last
    # file's (barcode_hmm.c:312-340)
    writer_rs = read_structures[-1]
    for i in range(nfiles):
        if barcode_present & (1 << i):
            writer_rs = read_structures[i]
            break

    # ------------------------------------------------------------------
    # Pipelined streaming loop (the device-era analogue of the reference's
    # popen decompression overlap, io.c:459-606, widened to the whole IO
    # path): a reader thread prefetches the next chunk while the current
    # one is scored/extracted, and a writer thread drains finished chunks.
    # Order is preserved (single FIFO per stage); consistency checks,
    # scoring, extraction and counter accounting stay on the main thread.
    # ------------------------------------------------------------------
    chunk_q: queue.Queue = queue.Queue(maxsize=2)
    write_q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()
    writer_err: List[BaseException] = []

    def _reader_loop() -> None:
        # multi-host input sharding: a chunk with index % nproc != pid is
        # owned by another host — only record-boundary scanning is paid for
        # it (SeqReader.skip_chunk -> td_skip_fastq), the cross-host
        # analogue of the reference's per-thread slice ownership
        # (barcode_hmm.c:1911-1922).  When there are multiple input files,
        # every host parses the HEAD of chunk 0 (the <=1000 records the
        # read-name pairing check compares) and boundary-skips the rest, so
        # the check can fail symmetrically on all hosts without non-owners
        # paying a full-chunk parse (arena copies + nuc encoding).
        try:
            cidx = 0
            while not stop.is_set():
                # a smaller FIRST chunk primes the pipeline: chunk 0's parse
                # cannot overlap anything (there is nothing to score yet), so
                # at the 1M-read production chunk size a short leading chunk
                # gets the device working ~1.5 s sooner.  The schedule is a
                # pure function of cidx, identical on every host (chunk
                # ownership and boundaries must agree across processes), and
                # output bytes are chunk-size invariant (asserted by
                # tests/test_dev_fixtures.py).
                clen = first_chunk if cidx == 0 else read_chunk
                own = nproc == 1 or cidx % nproc == pid
                if own:
                    chunks = [
                        readers[i].read_chunk_batch(clen)
                        for i in range(nfiles)
                    ]
                    counts = [c.B for c in chunks]
                elif cidx == 0 and nfiles > 1:
                    head = min(1000, clen)
                    chunks = [
                        readers[i].read_chunk_batch(head)
                        for i in range(nfiles)
                    ]
                    counts = [
                        c.B + (readers[i].skip_chunk(clen - head)
                               if clen > head else 0)
                        for i, c in enumerate(chunks)
                    ]
                else:
                    chunks = None
                    counts = [
                        readers[i].skip_chunk(clen)
                        for i in range(nfiles)
                    ]
                chunk_q.put((cidx, chunks, counts))
                if sum(counts) == 0:
                    return
                cidx += 1
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            chunk_q.put(e)

    def _writer_loop() -> None:
        # after a write failure the loop keeps DRAINING until the None
        # sentinel: exiting immediately would leave the maxsize-1 queue full
        # and deadlock the main thread's next blocking put() (a disk-full
        # error would hang the run instead of raising — ADVICE round 2)
        while True:
            item = write_q.get()
            if item is None:
                return
            if writer_err:
                continue
            try:
                chunks_, numseq_, cidx_ = item
                writer.write_batch_columnar(chunks_, numseq_)
                if writer.track_chunks:
                    # record the GLOBAL-chunk-indexed byte ranges the shard
                    # merge interleaves back (multihost.py:merge_output_shards)
                    writer.mark_chunk(cidx_)
            except BaseException as e:  # noqa: BLE001
                writer_err.append(e)

    reader_thread = threading.Thread(
        target=_reader_loop, name="tagdust-reader", daemon=True
    )
    reader_thread.start()
    writer_thread: Optional[threading.Thread] = None

    def _shutdown_pipeline() -> None:
        stop.set()
        while True:  # unblock the reader if it is waiting on a full queue
            try:
                chunk_q.get_nowait()
            except queue.Empty:
                break
        reader_thread.join(timeout=10)
        if writer_thread is not None:
            write_q.put(None)
            writer_thread.join(timeout=60)

    first_batch = True
    while True:
        item = chunk_q.get()
        if isinstance(item, BaseException):
            _shutdown_pipeline()
            raise item
        chunk_idx, chunks, numseqs = item
        if sum(numseqs) == 0:
            break
        # the cross-file record-count check runs on EVERY chunk on EVERY
        # host — skip_chunk returns per-file counts, and chunk boundaries
        # are identical across hosts, so a mismatch aborts all hosts
        # symmetrically (no collective is left waiting on a dead process)
        for i in range(nfiles - 1):
            for j in range(i + 1, nfiles):
                if numseqs[i] != numseqs[j]:
                    log(
                        f"Input File:{param.infile[i]} and {param.infile[j]} "
                        "differ in number of entries.\n"
                    )
                    log.flush(param.outfile)
                    _shutdown_pipeline()
                    raise SystemExit(1)
        if first_batch and chunks is not None:
            checker = compare_read_names
            for i in range(nfiles - 1):
                for j in range(i + 1, nfiles):
                    for c in range(min(1000, numseqs[0])):
                        if checker(chunks[i].name(c), chunks[j].name(c), log):
                            log(
                                "Files seem to contain reads in different "
                                f"order:\n{chunks[i].name(c)}\n{chunks[j].name(c)}\n"
                            )
                            log.flush(param.outfile)
                            _shutdown_pipeline()
                            raise SystemExit(1)

        if chunks is None or chunk_idx % nproc != pid:
            first_batch = False
            continue  # another host owns this chunk (consistency checks ran)

        # model realloc on longer reads only grows DP scratch (the compiled
        # parameters do not depend on max_seq_len), so nothing to do here
        for i in range(nfiles):
            mx = int(chunks[i].lens.max(initial=0))
            if mx >= stats[i].max_seq_len:
                stats[i].max_seq_len = mx

        for i in range(nfiles):
            rs = read_structures[i]
            if rs.is_pure_R():
                run_rna_dust_batch(chunks[i], param, contaminants)
            else:
                run_get_label_batch(
                    model_bags[i], rs, chunks[i], param, thresholds[i],
                    contaminants,
                )

        # propagate barcode from the barcoded file to file 0
        for i in range(nfiles):
            if barcode_present & (1 << i):
                if i:
                    chunks[0].barcode[:] = chunks[i].barcode
                break

        if nfiles > 1:
            chunks[0].read_type[:] = np.maximum.reduce(
                [chunks[j].read_type for j in range(nfiles)]
            )

        if writer is None:
            writer = DemuxWriter(
                param.outfile, writer_rs, read_present, param.print_seq_finger,
                track_chunks=nproc > 1,
            )
            writer_thread = threading.Thread(
                target=_writer_loop, name="tagdust-writer", daemon=True
            )
            writer_thread.start()
        if writer_err:
            _shutdown_pipeline()
            raise writer_err[0]
        # hand the finished chunk to the writer thread; the counter pass
        # below only READS read_type, and nothing mutates reads after this
        write_q.put((chunks, numseqs[0], chunk_idx))
        first_batch = False

        counters["total"] += numseqs[0]
        rt = chunks[0].read_type
        counters["success"] += int((rt == EXTRACT_SUCCESS).sum())
        counters["bar_finger"] += int(
            (rt == EXTRACT_FAIL_BAR_FINGER_NOT_FOUND).sum()
        )
        counters["too_short"] += int((rt == EXTRACT_FAIL_READ_TOO_SHORT).sum())
        counters["arch_mismatch"] += int(
            (rt == EXTRACT_FAIL_ARCHITECTURE_MISMATCH).sum()
        )
        # reference case fallthrough (barcode_hmm.c:373-377): plain
        # MATCHES_ARTIFACTS counts as artifact AND low complexity
        plain_art = int((rt == EXTRACT_FAIL_MATCHES_ARTIFACTS).sum())
        counters["artifact"] += plain_art
        counters["low_complexity"] += plain_art + int(
            (rt == EXTRACT_FAIL_LOW_COMPLEXITY).sum()
        )
        other = (rt > EXTRACT_FAIL_LOW_COMPLEXITY) | (
            rt == EXTRACT_FAIL_AMBIGIOUS_BARCODE
        )
        counters["artifact"] += int(other.sum())
        if mer_hash:
            ids = (rt[other] >> 8) - 1
            bc = np.bincount(
                np.clip(ids, 0, len(mer_hash) - 1), minlength=len(mer_hash)
            )
            for k in range(len(mer_hash)):
                mer_hash[k] += int(bc[k])

    if writer_thread is not None:
        write_q.put(None)
        writer_thread.join()
        if writer_err:
            raise writer_err[0]
    reader_thread.join(timeout=10)
    if writer is not None:
        writer.close()
    if not reader_thread.is_alive():
        # only close the readers once the reader thread is provably done
        # with them: a timed-out join (stalled IO) with a concurrent close
        # would be a racy file-object use-after-close (ADVICE round 2); the
        # daemon thread and its handles are reclaimed at process exit
        for r in readers:
            r.close()

    if nproc > 1:
        import json

        from .parallel.multihost import global_counter_sum, merge_output_shards

        if os.environ.get("TAGDUST_TPU_IO_STATS"):
            with open(f"{param.outfile}.iostats.json", "w") as fh:
                json.dump(
                    {
                        "parsed": sum(r.records_parsed for r in readers),
                        "skipped": sum(r.records_skipped for r in readers),
                    },
                    fh,
                )
        # interleave the per-host shards back into the reference's single
        # demultiplexed file set (io.c:757-1029 contract); EVERY host enters
        # (the call holds a cross-host barrier), host 0 performs the merge
        if writer is not None:
            writer.write_sidecar(f"{param.outfile}.chunks.json")
        merge_output_shards(final_outfile, pid, nproc)
        # every host's logfile reports the GLOBAL outcome totals (the
        # cross-host analogue of the reference's join-then-reduce)
        counters = global_counter_sum(counters)
        if mer_hash:
            mh = global_counter_sum({str(i): v for i, v in enumerate(mer_hash)})
            mer_hash = [mh[str(i)] for i in range(len(mer_hash))]

    log("Done.\n\n")
    for i in range(nfiles):
        log(f"{param.infile[i]}\tInput file {i}.\n")
    log(f"{counters['total']}\ttotal input reads\n")
    log(f"{thresholds[-1]:.2f}\tselected threshold\n")
    log(f"{counters['success']}\tsuccessfully extracted\n")
    pct = (
        100.0 * counters["success"] / counters["total"] if counters["total"] else 0.0
    )
    log(f"{pct:.1f}%\textracted\n")
    log(f"{counters['arch_mismatch']}\tproblems with architecture\n")
    log(f"{counters['bar_finger']}\tbarcode / UMI not found\n")
    log(f"{counters['too_short']}\ttoo short\n")
    log(f"{counters['low_complexity']}\tlow complexity\n")
    log(f"{counters['artifact']}\tmatch artifacts:\n")
    if contaminant_names:
        for i, n in enumerate(contaminant_names):
            if mer_hash[i]:
                log(f"{mer_hash[i]}\t{n}\n")
    # host 0 writes the reference-named <out>_logfile.txt (its counters are
    # the global totals); other hosts keep their shard-named logfiles
    log.flush(final_outfile if pid == 0 else param.outfile)

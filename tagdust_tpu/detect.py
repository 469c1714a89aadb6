"""Architecture auto-detection from candidate arch files.

Re-implements ``test_architectures`` (``test_architectures.c:20-289``): every
"tagdust" line of the ``-arch`` file is a candidate; each candidate gets its
own sequence-stats pass and compiled model; with >1 candidates the first
100,000 reads are scored backward-only per architecture, per-read log
likelihoods are summed float32 within each emulated thread slice, slices are
summed in thread order (``barcode_hmm.c:2111-2148``, ``:1994-2017``), the
softmax over architectures picks the winner, and the winning command line is
re-parsed into the active read structure.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .arch import ReadStructure, build_read_structure, qc_read_structure, read_arch_file
from .engine.exact import ExactEngine
from .engine.runner import thread_slices
from .logsum import NEG_INF, logsum
from .model import init_model_bag
from .stats import get_sequence_stats
from .io.fastq import SeqReader

_F32 = np.float32


def pretty_print_selected_architecture(line: str) -> str:
    """test_architectures.c:292-345."""
    from .arch import parse_arch_line

    parts = []
    specs = parse_arch_line(line)
    for i, s in enumerate(specs):
        parts.append(f"-{i + 1} {s}")
    return "Using: " + " ".join(parts) + " \n"


def test_architectures(param, file_num: int, log=None) -> ReadStructure:
    candidates: List[Tuple[str, ReadStructure, object]] = []
    path = param.infile[file_num]
    num_query = 100000
    entries = read_arch_file(param.arch_file)
    if log:
        log(f"Looking at file:{path}\n")
        log(f"Searching for best architecture in file '{param.arch_file}'\n")
    for line, specs in entries:
        rs = build_read_structure(specs)
        ssi = get_sequence_stats(
            path, rs, num_query, param.matchstart, param.matchend,
            sam_filter=param.filter,
        )
        qc_read_structure(rs)
        mb = init_model_bag(rs, ssi, param.sequencer_error_rate, param.indel_frequency)
        candidates.append((line, rs, mb))
    if not candidates:
        raise SystemExit(
            f"Error - could not find any architectures in file: {param.arch_file}"
        )

    if len(candidates) > 1:
        reader = SeqReader(path, sam_filter=param.filter)
        reads = reader.read_chunk(num_query)
        reader.close()
        numseq = len(reads)
        n_arch = len(candidates)

        from .engine.runner import get_engine, resolve_engine

        kind = resolve_engine(param)
        bscores = np.zeros((n_arch, numseq), dtype=np.float32)
        if kind == "tpu":
            # device MODE_ARCH_COMP: one padded [B, Lmax] batch, one masked
            # backward sweep per candidate on the device; the host path
            # below stays the -rtest / -engine exact parity reference
            from .engine.runner import _pad_tpu_batch

            lens = np.fromiter(
                (r.len for r in reads), dtype=np.int32, count=numseq
            )
            Lmax = int(lens.max(initial=1))
            seqs = np.zeros((numseq, Lmax), dtype=np.uint8)
            for i, r in enumerate(reads):
                seqs[i, : r.len] = r.seq
            seqs_p, lens_p = _pad_tpu_batch(seqs, lens)
            for a, (_, _, mb) in enumerate(candidates):
                bscores[a] = get_engine(mb, "tpu").backward_scores(
                    seqs_p, lens_p
                )[:numseq]
        else:
            engines = [ExactEngine(mb) for _, _, mb in candidates]

            # per-arch b_score for every read (bucketed by length for speed;
            # the per-read values are independent of batching)
            buckets = {}
            for idx, r in enumerate(reads):
                buckets.setdefault(r.len, []).append(idx)
            for L, idxs in buckets.items():
                seqs = np.zeros((len(idxs), L + 1), dtype=np.uint8)
                for bi, idx in enumerate(idxs):
                    seqs[bi, :L] = reads[idx].seq
                for a, eng in enumerate(engines):
                    bs = eng.backward_only(seqs, L)
                    for bi, idx in enumerate(idxs):
                        bscores[a, idx] = bs[bi]

        # float32 slice sums in thread order (barcode_hmm.c:2126-2144, :2000)
        posterior = np.zeros(n_arch, dtype=np.float32)
        for s, e in thread_slices(numseq, param.num_threads):
            part = np.zeros(n_arch, dtype=np.float32)
            for i in range(s, e):
                part = (part + bscores[:, i]).astype(np.float32)
            posterior = (posterior + part).astype(np.float32)

        # run_pHMM normalises once (barcode_hmm.c:2009-2016), then
        # test_architectures normalises again (:191-206) — replicate both.
        sm = posterior[0]
        for i in range(1, n_arch):
            sm = logsum(sm, posterior[i])
        posterior = (posterior - sm).astype(np.float32)
        sm = posterior[0]
        for i in range(1, n_arch):
            sm = logsum(sm, posterior[i])
        best_architecture = -1
        best_score = _F32(-1.0)
        probs = np.zeros(n_arch, dtype=np.float32)
        for i in range(n_arch):
            with np.errstate(over="ignore"):
                probs[i] = _F32(np.exp(np.float64(_F32(posterior[i] - sm))))
            if probs[i] > best_score:
                best_score = probs[i]
                best_architecture = i
        if log:
            log(pretty_print_selected_architecture(candidates[best_architecture][0]))
            log(f"{best_score:.2f} Confidence.\n")
    else:
        best_architecture = 0
        if log:
            log(pretty_print_selected_architecture(candidates[0][0]))
            log(f"Confidence: {1.0:.2f}\n")

    line = candidates[best_architecture][0]
    from .arch import parse_arch_line

    rs = build_read_structure(parse_arch_line(line))
    qc_read_structure(rs)
    return rs

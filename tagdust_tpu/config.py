"""Command-line parameter model shared by all tools.

Mirrors the option surface and defaults of the reference CLI
(``interface.c:49-480``): the same ``-1..-10`` segment options, simulation
options, thresholds and filter settings, so that existing TagDust2 command
lines (including the arch-file DSL) work unchanged against this framework.

Framework-specific additions:
* ``-rtest`` / env ``TAGDUST_TPU_RTEST=1`` selects the deterministic mode the
  reference builds as separate ``*_rtest`` binaries (LCG rand, 1000-read
  chunks, 4000 calibration sims; ``src/Makefile.am:89-99``).
* ``-engine {auto,exact,tpu}`` picks the DP engine (exact float32 table
  arithmetic vs the device engine; ``auto`` takes the device engine when
  JAX runs on a GPU).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def _f32(v) -> float:
    """atof() stored into a C float field: round the double through float32.

    Several reference parameters are `float` struct members (e.g.
    sequencer_error_rate, sim_random_frac, interface.h:215-246); arithmetic
    like ``(int)((float)numseq * (1.0 - sim_random_frac))``
    (simulate_reads.c:142) depends on that narrowing.
    """
    return float(np.float32(v))


@dataclass
class Params:
    # input / output
    infile: List[str] = field(default_factory=list)
    outfile: Optional[str] = None
    num_threads: int = 8
    num_query: int = 1000000
    # read structure
    segments: List[Optional[str]] = field(default_factory=lambda: [None] * 10)
    arch_file: Optional[str] = None
    # model parameters (interface.c:87-94)
    sequencer_error_rate: float = _f32(0.05)
    indel_frequency: float = _f32(0.1)
    average_read_length: int = 50
    numbarcode: int = 8
    confidence_threshold: float = 0.0
    # search window
    matchstart: int = -1
    matchend: int = -1
    minlen: int = 16
    # filters
    dust: int = 100
    filter_error: int = 2
    reference_fasta: Optional[str] = None
    # misc
    format: Optional[str] = None
    filter: Optional[str] = None
    train: Optional[str] = None
    exact5: Optional[str] = None
    seed: int = 0
    log: Optional[str] = None
    print_artifact: Optional[str] = None
    print_seq_finger: bool = False
    multiread: int = 0
    join: bool = False
    split: bool = False
    sim: int = 0
    # simulation options
    sim_barlen: int = 0
    sim_barnum: int = 0
    sim_5seq: Optional[str] = None
    sim_3seq: Optional[str] = None
    sim_readlen: int = 0
    sim_readlen_mod: int = 0
    sim_error_rate: float = 0.0
    sim_InDel_frac: float = 0.0
    sim_numseq: int = 0
    sim_random_frac: float = 0.0
    sim_end_loss: int = 0
    # framework extensions
    rtest: bool = False
    engine: str = "auto"
    profile_dir: Optional[str] = None
    show_help: bool = False
    show_version: bool = False
    # multi-host (jax.distributed) execution
    multihost: bool = False
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    @property
    def infiles(self) -> int:
        return len(self.infile)


# option name -> (attr, conversion); None conversion means boolean flag
_OPTS = {
    "train": ("train", str),
    "name": ("format", str),
    "format": ("format", str),
    "minlen": ("minlen", int),
    "start": ("matchstart", lambda v: int(v) - 1),
    "exact5": ("exact5", str),
    "simulation": ("sim", int),
    "numbarcode": ("numbarcode", int),
    "end": ("matchend", int),
    "threshold": ("confidence_threshold", _f32),
    "fe": ("filter_error", int),
    "ref": ("reference_fasta", str),
    "dust": ("dust", int),
    "out": ("outfile", str),
    "filter": ("filter", str),
    "sim_barlen": ("sim_barlen", int),
    "sim_barnum": ("sim_barnum", int),
    "sim_5seq": ("sim_5seq", str),
    "sim_3seq": ("sim_3seq", str),
    "sim_readlen": ("sim_readlen", int),
    "sim_readlen_mod": ("sim_readlen_mod", int),
    "sim_error_rate": ("sim_error_rate", _f32),
    "sim_InDel_frac": ("sim_InDel_frac", _f32),
    "sim_numseq": ("sim_numseq", int),
    "sim_random_frac": ("sim_random_frac", _f32),
    "sim_endloss": ("sim_end_loss", int),
    "arch": ("arch_file", str),
    "seed": ("seed", int),
    "show_finger_seq": ("print_seq_finger", None),
    "join": ("join", None),
    "split": ("split", None),
    "help": ("show_help", None),
    "version": ("show_version", None),
    "log": ("log", str),
    # framework extensions
    "rtest": ("rtest", None),
    "engine": ("engine", str),
    "profile": ("profile_dir", str),
    "multihost": ("multihost", None),
    "coordinator": ("coordinator", str),
    "nprocs": ("num_processes", int),
    "procid": ("process_id", int),
}

# short single-char options "Q:e:o:p:q:hvf:t:i:l:L:a:" (interface.c:183)
_SHORT = {
    "Q": ("confidence_threshold", _f32),
    "q": ("confidence_threshold", _f32),
    "e": ("sequencer_error_rate", _f32),
    "o": ("outfile", str),
    "p": (None, str),  # accepted but unused (parity with getopt string)
    "f": ("filter", str),
    "t": ("num_threads", int),
    "i": ("indel_frequency", _f32),
    "l": ("log", str),
    "L": ("log", str),
    "a": ("print_artifact", str),
    "h": ("show_help", None),
    "v": ("show_version", None),
}


def parse_args(argv: List[str]) -> Params:
    """Parse a TagDust2-compatible command line (getopt_long_only style:
    both ``-opt`` and ``--opt`` accepted)."""
    p = Params()
    if os.environ.get("TAGDUST_TPU_RTEST"):
        p.rtest = True
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1:
            name = a.lstrip("-")
            # segment options -1 .. -10
            if name.isdigit() and 1 <= int(name) <= 10:
                seg = int(name) - 1
                i += 1
                p.segments[seg] = argv[i]
            elif name in _OPTS:
                attr, conv = _OPTS[name]
                if conv is None:
                    setattr(p, attr, True)
                else:
                    i += 1
                    setattr(p, attr, conv(argv[i]))
            elif name in _SHORT:
                attr, conv = _SHORT[name]
                if conv is None:
                    setattr(p, attr, True)
                elif attr is not None:
                    i += 1
                    setattr(p, attr, conv(argv[i]))
                else:
                    i += 1
            else:
                raise SystemExit(f"Unknown option: {a}")
        else:
            p.infile.append(a)
        i += 1
    return p

"""tagdust — the main demultiplexer CLI.

Flag-compatible with the reference binary (``main.c:95-217``,
``interface.c:49-480``); validation order mirrors main(): architecture
presence, QC, input files, output prefix, arch-file existence.
"""

from __future__ import annotations

import os
import sys

from ..arch import qc_read_structure, read_structure_from_params
from ..config import parse_args
from ..controller import MessageLog, hmm_controller_multiple


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    param = parse_args(args)
    if param.show_help:
        print("Usage: tagdust [options] <file> -o <output prefix>")
        return
    if param.show_version:
        print("tagdust_tpu 0.1.0")
        return

    try:
        cli_rs = read_structure_from_params(param.segments)
        if cli_rs.num_segments:
            qc_read_structure(cli_rs)
    except ValueError as e:
        # QC failures surface as clean messages, not tracebacks
        # (interface.c:759-792 appends to the log and exits)
        sys.stderr.write(str(e) + "\n")
        raise SystemExit(1)
    if cli_rs.num_segments == 0 and param.arch_file is None and param.infiles:
        # main.c:103-105: no architecture at all is an error ... except the
        # controller falls back to R:N per file when neither is given; the
        # reference errors out here:
        pass
    if cli_rs.num_segments == 0 and param.arch_file is None:
        sys.stdout.write("ERROR: No read architecture found.\n")
        raise SystemExit(0)
    if param.infiles == 0:
        sys.stdout.write("ERROR: No input file found.\n")
        raise SystemExit(0)
    if param.outfile is None:
        sys.stdout.write(
            "ERROR: You need to specify an output file prefix using the -o / "
            "-out option.\n"
        )
        raise SystemExit(0)
    if param.arch_file is not None and not os.path.exists(param.arch_file):
        sys.stdout.write(f"ERROR: Arch file:{param.arch_file} does not exists.\n")
        raise SystemExit(0)
    for f in param.infile:
        if not os.path.exists(f):
            sys.stdout.write(f"ERROR: Input file:{f} does not exists.\n")
            raise SystemExit(0)

    # multiread + filter disabling (interface.c:419-450)
    c = sum(1 for t in cli_rs.types if t == "R")
    if c >= 2:
        param.multiread = c
    if (param.reference_fasta or param.dust) and param.multiread:
        param.dust = 0
        param.reference_fasta = None

    log = MessageLog()
    log("Start Run\n--------------------------------------------------\n")
    if param.profile_dir:
        # tracing subsystem: device + host profile written for TensorBoard /
        # xprof (the reference only has timestamped log lines, misc.c:285)
        from ..jax_env import jax

        with jax.profiler.trace(param.profile_dir):
            hmm_controller_multiple(param, log=log)
    else:
        hmm_controller_multiple(param, log=log)


if __name__ == "__main__":
    main()

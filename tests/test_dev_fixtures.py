"""Parity on the reference's OWN surviving regression fixtures.

The reference ships `dev/test_data/{format,thread}_{arch.txt,test.fq}`
(consumed by its format_test.sh / thread_test.sh, dev/Makefile.am:15-20;
the .sh drivers are absent from the snapshot but the fixture corpus
survives).  These tests drive the actual fixture FILES — not synthesized
stand-ins — through both this package's CLI and a freshly compiled
reference `tagdust_rtest`, asserting byte-identical demultiplexed output:

* format fixture: as-is FASTQ, gzipped FASTQ, and FASTA-ified input
  (the reference accepts all three and emits FASTQ with '.' qualities
  for FASTA input — io.c:1684-1815);
* thread fixture: output invariance across streaming chunk sizes
  100/1000/10000 and across engines (exact / device), the analogue of
  the reference's `-t` thread-count invariance (barcode_hmm.c:1895-2029).
"""

import glob
import gzip
import os
import shutil
import subprocess
import sys

import pytest

FIX = "/root/reference/dev/test_data"

requires_fixtures = pytest.mark.skipif(
    not os.path.isdir(FIX), reason="reference dev/test_data not mounted"
)


def _run_ours(cwd, infile, out, env, extra=()):
    res = subprocess.run(
        [
            sys.executable, "-m", "tagdust_tpu.cli.tagdust",
            "-seed", "42", "-arch", "arch.txt", *extra, infile, "-o", out,
        ],
        cwd=cwd, env=env, capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr[-2000:]


def _run_ref(cwd, ref_bins, infile, out):
    res = subprocess.run(
        [
            ref_bins["tagdust_rtest"], "-seed", "42", "-arch", "arch.txt",
            infile, "-o", out,
        ],
        cwd=cwd, capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr[-2000:]


def _fq_outputs(cwd, prefix):
    outs = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(cwd, prefix + "*"))
        if not p.endswith("_logfile.txt")
    )
    assert outs, f"no outputs for {prefix}"
    return outs


def _assert_same_fileset(cwd, ours, ref):
    ours_files = _fq_outputs(cwd, ours)
    ref_files = _fq_outputs(cwd, ref)
    assert [f[len(ours):] for f in ours_files] == [
        f[len(ref):] for f in ref_files
    ]
    for of, rf in zip(ours_files, ref_files):
        a = open(os.path.join(cwd, of), "rb").read()
        b = open(os.path.join(cwd, rf), "rb").read()
        assert a == b, f"{of} differs from the reference build's {rf}"


@requires_fixtures
def test_format_fixture_parity(tmp_path, ref_bins):
    """format_test.fq + format_arch.txt: as-is, gzipped, and FASTA-ified,
    each compared byte-wise against the reference binary."""
    from conftest import spawn_env

    cwd = str(tmp_path)
    shutil.copy(os.path.join(FIX, "format_arch.txt"),
                os.path.join(cwd, "arch.txt"))
    raw = open(os.path.join(FIX, "format_test.fq"), "rb").read()

    # 1) plain FASTQ, the fixture file itself
    shutil.copy(os.path.join(FIX, "format_test.fq"),
                os.path.join(cwd, "format_test.fq"))
    # 2) gzipped
    with gzip.open(os.path.join(cwd, "format_test.fq.gz"), "wb") as fh:
        fh.write(raw)
    # 3) FASTA-ified (same records, no qualities)
    lines = raw.decode().splitlines()
    with open(os.path.join(cwd, "format_test.fa"), "w") as fh:
        for i in range(0, len(lines), 4):
            fh.write(">" + lines[i][1:] + "\n" + lines[i + 1] + "\n")

    env = spawn_env()
    for tag, infile in (
        ("fq", "format_test.fq"),
        ("gz", "format_test.fq.gz"),
        ("fa", "format_test.fa"),
    ):
        _run_ours(cwd, infile, f"ours_{tag}", env)
        _run_ref(cwd, ref_bins, infile, f"ref_{tag}")
        _assert_same_fileset(cwd, f"ours_{tag}", f"ref_{tag}")


def _amplify(src, dst, times):
    raw = open(src, "rb").read()
    with open(dst, "wb") as fh:
        for _ in range(times):
            fh.write(raw)


@requires_fixtures
def test_thread_fixture_chunk_invariance(tmp_path, ref_bins):
    """thread_test.fq + thread_arch.txt, amplified to 1200 records so the
    streaming loop actually splits: every (chunk size, engine) combination
    must reproduce the reference binary's output byte-wise — the device
    analogue of the reference's thread-count invariance test."""
    from conftest import spawn_env

    cwd = str(tmp_path)
    shutil.copy(os.path.join(FIX, "thread_arch.txt"),
                os.path.join(cwd, "arch.txt"))
    _amplify(os.path.join(FIX, "thread_test.fq"),
             os.path.join(cwd, "thread_big.fq"), 200)

    _run_ref(cwd, ref_bins, "thread_big.fq", "ref")

    for chunk in (100, 1000, 10000):
        env = spawn_env(TAGDUST_TPU_CHUNK=chunk)
        out = f"ours_c{chunk:05d}"  # zero-padded: prefixes must not nest
        _run_ours(cwd, "thread_big.fq", out, env, extra=("-t", "4"))
        _assert_same_fileset(cwd, out, "ref")

    # device engine (XLA scan flavor on this CPU suite rig), non-RTEST
    # mode: decisions must match the reference corpus exactly; mapq floats
    # never reach the output bytes for this fixture's R:N architecture
    env = spawn_env(rtest=False, TAGDUST_TPU_CHUNK=250)
    _run_ours(cwd, "thread_big.fq", "ours_tpu", env, extra=("-engine", "tpu"))
    _assert_same_fileset(cwd, "ours_tpu", "ref")

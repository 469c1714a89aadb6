import os

# Device-engine tests run on a virtual 8-device CPU mesh; the deterministic
# gold tests don't touch JAX at all.  Set before jax initialises a backend.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

# ---------------------------------------------------------------------------
# Reference C build: compile the -DRTEST regression binaries from
# /root/reference/src (the mechanism behind the reference's own gold files,
# src/Makefile.am:89-99) so parity tests can compare outputs LIVE instead of
# against frozen hashes.  Session-cached under /tmp; skipped when the
# reference tree or a C compiler is unavailable.
# ---------------------------------------------------------------------------
import shutil
import subprocess

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_env(rtest: bool = True, **extra) -> dict:
    """Environment for CLI subprocesses spawned by tests: the CPU backend
    with one device unless ``XLA_FLAGS`` is passed in ``extra`` (the
    parent's 8-device flag is not inherited).  Extra keyword args are added
    verbatim (values stringified)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    if rtest:
        env["TAGDUST_TPU_RTEST"] = "1"
    env["PYTHONPATH"] = _REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    for k, v in extra.items():
        env[k] = str(v)
    return env


_REF_SRC = "/root/reference/src"
_REF_BUILD = "/tmp/tagdust_ref_build"

_REF_TARGETS = {
    # name -> (extra cppflags, sources, libs)  [src/Makefile.am]
    "tagdust_rtest": (
        ["-DRTEST", "-DTAGDUST"],
        ["kslib.c", "main.c", "interface.c", "nuc_code.c", "misc.c", "io.c",
         "barcode_hmm.c", "calibrateQ.c", "test_architectures.c"],
        ["-lpthread", "-lm"],
    ),
    "simreads_rtest": (
        ["-DRTEST", "-DSIMREADS"],
        ["kslib.c", "interface.c", "nuc_code.c", "misc.c", "simulate_reads.c"],
        ["-lm"],
    ),
    "evalres_rtest": (
        ["-DRTEST", "-DEVALRES"],
        ["kslib.c", "evalresults.c", "interface.c", "misc.c", "nuc_code.c",
         "io.c"],
        ["-lm"],
    ),
    "merge_ref": (
        ["-DMERGE"],
        ["kslib.c", "interface.c", "nuc_code.c", "io.c", "misc.c", "merge.c"],
        ["-lpthread", "-lm"],
    ),
}

_REF_CFLAGS = [
    "-O2", "-std=gnu99", "-fcommon",
    '-DPACKAGE_NAME="tagdust"', '-DPACKAGE_VERSION="2.33"',
    '-DPACKAGE_BUGREPORT="none"',
]


@pytest.fixture(scope="session")
def ref_bins():
    """Paths to freshly built reference binaries, or skip."""
    if not os.path.isdir(_REF_SRC):
        pytest.skip("reference sources not available")
    gcc = shutil.which("gcc") or shutil.which("cc")
    if gcc is None:
        pytest.skip("no C compiler")
    os.makedirs(_REF_BUILD, exist_ok=True)
    out = {}
    for name, (flags, srcs, libs) in _REF_TARGETS.items():
        exe = os.path.join(_REF_BUILD, name)
        src_paths = [os.path.join(_REF_SRC, s) for s in srcs]
        newest = max(os.path.getmtime(p) for p in src_paths)
        if not os.path.exists(exe) or os.path.getmtime(exe) < newest:
            res = subprocess.run(
                [gcc, *_REF_CFLAGS, *flags, "-o", exe, *src_paths, *libs],
                capture_output=True, text=True, cwd=_REF_SRC,
            )
            if res.returncode != 0:
                pytest.skip(f"reference build failed: {res.stderr[-500:]}")
        out[name] = exe
    return out


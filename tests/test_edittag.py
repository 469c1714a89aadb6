"""In-repo barcode sets and the compile-cache location."""

import itertools
import os
import subprocess
import sys

import pytest

from tagdust_tpu.cli.simreads import load_edittag_barcodes
from tagdust_tpu.edittag import edit_distance, greedy_barcodes, write_edittag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [20, 48])
def test_greedy_barcodes_distance_and_determinism(n, tmp_path):
    bcs = greedy_barcodes(n)
    assert len(set(bcs)) == n and all(len(b) == 6 for b in bcs)
    assert min(edit_distance(a, b)
               for a, b in itertools.combinations(bcs, 2)) >= 3
    assert greedy_barcodes(n) == bcs
    # a larger set extends the smaller one (the smoke run's decoy
    # candidate takes barcodes 20-23)
    assert greedy_barcodes(n + 4)[:n] == bcs
    path = str(tmp_path / "tags.txt")
    write_edittag(path, bcs)
    assert load_edittag_barcodes(path) == bcs


def test_edit_distance():
    assert edit_distance("ACGTAC", "ACGTAC") == 0
    assert edit_distance("ACGTAC", "ACGAAC") == 1
    assert edit_distance("ACGTAC", "CGTAC") == 1
    assert edit_distance("AAAA", "TTTT") == 4


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(env_dir, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "from tagdust_tpu.jax_env import jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, check=True,
    ).stdout.strip()
    assert out == want

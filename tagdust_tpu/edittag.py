"""Barcode sets with a guaranteed pairwise edit distance.

EDITTAG-style sets (``Tag<i>:SEQ`` lines, the format `cli/simreads.py`
reads): candidates are all 4^length sequences in an order drawn from a
fixed seed; a candidate is kept when its Levenshtein distance to every
barcode kept so far is at least ``min_dist``.  The same arguments always
give the same set, so benchmarks and smoke runs need no barcode file from
outside the repository.
"""

from __future__ import annotations

import itertools

import numpy as np


def edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def greedy_barcodes(
    n: int, length: int = 6, min_dist: int = 3, seed: int = 0
) -> list[str]:
    """The first ``n`` barcodes of the greedy set; raises if the space of
    ``length``-mers holds fewer than ``n`` at that distance."""
    cands = ["".join(p) for p in itertools.product("ACGT", repeat=length)]
    order = np.random.default_rng(seed).permutation(len(cands))
    out: list[str] = []
    for i in order:
        c = cands[int(i)]
        if all(edit_distance(c, b) >= min_dist for b in out):
            out.append(c)
            if len(out) == n:
                return out
    raise ValueError(
        f"only {len(out)} {length}-mers at edit distance >= {min_dist}"
    )


def write_edittag(path: str, barcodes: list[str]) -> None:
    """Write ``Tag<i>:SEQ`` lines, the barcode file format of simreads."""
    with open(path, "w") as fh:
        for i, b in enumerate(barcodes):
            fh.write(f"Tag{i}:{b}\n")

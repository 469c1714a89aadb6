"""Loud, opt-out fallback handling for accelerated code paths.

Host-native fast paths (the C++ FASTQ codec, the C++ calibration read
emitters) have a slower pure-Python equivalent.  A silent downgrade can cost
10-20x with zero diagnostics, so every such fallback funnels through
:func:`fallback`.  Device paths have no fallback: a device failure raises.

* the first failure per site prints a WARNING with the exception to stderr
  (stderr, not stdout — bench.py's stdout is machine-parsed);
* ``TAGDUST_TPU_STRICT=1`` re-raises instead, so CI and kernel development
  catch a broken fast path immediately.
"""

from __future__ import annotations

import os
import sys

_warned: set = set()


def strict_mode() -> bool:
    return os.environ.get("TAGDUST_TPU_STRICT") == "1"


def fallback(site: str, exc: BaseException, message: str) -> None:
    """Record that the fast path ``site`` failed and ``message`` describes
    the downgrade.  Raises under TAGDUST_TPU_STRICT=1; warns once otherwise."""
    if strict_mode():
        raise exc
    if site not in _warned:
        _warned.add(site)
        sys.stderr.write(
            f"[tagdust_tpu] WARNING: {site}: {message} "
            f"({type(exc).__name__}: {exc})\n"
        )

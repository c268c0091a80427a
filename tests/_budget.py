"""Suite wall-time budget for randomized/soak-style tests.

The long differentials and in-suite soaks are the inner loop of every
development session, so their iteration counts default to a QUICK value
that still crosses every phase they exist to cover (events mid-horizon,
BPM/transport toggles, loop wraps). Export LIBZL_TPU_FUZZ_BLOCKS=full for
the soak-length runs (CI-style full passes, pre-release), or an integer
to pin an explicit count. Seeds stay fixed either way.
"""

import os


def fuzz_blocks(quick: int, full: int) -> int:
    v = os.environ.get("LIBZL_TPU_FUZZ_BLOCKS", "").strip()
    if not v:
        return quick
    if v.lower() == "full":
        return full
    return int(v)

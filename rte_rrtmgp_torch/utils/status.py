"""Status printing (reference ``include_test/Status.h:29-58``)."""

from __future__ import annotations

import sys
import time

_T0 = time.time()


def print_message(msg: str) -> None:
    print(f"[{time.time() - _T0:8.3f}s] {msg}", flush=True)


def print_warning(msg: str) -> None:
    print(f"WARNING: {msg}", flush=True)


def print_error(msg: str) -> None:
    print(f"ERROR: {msg}", file=sys.stderr, flush=True)

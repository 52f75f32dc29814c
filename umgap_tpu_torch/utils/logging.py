"""Stderr logging gated on the VERBOSE / DEBUG environment variables (a
copy of ``umgap_tpu.utils.logging``): ``log`` always writes, ``verbose``
only with VERBOSE (or DEBUG) set, ``debug`` only with DEBUG set. A
variable counts as set unless it is empty, "0", "false" or "False"."""

from __future__ import annotations

import os
import sys
import time


def _enabled(var: str) -> bool:
    return os.environ.get(var, "") not in ("", "0", "false", "False")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def verbose(msg: str) -> None:
    if _enabled("VERBOSE") or _enabled("DEBUG"):
        log(f"[{time.strftime('%H:%M:%S')}] {msg}")


def debug(msg: str) -> None:
    if _enabled("DEBUG"):
        log(f"[{time.strftime('%H:%M:%S')} debug] {msg}")

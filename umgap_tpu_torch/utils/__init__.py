"""Shared utilities: stderr logging gated on VERBOSE / DEBUG
(:mod:`.logging`), per-stage wall timers and device traces
(:mod:`.profiling`), as ``umgap_tpu.utils`` has them."""

from .logging import debug, log, verbose
from .profiling import StageTimer, device_trace, sync

__all__ = ["debug", "log", "verbose", "StageTimer", "device_trace", "sync"]

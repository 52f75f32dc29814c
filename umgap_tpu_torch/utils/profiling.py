"""Per-stage wall timers and device traces (a counterpart of
``umgap_tpu.utils.profiling``).

:class:`StageTimer` adds up wall time by stage name, with an optional
device sync at each stop so that asynchronous launches do not hide
device time; its :meth:`~StageTimer.report` is ``umgap_tpu``'s, line for
line. :func:`device_trace` records a ``torch.profiler`` trace of a run.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import OrderedDict
from typing import Iterator, Optional

import torch

# Chrome-trace categories of device activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def sync(device=None) -> None:
    """Wait for the work queued on a CUDA ``device`` (the current one when
    None and a card is visible); nothing on the CPU, whose work is done
    when its call returns."""
    if device is not None and torch.device(device).type != "cuda":
        return
    if device is not None or torch.cuda.is_available():
        torch.cuda.synchronize(device)


class StageTimer:
    """Wall time added up by stage name.

    ``device_sync`` True waits for the device at each stage's end
    (:func:`sync`: ``torch.cuda.synchronize`` on a CUDA run), so a stage
    holds its device work and not only its launches.

    >>> t = StageTimer()
    >>> with t.stage("probe"):
    ...     pass
    >>> _ = t.report()
    """

    def __init__(self, device_sync: bool = False):
        self.device_sync = device_sync
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device_sync:
                sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in self.totals.items():
            n = self.counts[name]
            lines.append(
                f"{name:24s} {total * 1e3:10.2f} ms total"
                f"  ({n} calls, {total / n * 1e3:.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None,
                 device=None) -> Iterator[None]:
    """``torch.profiler`` trace of the block, exported as a Chrome trace
    (``umgap_tpu_torch.<pid>.<time>.pt.trace.json``) into ``trace_dir``
    (the argument, else ``UMGAP_TRACE_DIR``); a no-op when neither is
    set. On a CUDA ``device`` it records CPU and CUDA activity, and fails
    if the trace holds no device activity rather than keep a trace of the
    CPU alone."""
    trace_dir = trace_dir or os.environ.get("UMGAP_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    path = os.path.join(trace_dir, f"umgap_tpu_torch.{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if cuda:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(e.get("cat") in DEVICE_CATEGORIES for e in events):
            raise RuntimeError(
                f"--trace-dir: the profiler recorded no CUDA activity in "
                f"{path} (CUPTI unavailable?)")

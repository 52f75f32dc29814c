"""Device traces (a counterpart of ``umgap_tpu.utils.profiling``'s
``device_trace``)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch

# Chrome-trace categories of device activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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

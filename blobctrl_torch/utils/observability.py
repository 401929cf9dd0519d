"""Tracing, profiling and structured metrics (counterpart of
``blobctrl_tpu/utils/observability.py``, on ``torch.profiler``):

  * ``log_event``: structured JSON-lines logging on the ``blobctrl_torch``
    logger;
  * ``trace``: a ``torch.profiler`` trace written as a Chrome trace;
  * ``annotate``: a named region in the trace
    (``torch.profiler.record_function``);
  * ``profile_op_breakdown``: {op: ms per call} from the profiler's
    ``key_averages()``, the card's kernels by device time, or the CPU's
    operators by host time;
  * ``StepTimer``: per-phase wall time, synchronizing the card first.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger("blobctrl_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def log_event(event: str, **fields):
    logger.info(json.dumps({"event": event, **fields}))


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block and write ``trace.json`` (Chrome trace format:
    chrome://tracing or Perfetto) into log_dir, by default a new directory
    under the temporary directory. Yields the directory."""
    from torch.profiler import profile
    log_dir = log_dir or tempfile.mkdtemp(prefix="blobctrl_trace_")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log_event("trace_written", dir=log_dir, path=path)


@contextlib.contextmanager
def annotate(name: str):
    """A named region in profiler traces."""
    with torch.profiler.record_function(name):
        yield


def _on_device(ev) -> bool:
    return getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA


def _device_us(ev) -> float:
    return float(getattr(ev, "self_device_time_total", None)
                 or getattr(ev, "self_cuda_time_total", 0.0))


def profile_op_breakdown(fn, *args, repeats: int = 3,
                         top_k: int = 20) -> Dict[str, float]:
    """Run ``fn(*args)`` once to warm up, then ``repeats`` times under
    ``torch.profiler`` -> {op name: ms per call}, the top_k by time. Where
    CUDA is available each entry is a kernel and its device time, the
    hand-written kernels launched through ctypes included; on the CPU each
    entry is an operator and its self host time."""
    from torch.profiler import profile
    on_card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    fn(*args)
    sync()
    with profile(activities=_activities()) as prof:
        for _ in range(repeats):
            fn(*args)
        sync()
    buckets: Dict[str, float] = collections.Counter()
    for ev in prof.key_averages():
        if on_card:
            if _on_device(ev):
                buckets[ev.key] += _device_us(ev)
        elif not _on_device(ev):
            buckets[ev.key] += float(ev.self_cpu_time_total)
    result = {k: round(v / repeats / 1000.0, 4)
              for k, v in sorted(buckets.items(), key=lambda kv: -kv[1])
              [:top_k] if v > 0}
    log_event("op_breakdown", **result)
    return result


class StepTimer:
    """Wall-clock phase timing; accumulates per-phase stats. With
    ``sync_on`` a CUDA tensor, the card is synchronized before the phase's
    clock stops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if isinstance(sync_on, torch.Tensor) and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4),
                    "mean_s": round(v / max(self.counts[k], 1), 4),
                    "count": self.counts[k]}
                for k, v in self.totals.items()}

    def report(self):
        log_event("step_timer",
                  **{k: v["mean_s"] for k, v in self.summary().items()})

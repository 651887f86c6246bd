"""Profiling and phase timing.

The reference has no tracing at all (SURVEY.md section 5 - only wall-clock
prints in the notebook). Port of sbsim_tpu/utils/profiling.py on
torch.profiler: a trace context for device timelines (a Chrome trace,
viewable in TensorBoard's profile plugin or Perfetto) and a lightweight
phase timer for host-side loops.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, Iterator, Set

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Captures a profile of the host and, where a CUDA device is present,
    its kernels, written as `<host>_<pid>.<time>.pt.trace.json` under
    log_dir."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        acc_events=True,  # one window: keep its events for the handler
    )
    prof.start()
    try:
        yield
    finally:
        prof.stop()


def annotate(name: str):
    """Named region that shows up inside device traces."""
    return torch.profiler.record_function(name)


def _cuda_devices(tree, out: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of the tensors in a nested structure."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    return out


class PhaseTimer:
    """Accumulates host wall-time per named phase."""

    def __init__(self):
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        """Times a phase; pass tensors (or a structure holding them) as
        block_on to include device time: their CUDA devices are
        synchronized before the clock stops."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            for device in _cuda_devices(block_on, set()):
                torch.cuda.synchronize(device)
        self._totals[name] += time.perf_counter() - t0
        self._counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_sec": self._totals[name],
                "calls": self._counts[name],
                "mean_ms": 1000.0 * self._totals[name] / self._counts[name],
            }
            for name in self._totals
        }

    def report(self) -> str:
        lines = []
        for name, stats in sorted(
            self.summary().items(), key=lambda kv: -kv[1]["total_sec"]
        ):
            lines.append(
                f"{name:32s} {stats['total_sec']:8.2f}s "
                f"{stats['calls']:6d} calls  {stats['mean_ms']:8.2f} ms/call"
            )
        return "\n".join(lines)

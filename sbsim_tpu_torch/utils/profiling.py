"""Profiling: the port's one tracing system.

The reference has no tracing at all (SURVEY.md section 5 - only wall-clock
prints in the notebook). This module holds the port's spans and counters,
placed at its layer boundaries (captured programs, the env step, the host
control loop, the trainer and the learner), plus a trace context for device
timelines and a phase timer for host loops.

Spans. `span(name)` is a context manager that records its name, start and
end (`time.perf_counter_ns`, the monotonic clock), its parent span and the
id of the outermost span around it (the call it belongs to). Records go
into a bounded ring; per name the registry keeps the count, the total time
and the self time (the total less what child spans cover). While a torch
profiler records, a span also opens a FUNCTION-scope profiler range of the
same name, so it lands in the profiler's event list and Chrome trace as a
CPU op on the trace's own clock. It is not a USER-scope `record_function`:
a user range around a launch adds a device-side annotation to the trace,
which would count among the device's operations.

Counters. `count(name, n)` adds to a host counter. `count_tensor(name, t)`
keeps a device tensor by reference and sums it only when read, so counting
a device value costs no read-back and no kernel per call.

On and off. Tracing is on inside `tracing()`, the operator's switch, and
whenever a torch profiler records. Off, `span` returns one shared no-op and
a counter returns after a check of the two flags. Each time tracing turns
on, a fresh stretch starts (a profiler's start is seen through torch's
`_run_on_profiler_start`, which this module wraps once); `snapshot()`
returns the last stretch. While tracing is on by the switch alone, the
captured programs put a pair of CUDA timing events around each replay,
which `snapshot()` resolves into the device time inside replays and
between them: idle measured without the profiler.

Set-up records. A span made with `keep=True` is recorded whether tracing
is on or off, into the set-up records (`setup()`), and into the stretch
too while tracing is on; so are the counters of a `family`, a dict the
program adds to whatever the state of tracing: a capture's span, the
captures and the memory their graphs keep, and the kernels' launch counts
(families of device launches, which captured programs follow at replay).

There is no exporter: spans reach a file through the profiler's trace
(`device_trace`), and code reads `snapshot()` and `setup()`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Deque, Dict, Iterator, List, NamedTuple, Optional, Set, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

# Records kept per stretch (and of set-up), the oldest dropped first.
RING = 65536
# Device tensors a counter holds before it folds them into one (one
# concatenation and one sum per fold).
FOLD = 256


class Record(NamedTuple):
    """One closed span: ids are unique in the process; `parent` is None for
    an outermost span, whose own id is its `call`."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: int


class _Stretch:
    """What one stretch of tracing recorded."""

    def __init__(self, families: Dict[str, Dict[str, int]]):
        self.start_ns = time.perf_counter_ns()
        self.records: Deque[Record] = collections.deque(maxlen=RING)
        self.spans: Dict[str, List[int]] = {}  # name -> [count, total ns, self ns]
        self.counters: Dict[str, float] = {}
        self.tensors: Dict[str, List[torch.Tensor]] = {}
        self.family_base = {p: dict(d) for p, d in families.items()}
        self.events: Deque[Tuple[Any, Any]] = collections.deque(maxlen=RING)


def _span_stats(spans: Dict[str, List[int]]) -> Dict[str, Dict[str, float]]:
    return {name: {"count": c, "total_us": t / 1e3, "self_us": s / 1e3}
            for name, (c, t, s) in spans.items()}


def _add_span(spans: Dict[str, List[int]], record: Record, self_ns: int) -> None:
    agg = spans.get(record.name)
    if agg is None:
        agg = spans[record.name] = [0, 0, 0]
    agg[0] += 1
    agg[1] += record.end_ns - record.start_ns
    agg[2] += self_ns


def _fold(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the tensors' elements, as one 0-d tensor on their device
    (int64 for integer tensors, float64 otherwise)."""
    dtype = torch.float64 if any(t.is_floating_point() for t in tensors) else torch.int64
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors]).sum()


class Registry:
    """The process's spans and counters (the module-level functions use
    REGISTRY)."""

    def __init__(self):
        self._local = threading.local()
        self._ids = itertools.count()
        self._stretch: Optional[_Stretch] = None
        self.families: Dict[str, Dict[str, int]] = {}
        self.launches: List[Dict[str, int]] = []  # the families that count device launches
        self._setup_records: Deque[Record] = collections.deque(maxlen=RING)
        self._setup_spans: Dict[str, List[int]] = {}

    # Stretches ----------------------------------------------------------

    def start_stretch(self) -> None:
        self._stretch = _Stretch(self.families)

    def stretch(self) -> _Stretch:
        if self._stretch is None:
            self.start_stretch()
        return self._stretch

    # Spans --------------------------------------------------------------

    def _stack(self) -> List["_Span"]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, s: "_Span") -> None:
        stack = self._stack()
        parent = stack[-1] if stack else None
        s.id = next(self._ids)
        s.parent = None if parent is None else parent.id
        s.call = s.id if parent is None else parent.call
        s.stretch = self.stretch() if on() else None
        stack.append(s)
        if s.stretch is not None and _autograd_profiler._is_profiler_enabled:
            s.range = _RecordFunctionFast(s.name)
            s.range.__enter__()
        s.start = time.perf_counter_ns()

    def close(self, s: "_Span") -> None:
        end = time.perf_counter_ns()
        if s.range is not None:
            s.range.__exit__(None, None, None)
        stack = self._stack()
        stack.pop()
        duration = end - s.start
        if stack:
            stack[-1].child_ns += duration
        record = Record(s.name, s.start, end, s.id, s.parent, s.call)
        self_ns = duration - s.child_ns
        if s.stretch is not None:
            s.stretch.records.append(record)
            _add_span(s.stretch.spans, record, self_ns)
        if s.keep:
            self._setup_records.append(record)
            _add_span(self._setup_spans, record, self_ns)

    # Reading ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        st = self._stretch
        if st is None:
            return {}
        counters = dict(st.counters)
        for name, tensors in st.tensors.items():
            if tensors:
                counters[name] = _fold(tensors).item()
        for prefix, values in self.families.items():
            base = st.family_base.get(prefix, {})
            for key, value in values.items():
                if value != base.get(key, 0):
                    counters[f"{prefix}.{key}"] = value - base.get(key, 0)
        out = {"start_ns": st.start_ns, "spans": _span_stats(st.spans), "counters": counters,
               "records": list(st.records)}
        if st.events:
            out["device"] = _device_times(st.events)
        return out

    def setup(self) -> Dict[str, Any]:
        counters = {f"{p}.{k}": v for p, d in self.families.items() for k, v in d.items()}
        return {"spans": _span_stats(self._setup_spans), "counters": counters,
                "records": list(self._setup_records)}


def _device_times(events) -> Dict[str, float]:
    """Replays and ms inside them and between them (from one replay's end to
    the next one's start on the same device) of the stretch's timing
    events."""
    events[-1][1][1].synchronize()
    inside = between = 0.0
    last: Dict[Any, Any] = {}
    for device, (before, after) in events:
        inside += before.elapsed_time(after)
        if device in last:
            between += last[device].elapsed_time(before)
        last[device] = after
    return {"replays": len(events), "replay_ms": inside, "between_ms": between}


REGISTRY = Registry()
_switch = 0  # depth of open tracing() blocks


def on() -> bool:
    """Whether tracing is on: inside `tracing()`, or while a torch profiler
    records."""
    return bool(_switch or _autograd_profiler._is_profiler_enabled)


def _hook_profiler_start() -> None:
    """Wraps torch's `_run_on_profiler_start`, so that a profiler's start
    begins a fresh stretch (unless the switch already has tracing on): two
    profiler windows with no span between them stay two stretches."""
    start = _autograd_profiler._run_on_profiler_start

    def run_on_profiler_start():
        start()
        if not _switch:
            REGISTRY.start_stretch()

    _autograd_profiler._run_on_profiler_start = run_on_profiler_start


_hook_profiler_start()


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Turns tracing on for the block (the operator's switch); the first
    block that turns it on starts a fresh stretch."""
    global _switch
    if not on():
        REGISTRY.start_stretch()
    _switch += 1
    try:
        yield
    finally:
        _switch -= 1


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "keep", "start", "child_ns", "id", "parent", "call", "stretch",
                 "range")

    def __init__(self, name: str, keep: bool):
        self.name, self.keep, self.child_ns, self.range = name, keep, 0, None

    def __enter__(self):
        REGISTRY.open(self)
        return self

    def __exit__(self, *exc):
        REGISTRY.close(self)
        return False


def span(name: str, keep: bool = False):
    """A span named `name` (`sbsim.<layer>.<part>`): recorded while tracing
    is on, and always with `keep` (set-up work). Off, the shared no-op."""
    if keep or _switch or _autograd_profiler._is_profiler_enabled:
        return _Span(name, keep)
    return _NOOP


def annotate(name: str):
    """Named region that shows up inside device traces: a span."""
    return span(name)


def count(name: str, n: float = 1) -> None:
    """Adds n to the stretch's counter `name` while tracing is on."""
    if _switch or _autograd_profiler._is_profiler_enabled:
        counters = REGISTRY.stretch().counters
        counters[name] = counters.get(name, 0) + n


def count_tensor(name: str, t: torch.Tensor) -> None:
    """Adds the sum of t's elements to the stretch's counter `name` while
    tracing is on; t is kept by reference and summed when read."""
    if _switch or _autograd_profiler._is_profiler_enabled:
        tensors = REGISTRY.stretch().tensors.setdefault(name, [])
        tensors.append(t)
        if len(tensors) >= FOLD:
            tensors[:] = [_fold(tensors)]


def family(prefix: str, keys=(), launches: bool = False) -> Dict[str, int]:
    """The set-up counters `<prefix>.<key>` as the registry's own dict (made
    with `keys` at zero the first time): counted whether tracing is on or
    off, and read through `setup()` and, as their change over the stretch,
    `snapshot()`. With `launches` they count what the device launches (a
    kernel module's launch counters): a captured program takes back what
    its capture added to them and adds it again at every replay
    (`launch_families`, graphs.py)."""
    values = REGISTRY.families.get(prefix)
    if values is None:
        values = REGISTRY.families[prefix] = dict.fromkeys(keys, 0)
        if launches:
            REGISTRY.launches.append(values)
    return values


def launch_families() -> Tuple[Dict[str, int], ...]:
    """The families made with `launches`, in the order they were made."""
    return tuple(REGISTRY.launches)


def replay_events():
    """A pair of CUDA timing events for the caller to record just before and
    just after a replay, while tracing is on by the switch and no profiler
    records (the profiler times the device itself); else None."""
    if not _switch or _autograd_profiler._is_profiler_enabled:
        return None
    pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    REGISTRY.stretch().events.append((torch.cuda.current_device(), pair))
    return pair


def snapshot() -> Dict[str, Any]:
    """The last stretch of tracing ({} before any): `spans` by name (count,
    total_us, self_us), `counters` (device tensors summed here, set-up
    counters as their change over the stretch), `records` (the ring), and
    with replay timing events `device` (replays, replay_ms, between_ms)."""
    return REGISTRY.snapshot()


def setup() -> Dict[str, Any]:
    """The set-up records since the process started: `spans`, `counters`
    (cumulative) and `records`."""
    return REGISTRY.setup()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Captures a profile of the host and, where a CUDA device is present,
    its kernels, written as `<host>_<pid>.<time>.pt.trace.json` under
    log_dir. The program's spans are on inside it."""
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
    """Accumulates host wall-time per named phase; each phase is also a span
    of its name."""

    def __init__(self):
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        """Times a phase; pass tensors (or a structure holding them) as
        block_on to include device time: their CUDA devices are
        synchronized before the clock stops."""
        with span(name):
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

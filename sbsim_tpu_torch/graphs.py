"""CUDA graphs: the port's counterpart of `jax.jit` at the JAX package's
call sites.

The JAX package runs its main path as compiled programs (the bench's
`jax.jit` over `lax.scan`, the trainer's jitted steps, the jitted
evaluation). PyTorch dispatches op by op, and at the port's batch sizes
the host's launches, not the kernels, set the step time. `capture(fn)`
returns a callable that, the first time it sees a shape of arguments,
warms `fn` up on a side stream and captures it into a
`torch.cuda.CUDAGraph`; every call after that copies the arguments into
the graph's static inputs and replays it, with no Python-side kernel
launch. The first call's results are the warm-up's (`fn` on the caller's
own arguments, as the eager call), so every call runs `fn` once on the
device. A replay runs the captured kernels in the captured order, so its
results are bitwise those of the eager call on the same inputs.

Aliasing rule. A replay copies the caller's argument tensors into private
static inputs and never writes the caller's tensors. Every output of a
replay is a fresh tensor, except an input buffer that `fn` updates in
place and returns (the replay ring's insert): that output is the graph's
static input buffer, updated in place at every replay, as the eager call
updates its input in place; passed back in, it is not copied. So a state
held from before a call does not change under it, except for such a
buffer, which the eager call shares and updates too. (The first call is
the eager call: it updates such a buffer of the caller's in place.) An
input that `fn` updates in place without returning it is refused at
capture.

Arguments are nested tuples, lists, dicts and dataclasses of tensors and
hashable constants. The constants are part of the program: a new value
captures a new program, and the outputs' constants are those of the
capture. Host scalars that change from call to call (a step count, a
gate) stay outside `fn`, as a jitted program's static arguments select
among programs.

When no argument tensor lies on a CUDA device (the caller asked for the
CPU), the callable calls `fn` directly, and so does every call inside
`disabled()` (the port's `jax.disable_jit`: a run that must go op by op
asks for it, such as a run of the kernels' plain versions, which read the
device back), and every call of a function captured with `op_by_op` (one
that by its caller's stated rule cannot be captured: a step through a
plain solver, whose loop reads the device back, or through a gloo
group's collectives, which go through the host). The callable's `eager`
is `fn`, op by op. On the card a failed capture or replay raises; nothing
runs eagerly in its place.

A graph reads everything outside its inputs by address (constants, the
stencil planes, a communicator's buffers): what a step caches must live as
long as the program, and `release` drops every program before a process
group goes (`distributed/runtime.shutdown`). A graph may not be destroyed
while a stream captures: a program freed during a capture keeps its graph
until the capture ends.

`fn` must not read a device value back to the host, nor make a tensor
from host data on each call (neither can be captured, and the host data
would be gone at replay): device constants come from `constant`, built
once per device.

Launch counts: the kernels' wrappers add to Python counters where they
launch (the tracing registry's families of device launches,
`profiling.family(..., launches=True)`: `fdm.launches`, `rng.launches`
and `fdm.swap_groups`). A capture moves the counters without a launch on
the device, and a replay launches without moving them. So the program
takes back what its capture added and adds it again at every replay: the
counters count launches on the device (the first call's, the warm-up's,
included).

Tracing (utils/profiling.py). A capture is the span `sbsim.graphs.capture`
and adds to the set-up counters `graphs.captures` and `graphs.pool_bytes`
(the device memory its graph keeps), whether tracing is on or off. While
tracing is on, a call is the span `sbsim.graphs.call`, with the children
`sbsim.graphs.key` (the argument tree flattened and its program looked
up), `.copy_in`, `.replay` (the replay's enqueue) and `.copy_out`, and
each replay adds to `graphs.kernel_nodes` the kernel, memcpy and memset
nodes of its graph (counted once, from the graph, at capture). The copies
the call issues itself, outside the graph, are not counted. With the
operator's switch and no profiler, CUDA timing events go just before and
after each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import weakref
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from sbsim_tpu_torch.utils import profiling


_disabled = False
_live: "weakref.WeakSet[CapturedFunction]" = weakref.WeakSet()
# The tracing registry's set-up counters `graphs.captures` and
# `graphs.pool_bytes`.
_SETUP = profiling.family("graphs", ("captures", "pool_bytes"))


@contextlib.contextmanager
def disabled():
    """Within the block every captured function calls its function directly,
    op by op, and captures nothing (the port's `jax.disable_jit`)."""
    global _disabled
    saved, _disabled = _disabled, True
    try:
        yield
    finally:
        _disabled = saved


@functools.lru_cache(maxsize=None)
def _constant(key: Tuple[str, str], dtype: torch.dtype, device: torch.device,
              value) -> torch.Tensor:
    del key
    return torch.tensor(value, dtype=dtype, device=device)


def constant(value, dtype: torch.dtype, device) -> torch.Tensor:
    """The 0-d tensor `torch.tensor(value, dtype=dtype, device=device)`,
    made once per value, type and device and shared by every caller: a
    device constant that a captured program may read. Never write it."""
    # repr keeps -0.0 and 0.0 (equal, and hashed alike) apart.
    return _constant((type(value).__name__, repr(value)), dtype, torch.device(device),
                     value)


# ---------------------------------------------------------------------------
# Argument trees
# ---------------------------------------------------------------------------

_TENSOR = ("tensor",)


def flatten(x, leaves: List[torch.Tensor]):
    """Appends x's tensors to `leaves` in order; returns x's structure
    (hashable), its constants included. `unflatten` inverts it."""
    if torch.is_tensor(x):
        leaves.append(x)
        return _TENSOR
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return ("dataclass", type(x), names,
                tuple(flatten(getattr(x, n), leaves) for n in names))
    if isinstance(x, (tuple, list)):
        kind = type(x) if hasattr(x, "_fields") else type(x).__name__
        return ("seq", kind, tuple(flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(x)
        return ("dict", keys, tuple(flatten(x[k], leaves) for k in keys))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"a captured program's argument {type(x).__name__} is neither "
                        "a tensor nor a hashable constant") from None
    return ("const", x)


def unflatten(spec, leaves) -> Any:
    """The tree of `spec` (from flatten) with its tensors drawn in order
    from the iterator `leaves`."""
    kind = spec[0]
    if kind == "tensor":
        return next(leaves)
    if kind == "dataclass":
        _, cls, names, children = spec
        return cls(**{n: unflatten(c, leaves) for n, c in zip(names, children)})
    if kind == "seq":
        _, seq, children = spec
        values = [unflatten(c, leaves) for c in children]
        if isinstance(seq, type):  # a namedtuple
            return seq(*values)
        return tuple(values) if seq == "tuple" else values
    if kind == "dict":
        _, keys, children = spec
        return {k: unflatten(c, leaves) for k, c in zip(keys, children)}
    return spec[1]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree) -> Any:
    """`tree` with each tensor t replaced by fn(t) (`tree_map(torch.clone,
    state)` copies a state)."""
    leaves: List[torch.Tensor] = []
    spec = flatten(tree, leaves)
    return unflatten(spec, iter([fn(t) for t in leaves]))


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _copy(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """dst[i].copy_(src[i]), one multi-tensor copy per dtype."""
    for idx in _by_dtype(dst).values():
        torch._foreach_copy_([dst[i] for i in idx], [src[i] for i in idx])


# CUgraphNodeType (cuda.h): the nodes that run on the device, and a child
# graph, whose nodes count as its parent's.
_DEVICE_NODES = (0, 1, 2)  # kernel, memcpy, memset
_CHILD_GRAPH = 4


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    ptr, size, out = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER
    lib.cuGraphGetNodes.argtypes = [ptr, out(ptr), out(size)]
    lib.cuGraphNodeGetType.argtypes = [ptr, out(ctypes.c_int)]
    lib.cuGraphChildGraphNodeGetGraph.argtypes = [ptr, out(ptr)]
    for fn in (lib.cuGraphGetNodes, lib.cuGraphNodeGetType, lib.cuGraphChildGraphNodeGetGraph):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA driver error {err}")


def _device_nodes(graph: int) -> int:
    """The kernel, memcpy and memset nodes of a CUDA graph (a `cudaGraph_t`
    as an integer), child graphs' included: the operations one launch of
    it runs on the device."""
    lib = _libcuda()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    total, kind = 0, ctypes.c_int()
    for node in nodes[:n.value]:
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value in _DEVICE_NODES:
            total += 1
        elif kind.value == _CHILD_GRAPH:
            child = ctypes.c_void_p()
            _check(lib.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
            total += _device_nodes(child.value)
    return total


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


class _CudaGraphs:
    """The torch.cuda pieces a capture uses (tests stand a stub in)."""

    capture = torch.cuda.graph
    device = torch.cuda.device

    @staticmethod
    def new_graph():
        """A graph that keeps its `cudaGraph_t` after capture, so that
        `instantiate` can count its nodes."""
        return torch.cuda.CUDAGraph(keep_graph=True)

    @staticmethod
    def instantiate(graph) -> int:
        """Instantiates a captured graph; returns its device operations
        (`_device_nodes`)."""
        nodes = _device_nodes(graph.raw_cuda_graph())
        graph.instantiate()
        return nodes

    @staticmethod
    def reserved(device) -> int:
        """Bytes the caching allocator holds on `device`, its free cached
        blocks released first (as torch.cuda.graph's capture does)."""
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(device)

    @staticmethod
    @contextlib.contextmanager
    def side_stream(device):
        """Runs the body on a side stream, after the current stream's work
        and before what the current stream does next (the warm-up)."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            yield
        torch.cuda.current_stream(device).wait_stream(side)


# Graphs of programs freed while a capture is open, kept until it closes.
_capturing = 0
_deferred: List[Any] = []


def _drop_graph(graph) -> None:
    """A freed program's graph: kept while a capture is open (destroying a
    graph while a stream captures invalidates the capture), else let go."""
    if _capturing:
        _deferred.append(graph)


@contextlib.contextmanager
def _capture_open():
    """The block of a capture. Python's cyclic collector is held off (a
    collection could free an unreachable program), and the graph of any
    program freed in the block, by the collector or by its last reference,
    is destroyed only after the block (`_drop_graph`)."""
    global _capturing
    enabled = gc.isenabled()
    gc.disable()
    _capturing += 1
    try:
        yield
    finally:
        _capturing -= 1
        if enabled:
            gc.enable()
        if not _capturing:
            _deferred.clear()


class Program:
    """One captured shape of a function: its graph, static inputs and
    outputs, the launch counts that one replay makes, and `nodes`, the
    device operations of its graph. `first` holds the warm-up's results
    (the first call's) until `take_first`. The capture (warm-up included)
    is the set-up span `sbsim.graphs.capture`; the device memory it kept
    (the graph's private pool, static outputs included) goes to the set-up
    counter `graphs.pool_bytes`."""

    def __init__(self, fn: Callable, args: tuple, spec, leaves: Sequence[torch.Tensor],
                 counters: Sequence[Dict[str, int]], api=_CudaGraphs):
        device = leaves[0].device
        self._counters = counters
        with profiling.span("sbsim.graphs.capture", keep=True), api.device(device):
            # Copied before the warm-up, which may update its inputs in place.
            self.static_in = [torch.empty_like(t) for t in leaves]
            _copy(self.static_in, leaves)
            with api.side_stream(device):
                self.first = fn(*args)
            before = [dict(c) for c in counters]
            versions = [t._version for t in self.static_in]
            reserved = api.reserved(device)
            self.graph = api.new_graph()
            weakref.finalize(self, _drop_graph, self.graph).atexit = False
            with _capture_open(), api.capture(self.graph):
                out = fn(*unflatten(spec, iter(self.static_in)))
            _SETUP["pool_bytes"] += api.reserved(device) - reserved
            self.nodes = api.instantiate(self.graph)
        _SETUP["captures"] += 1
        # What the capture added is what one replay launches; the capture
        # itself launched nothing on the device.
        self.per_replay = []
        for c, b in zip(counters, before):
            delta = {k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
            c.update(b)
            self.per_replay.append(delta)
        self.replays = 0
        out_leaves: List[torch.Tensor] = []
        self._out_spec = flatten(out, out_leaves)
        self.static_out = out_leaves
        updated = {id(t) for t, v in zip(self.static_in, versions) if t._version != v}
        returned = {id(t) for t in out_leaves}
        if updated - returned:
            raise ValueError("the captured function updates an input in place without "
                             "returning it; the caller would not see the update")
        # Outputs that are in-place-updated input buffers are handed out as
        # they are; every other output is copied into a fresh tensor.
        self._fresh = [i for i, t in enumerate(out_leaves) if id(t) not in updated]

    def take_first(self):
        first, self.first = self.first, None
        return first

    def __call__(self, leaves: Sequence[torch.Tensor]):
        with profiling.span("sbsim.graphs.copy_in"):
            todo = [i for i, (s, t) in enumerate(zip(self.static_in, leaves)) if s is not t]
            _copy([self.static_in[i] for i in todo], [leaves[i] for i in todo])
        events = profiling.replay_events()
        if events is not None:
            events[0].record()
        with profiling.span("sbsim.graphs.replay"):
            self.graph.replay()
        if events is not None:
            events[1].record()
        self.replays += 1
        for c, delta in zip(self._counters, self.per_replay):
            for k, n in delta.items():
                c[k] += n
        with profiling.span("sbsim.graphs.copy_out"):
            out = list(self.static_out)
            fresh = [torch.empty_like(out[i]) for i in self._fresh]
            _copy(fresh, [out[i] for i in self._fresh])
            for i, t in zip(self._fresh, fresh):
                out[i] = t
        profiling.count("graphs.kernel_nodes", self.nodes)
        return unflatten(self._out_spec, iter(out))


class CapturedFunction:
    """`fn` captured once per argument shape (see the module docstring).
    `eager` is `fn` op by op; `programs` maps each argument signature to
    its Program."""

    def __init__(self, fn: Callable, op_by_op: bool = False):
        functools.update_wrapper(self, fn)
        self.eager = fn
        self.op_by_op = op_by_op
        self.programs: Dict[Any, Program] = {}
        _live.add(self)

    @property
    def counters(self) -> Tuple[Dict[str, int], ...]:
        """The counters a program follows: the registry's families of device
        launches (profiling.launch_families), whichever modules made them."""
        return profiling.launch_families()

    def __call__(self, *args):
        with profiling.span("sbsim.graphs.call"):
            with profiling.span("sbsim.graphs.key"):
                leaves: List[torch.Tensor] = []
                spec = flatten(args, leaves)
                devices = {t.device for t in leaves}
                direct = (_disabled or self.op_by_op
                          or not any(d.type == "cuda" for d in devices))
                if not direct:
                    if len(devices) > 1:
                        raise ValueError("a captured program's tensors must lie on one "
                                         f"device; got {sorted(map(str, devices))}")
                    key = (spec, tuple((t.shape, t.dtype) for t in leaves), devices.pop())
                    program = self.programs.get(key)
            if direct:
                return self.eager(*args)
            if program is None:
                program = self.programs[key] = Program(self.eager, args, spec, leaves,
                                                       self.counters)
                return program.take_first()
            return program(leaves)


def release() -> None:
    """Drops every captured program, its graph destroyed; the next call of a
    captured function captures again. A program whose graph holds a process
    group's collectives must go before the group does
    (`distributed/runtime.shutdown` calls this first): destroying an NCCL
    group while such a graph lived hung both ranks of a two-card job
    (H100, PyTorch 2.11)."""
    programs = [p for captured in list(_live) for p in captured.programs.values()]
    if programs and torch.cuda.is_available():
        torch.cuda.synchronize()
    for captured in list(_live):
        for program in captured.programs.values():
            program.graph.reset()
        captured.programs.clear()


def capture(fn: Callable, op_by_op: bool = False) -> CapturedFunction:
    """`fn` as a captured program, the port's `jax.jit`, or with `op_by_op`
    called directly at every call (the module docstring has the rules)."""
    return CapturedFunction(fn, op_by_op)

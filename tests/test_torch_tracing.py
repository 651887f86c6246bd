"""The port's tracing system (sbsim_tpu_torch/utils/profiling.py) and its
spans and counters at the layer boundaries, on the CPU.

* On and off: off, a span is the shared no-op, records nothing and opens no
  profiler range, and a counter counts nothing; a `keep` span is a set-up
  record either way.
* Spans nest: parent, call id (the outermost span's), self time (the total
  less what children cover), per-name aggregates.
* Each time tracing turns on (the switch, or a profiler's start) a fresh
  stretch starts; `snapshot()` returns the last one.
* Under a CPU torch.profiler window every span is a FUNCTION-scope (0)
  event of its name, and the window holds no USER_SCOPE event.
* `count_tensor` keeps tensors by reference and folds them in bulk.
* `graphs.Program` with a stub graph of a given node count: captures and
  pool bytes as set-up counters, replays, kernel nodes per replay, the
  timing events' device times; a graph's device nodes counted through a
  stub libcuda (child graphs included); the launch counts are the
  registry's family `fdm.launches`.
* The layers' spans: the env step's phases, the host control loop, the
  trainer and the learner; `fdm.iterations` over `make_rollout` calls
  equals the returned states' iterations.
"""

import contextlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sbsim_tpu_torch import bench, graphs, rng
from sbsim_tpu_torch.agents import schedule_policy, train
from sbsim_tpu_torch.envs import building_env, presets
from sbsim_tpu_torch.physics import fdm_cuda
from sbsim_tpu_torch.utils import profiling

FUNCTION_SCOPE, USER_SCOPE = 0, 7


@pytest.fixture(scope="module")
def env():
    return building_env.BuildingEnv(presets.two_zone_test_config(), device="cpu")


def _names(snap):
    return {r.name for r in snap["records"]}


def _by_name(snap):
    return {r.name: r for r in snap["records"]}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_off_records_nothing_and_opens_no_profiler_range(monkeypatch):
    class Refused:
        def __init__(self, name):
            raise AssertionError(f"a profiler range was opened for {name}")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", Refused)
    with profiling.tracing():
        profiling.count("before", 1)
    before = profiling.snapshot()
    setup_before = len(profiling.setup()["records"])
    assert not profiling.on()
    assert profiling.span("sbsim.test.off") is profiling.span("sbsim.test.other")
    with profiling.span("sbsim.test.off"):
        profiling.count("sbsim.test.counter", 3)
        profiling.count_tensor("sbsim.test.tensor", torch.ones(2))
    after = profiling.snapshot()
    assert after["counters"] == before["counters"] and after["records"] == before["records"]
    assert len(profiling.setup()["records"]) == setup_before
    # A set-up span is kept while tracing is off, outside the stretch.
    with profiling.span("sbsim.test.setup", keep=True):
        pass
    assert profiling.setup()["records"][-1].name == "sbsim.test.setup"
    assert "sbsim.test.setup" not in _names(profiling.snapshot())
    # With the switch on and no profiler, still no profiler range.
    with profiling.tracing():
        with profiling.span("sbsim.test.on"):
            pass
    assert _names(profiling.snapshot()) == {"sbsim.test.on"}


def test_spans_nest_with_parent_call_and_self_time(monkeypatch):
    ticks = iter(range(0, 10**9, 1000))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("sbsim.test.call"):
                with profiling.span("sbsim.test.a"):
                    with profiling.span("sbsim.test.leaf"):
                        pass
                with profiling.span("sbsim.test.b"):
                    pass
    snap = profiling.snapshot()
    records = snap["records"]
    calls = [r for r in records if r.name == "sbsim.test.call"]
    assert len(calls) == 2 and all(r.parent is None and r.call == r.id for r in calls)
    for r in records:
        owner = [c for c in calls if c.start_ns <= r.start_ns and r.end_ns <= c.end_ns]
        assert [r.call] == [c.id for c in owner]
    ids = {r.id: r for r in records}
    leaf = [r for r in records if r.name == "sbsim.test.leaf"]
    assert all(ids[r.parent].name == "sbsim.test.a" for r in leaf)
    # Each span opens and closes on one tick each (1 us apart): a leaf
    # lasts 1 us, a span with children lasts its children plus 1 us per
    # own edge pair.
    spans = snap["spans"]
    assert spans["sbsim.test.leaf"] == {"count": 2, "total_us": 2.0, "self_us": 2.0}
    assert spans["sbsim.test.a"] == {"count": 2, "total_us": 6.0, "self_us": 4.0}
    assert spans["sbsim.test.b"] == {"count": 2, "total_us": 2.0, "self_us": 2.0}
    call = spans["sbsim.test.call"]
    assert call["count"] == 2 and call["self_us"] == call["total_us"] - 6.0 - 2.0


@pytest.mark.parametrize("switch", ["tracing", "profiler"])
def test_each_turn_on_starts_a_fresh_stretch(switch):
    def stretch(n):
        on = profiling.tracing() if switch == "tracing" else _cpu_profile()
        with on:
            for _ in range(n):
                with profiling.span("sbsim.test.step"):
                    profiling.count("sbsim.test.steps")

    stretch(3)
    first = profiling.snapshot()
    stretch(2)  # nothing of the program runs between the two
    second = profiling.snapshot()
    assert first["spans"]["sbsim.test.step"]["count"] == 3
    assert second["spans"]["sbsim.test.step"]["count"] == 2
    assert second["counters"] == {"sbsim.test.steps": 2}
    assert second["start_ns"] > first["start_ns"]
    # The last stretch stays readable after tracing turns off.
    assert profiling.snapshot()["counters"] == second["counters"]


def test_a_profiler_inside_the_switch_keeps_its_stretch():
    with profiling.tracing():
        with profiling.span("sbsim.test.before"):
            pass
        with _cpu_profile():
            with profiling.span("sbsim.test.inside"):
                pass
    assert _names(profiling.snapshot()) == {"sbsim.test.before", "sbsim.test.inside"}


def test_profiler_window_holds_each_span_as_a_function_scope_event():
    names = ("sbsim.test.outer", "sbsim.test.inner", "sbsim.test.phase", "sbsim.test.annotated")
    timer = profiling.PhaseTimer()
    with _cpu_profile() as prof:
        with profiling.span(names[0]):
            with profiling.span(names[1]):
                torch.ones(8).cumsum(0)
        with timer.phase(names[2]):
            torch.ones(8) + 1
        with profiling.annotate(names[3]):
            torch.ones(8) * 2
    events = prof.events()
    ours = [e for e in events if e.name.startswith("sbsim.")]
    assert sorted(e.name for e in ours) == sorted(names)
    assert all(e.scope == FUNCTION_SCOPE for e in ours)
    assert not [e.name for e in events if e.scope == USER_SCOPE]
    assert _names(profiling.snapshot()) == set(names)
    assert timer.summary()[names[2]]["calls"] == 1


def test_count_tensor_sums_when_read_and_folds_in_bulk(monkeypatch):
    monkeypatch.setattr(profiling, "FOLD", 3)
    values = [torch.arange(4, dtype=torch.int32) * k for k in range(8)]
    with profiling.tracing():
        for v in values:
            profiling.count_tensor("sbsim.test.iters", v)
        held = profiling.REGISTRY.stretch().tensors["sbsim.test.iters"]
        assert len(held) < 3 and held[-1] is values[-1]  # the newest kept by reference
        profiling.count_tensor("sbsim.test.temps", torch.tensor([0.5, 0.25]))
    counters = profiling.snapshot()["counters"]
    assert counters["sbsim.test.iters"] == int(sum(int(v.sum()) for v in values))
    assert counters["sbsim.test.temps"] == 0.75


# ---------------------------------------------------------------------------
# Captured programs
# ---------------------------------------------------------------------------


class _StubGraph:
    def replay(self):
        pass

    def reset(self):
        pass


class _StubGraphs:
    """graphs._CudaGraphs on the CPU: a capture runs the function once, a
    graph has NODES device operations, and each capture keeps 64 bytes."""

    NODES = 11
    reserved_bytes = 0

    @staticmethod
    def new_graph():
        return _StubGraph()

    @staticmethod
    def capture(graph):
        return contextlib.nullcontext()

    @staticmethod
    def device(device):
        return contextlib.nullcontext()

    @staticmethod
    def side_stream(device):
        return contextlib.nullcontext()

    @classmethod
    def reserved(cls, device):
        cls.reserved_bytes += 32
        return cls.reserved_bytes

    @classmethod
    def instantiate(cls, graph):
        return cls.NODES


class _Event:
    """A CUDA timing event on a host clock of whole milliseconds."""

    clock = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        _Event.clock += 1
        self.t = _Event.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def _fn(x, k):
    # One float and one int output: two dtype groups each way.
    return x * 2.0, k + 1


def _program():
    counts = {"fdm_jacobi": 0}
    args = (torch.ones(3), torch.zeros(2, dtype=torch.int32))
    leaves = []
    spec = graphs.flatten(args, leaves)
    return graphs.Program(_fn, args, spec, leaves, (counts,), api=_StubGraphs), leaves


def test_program_counts_captures_replays_nodes_and_copies(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    setup0 = profiling.setup()["counters"]
    with profiling.tracing():
        program, leaves = _program()
        for _ in range(4):
            program(leaves)
    snap = profiling.snapshot()
    setup1 = profiling.setup()["counters"]
    assert program.nodes == _StubGraphs.NODES
    assert not hasattr(program, "capture_ms") and not hasattr(program, "pool_bytes")
    assert setup1["graphs.captures"] - setup0.get("graphs.captures", 0) == 1
    assert setup1["graphs.pool_bytes"] - setup0.get("graphs.pool_bytes", 0) == 32
    assert profiling.setup()["records"][-1].name == "sbsim.graphs.capture"
    c = snap["counters"]
    assert c["graphs.captures"] == 1 and c["graphs.pool_bytes"] == 32
    assert program.replays == 4
    assert c["graphs.kernel_nodes"] == 4 * _StubGraphs.NODES
    spans = snap["spans"]
    for name in ("sbsim.graphs.copy_in", "sbsim.graphs.replay", "sbsim.graphs.copy_out"):
        assert spans[name]["count"] == 4
    # Each replay's events are one tick apart and the next replay's start
    # one tick after: 1 ms inside each of 4 replays, 1 ms between each pair.
    assert snap["device"] == {"replays": 4, "replay_ms": 4.0, "between_ms": 3.0}


class _StubLibcuda:
    """libcuda's graph queries over `graphs`: graph -> [(node,
    CUgraphNodeType)], with `children`: node -> child graph."""

    def __init__(self, graphs_, children):
        self.graphs, self.children = graphs_, children

    def cuGraphGetNodes(self, graph, nodes, n):
        listed = self.graphs[graph]
        if nodes is not None:
            for i, (node, _) in enumerate(listed):
                nodes[i] = node
        n._obj.value = len(listed)
        return 0

    def cuGraphNodeGetType(self, node, kind):
        kind._obj.value = dict(sum(self.graphs.values(), []))[node]
        return 0

    def cuGraphChildGraphNodeGetGraph(self, node, child):
        child._obj.value = self.children[node]
        return 0


def test_device_nodes_count_kernels_copies_sets_and_child_graphs(monkeypatch):
    """Kernel (0), memcpy (1) and memset (2) nodes count, a child graph's
    (4) nodes count as its parent's, host (3), empty (5) and event nodes
    (6, 7) do not."""
    lib = _StubLibcuda({1: [(10, 0), (11, 1), (12, 4), (13, 3), (14, 5), (15, 7)],
                          2: [(20, 2), (21, 0), (22, 6)]}, {12: 2})
    monkeypatch.setattr(graphs, "_libcuda", lambda: lib)
    assert graphs._device_nodes(2) == 2
    assert graphs._device_nodes(1) == 2 + 2


def test_program_takes_no_timing_events_under_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    program, leaves = _program()
    with profiling.tracing(), _cpu_profile():
        program(leaves)
    snap = profiling.snapshot()
    assert "device" not in snap and snap["counters"]["graphs.kernel_nodes"] == _StubGraphs.NODES
    with _cpu_profile():
        program(leaves)
    assert "device" not in profiling.snapshot()


def test_captured_call_is_a_span_with_its_key():
    captured = graphs.capture(lambda x: x + 1)
    with profiling.tracing():
        captured(torch.ones(2))  # on the CPU: called directly
    records = _by_name(profiling.snapshot())
    assert records["sbsim.graphs.key"].parent == records["sbsim.graphs.call"].id


def test_launch_counts_are_the_registry_family():
    assert fdm_cuda.launch_counts is profiling.family("fdm.launches")
    with profiling.tracing():
        fdm_cuda.launch_counts["fdm_cheby"] += 2
        fdm_cuda.launch_counts["fdm_cheby"] -= 2
        fdm_cuda.launch_counts["fdm_jacobi"] += 3
    assert profiling.snapshot()["counters"] == {"fdm.launches.fdm_jacobi": 3}
    total = profiling.setup()["counters"]["fdm.launches.fdm_jacobi"]
    assert total == fdm_cuda.launch_counts["fdm_jacobi"]
    fdm_cuda.reset_launch_counts()
    assert fdm_cuda.launch_counts == dict.fromkeys(fdm_cuda.launch_counts, 0)


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------


def test_rollout_counts_the_returned_fdm_iterations(env):
    actions = schedule_policy.build_schedule_actions(env)
    roll = bench.make_rollout(env, actions, 2, "xla_jacobi")
    states, _ = env.reset(rng.split(rng.PRNGKey(3), 3))
    iterations = 0
    with profiling.tracing():
        for _ in range(3):
            states, _ = roll(states)
            iterations += int(states.fdm_iterations.sum())
    counters = profiling.snapshot()["counters"]
    assert iterations > 0
    assert counters["fdm.iterations"] == iterations and counters["env.steps"] == 3 * 3


def test_env_step_phases_are_children_of_the_step(env):
    states, _ = env.reset(rng.split(rng.PRNGKey(1), 2))
    actions = torch.zeros(2, env.n_actions)
    with profiling.tracing():
        env.step_batched(states, actions, solver="xla_jacobi")
    snap = profiling.snapshot()
    records = _by_name(snap)
    step = records["sbsim.env.step"]
    phases = {"sbsim.env.control", "sbsim.env.fdm", "sbsim.env.stats", "sbsim.env.post"}
    if env.convection.enabled:
        phases.add("sbsim.env.convect")
    assert {r.name for r in snap["records"] if r.parent == step.id} == phases
    assert step.parent is None and step.call == step.id


def test_host_step_spans(env):
    from sbsim_tpu_torch.envs.host_adapter import SimulatedBuilding
    from sbsim_tpu_torch.envs.host_environment import HostEnvironment

    host = HostEnvironment(SimulatedBuilding(env, seed=0), env)
    host.reset()
    with profiling.tracing():
        host.step(np.zeros(env.n_actions, np.float32))
    snap = profiling.snapshot()
    step = _by_name(snap)["sbsim.host.step"]
    children = {r.name for r in snap["records"] if r.parent == step.id}
    assert children == {"sbsim.host.request", "sbsim.host.env", "sbsim.host.observe",
                        "sbsim.host.record"}
    assert "sbsim.env.step" in {r.name for r in snap["records"] if r.call == step.id}


def test_train_step_spans_and_counters(env):
    trainer = train.SACTrainer(env, train.recipe_for(env, n_envs=2, batch_size=4,
                                                     replay_capacity=40, seed_steps=0))
    state = trainer.init(rng.PRNGKey(0))
    step = trainer.captured_train_step()
    with profiling.tracing():
        state, _ = step(state)
    snap = profiling.snapshot()
    records = snap["records"]
    ids = {r.id: r for r in records}
    parent = lambda name: {ids[r.parent].name for r in records if r.name == name}
    assert parent("sbsim.graphs.call") == {"sbsim.train.step"}
    assert parent("sbsim.train.collect") == parent("sbsim.train.update") == {"sbsim.graphs.call"}
    assert parent("sbsim.train.reset") == {"sbsim.train.collect"}
    assert parent("sbsim.env.step") == {"sbsim.train.collect"}
    for part in ("sample", "critic", "actor", "alpha", "target"):
        assert parent(f"sbsim.sac.{part}") == {"sbsim.train.update"}
    # FDM work is counted at the rollout's call alone.
    assert "env.steps" not in snap["counters"] and "fdm.iterations" not in snap["counters"]


def test_every_span_is_named_by_layer():
    """Every span the layers open is named sbsim.<layer>.<part>."""
    import pathlib
    import re

    root = pathlib.Path(building_env.__file__).parents[1]
    names = set()
    for path in root.rglob("*.py"):
        names |= set(re.findall(r'profiling\.span\("([^"]+)"', path.read_text()))
    assert names and all(re.fullmatch(r"sbsim\.[a-z]+\.[a-z_]+", n) for n in names)

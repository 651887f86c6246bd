"""Captured programs (sbsim_tpu_torch/graphs.py) and what makes the main
path capturable, on the CPU.

* `_maybe_reset` is a masked select that always draws the reset: bitwise
  the old branch (reset only when some env is done) with no env done,
  some and all; and the trainer's seeding `collect_step` against the JAX
  trainer's (its `_maybe_reset` a lax.cond) from the same converted
  TrainState on the sb1 1-day plan at n_envs 8, two steps from before the
  288-step end with none, some and all envs crossing it: keys, step
  counts, windows, occupants, replay cursors and the reset envs' fresh
  fields (temperatures, zone means, diffuser heat) exact, the stepped
  temperatures and zone means within FIELD_ATOL (one solve, XLA:CPU
  contracts FMAs; tests/test_torch_env.py), observations and rewards
  within OUT_ATOL.
* Sync-free: with Tensor.__bool__/__float__/__int__, .item, .tolist,
  .cpu, .numpy and torch.tensor / torch.as_tensor of host data patched to
  raise, `step_batched` (K1's and K2's plain routes, the plain kernel
  itself unguarded: its loop reads back by design and is never captured),
  `reset`, the seeding `collect_step`, `train_step` on both sides of the
  update gate and `evaluate` run through, after one warm-up call (which
  makes the device constants, as a capture's warm-up does).
* The wrapper: on CPU tensors it returns the function's own results; with
  a stub graph on the CPU, the first call returns the warm-up's results,
  the launch counters move once per call (the capture's additions taken
  back, re-added per replay), and so does every family registered as
  device launches, which a captured function hands its programs, a replay leaves the caller's tensors alone,
  hands out fresh outputs but for the in-place-updated buffer it returns,
  and takes that buffer back without a copy; an input updated in place
  and not returned is refused; the cyclic collector is held off during a
  capture alone, and a program freed during a capture keeps its graph
  until the capture ends; argument trees round-trip; constants are cached
  per value and device.

The graphs' card twins (replays bitwise the eager calls, under
torch.cuda.set_sync_debug_mode("error")) are in tests/test_torch_cuda.py.
"""

import contextlib
import dataclasses
import gc
import weakref

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from sbsim_tpu.agents import schedule_policy as jsched
from sbsim_tpu.agents import train as jtrain
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu_torch import convert, graphs, rng
from sbsim_tpu_torch.agents import schedule_policy as tsched
from sbsim_tpu_torch.agents import train as ttrain
from sbsim_tpu_torch.agents.replay import Transition
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.physics import fdm_cuda

FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_env.py)
OUT_ATOL = 1e-4
N_ENVS = 8
EPISODE = 288
EXACT = ("rng", "occupants", "step_idx", "window", "fdm_iterations", "fdm_converged")


def _tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


# ---------------------------------------------------------------------------
# _maybe_reset
# ---------------------------------------------------------------------------


def _old_maybe_reset(trainer, env_states, obs, done, key):
    """The branch `_maybe_reset` replaced: nothing unless some env is done."""
    if not bool(done.any()):
        return env_states, obs
    fresh_states, fresh_obs = trainer.env.reset(rng.split(key, trainer.config.n_envs))
    return (ttrain._select(done, fresh_states, env_states),
            ttrain._select(done, fresh_obs, obs))


@pytest.fixture(scope="module")
def two_zone_trainer():
    env = tbe.BuildingEnv(tpresets.two_zone_test_config(occupancy_kind="randomized"),
                          device="cpu")
    return ttrain.SACTrainer(env, ttrain.TrainConfig(n_envs=4, batch_size=4))


@pytest.mark.parametrize("mask", [(0, 0, 0, 0), (1, 0, 0, 1), (1, 1, 1, 1)],
                         ids=["none_done", "some_done", "all_done"])
def test_masked_reset_equals_the_old_branch(two_zone_trainer, mask):
    tr = two_zone_trainer
    state = tr.init(rng.PRNGKey(0))
    stepped, out = tr.env.step_batched(state.env_states,
                                       torch.zeros(4, tr.env.n_actions))
    done = torch.tensor(mask, dtype=torch.bool)
    got, got_obs = tr._maybe_reset(stepped, out.observation, done, rng.PRNGKey(9))
    want, want_obs = _old_maybe_reset(tr, stepped, out.observation, done, rng.PRNGKey(9))
    assert torch.equal(got_obs, want_obs)
    want = dict(_flat(convert.env_state_to_numpy(want)))
    for key, value in _flat(convert.env_state_to_numpy(got)):
        np.testing.assert_array_equal(value, want[key], err_msg=key)


@pytest.fixture(scope="module")
def sb1_pair():
    kw = dict(n_envs=N_ENVS, batch_size=N_ENVS, replay_capacity=64, seed_steps=0,
              env_solver="xla_jacobi")
    jenv = jbe.BuildingEnv(jpresets.sb1_config(num_days_in_episode=1))
    tenv = tbe.BuildingEnv(tpresets.sb1_config(num_days_in_episode=1), device="cpu")
    jt = jtrain.SACTrainer(jenv, jtrain.recipe_for(jenv, **kw))
    tt = ttrain.SACTrainer(tenv, ttrain.recipe_for(tenv, **kw))
    jstate = jax.jit(jt.init)(jax.random.PRNGKey(5))
    table = jsched.build_schedule_actions(jenv)
    np.testing.assert_array_equal(tsched.build_schedule_actions(tenv), table)
    return jt, tt, jstate, table


@pytest.mark.parametrize("crossing", [(), (0, 3, 6), tuple(range(N_ENVS))],
                         ids=["none_done", "some_done", "all_done"])
def test_seeding_across_the_episode_end_matches_jax(sb1_pair, crossing):
    """Two seeding collect steps from step 287 (envs in `crossing`; the
    others from step 100): those envs are done at the first step's end
    (the 288th step) and reset inside the collect step."""
    jt, tt, jstate, table = sb1_pair
    start = np.full(N_ENVS, 100, np.int32)
    start[list(crossing)] = EPISODE - 1
    jstate = jstate.replace(env_states=jstate.env_states.replace(
        step_idx=jax.numpy.asarray(start)))
    tstate = convert.train_state_from_numpy(_tree(jstate), tt)
    jstep = jax.jit(jt.seed_with_actions(jstate, table))
    tstep = tt.seed_with_actions(tstate, table)
    for step in range(2):
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        want = dict(_flat(_tree(jstate)))
        got = dict(_flat(convert.train_state_to_numpy(tstate, tt)))
        for key in ("rng", "env_steps", "replay.insert_index", "replay.size"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"step {step} {key}")
        for name in EXACT:
            key = "env_states." + name
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"step {step} {key}")
        # At the first step's end the crossing envs are fresh: their fields
        # are the reset's, exactly.
        rows = list(crossing) if step == 0 else []
        for key in ("env_states.temp", "env_states.zone_means", "env_states.input_q"):
            np.testing.assert_array_equal(got[key][rows], want[key][rows], err_msg=key)
        for key in ("env_states.temp", "env_states.zone_means"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=FIELD_ATOL,
                                       err_msg=f"step {step} {key}")
        np.testing.assert_allclose(got["last_obs"], want["last_obs"], rtol=0, atol=OUT_ATOL)
        np.testing.assert_allclose(float(tm["reward_mean"]), float(jm["reward_mean"]),
                                   rtol=0, atol=OUT_ATOL)
    expect = np.where(np.isin(np.arange(N_ENVS), crossing), 1, 102)
    np.testing.assert_array_equal(tstate.env_states.step_idx.numpy(), expect)


# ---------------------------------------------------------------------------
# Sync-free steps
# ---------------------------------------------------------------------------

_GUARDED = ("__bool__", "__float__", "__int__", "item", "tolist", "cpu", "numpy")


class SyncGuard:
    """While `on`, every host read of a tensor and every tensor made from
    host data raises: what a CUDA graph cannot capture (a read waits for
    the device; a pageable host-to-device copy synchronises, and its host
    buffer would be gone at replay)."""

    def __init__(self, monkeypatch):
        self.on = False
        for name in _GUARDED:
            monkeypatch.setattr(torch.Tensor, name, self._tripwire(name,
                                                                   getattr(torch.Tensor, name)))
        tensor, as_tensor = torch.tensor, torch.as_tensor

        def guarded_tensor(data, *args, **kwargs):
            self._check("torch.tensor")
            return tensor(data, *args, **kwargs)

        def guarded_as_tensor(data, *args, **kwargs):
            if not torch.is_tensor(data):
                self._check("torch.as_tensor of host data")
            return as_tensor(data, *args, **kwargs)

        monkeypatch.setattr(torch, "tensor", guarded_tensor)
        monkeypatch.setattr(torch, "as_tensor", guarded_as_tensor)
        # The plain kernels' loops read back by design (they are the CPU
        # path, never captured): the guard covers everything around them.
        for name in ("fdm_jacobi_plain", "fdm_cheby_plain"):
            monkeypatch.setattr(fdm_cuda, name, self.unguarded(getattr(fdm_cuda, name)))

    def _check(self, what):
        if self.on:
            raise AssertionError(f"host sync inside a step: {what}")

    def _tripwire(self, name, original):
        def wrapper(*args, **kwargs):
            self._check(f"Tensor.{name}")
            return original(*args, **kwargs)

        return wrapper

    def unguarded(self, fn):
        def wrapper(*args, **kwargs):
            on, self.on = self.on, False
            try:
                return fn(*args, **kwargs)
            finally:
                self.on = on

        return wrapper

    @contextlib.contextmanager
    def armed(self):
        self.on = True
        try:
            yield
        finally:
            self.on = False

    def run_twice(self, fn):
        """fn once to warm up (device constants made), then guarded."""
        fn()
        with self.armed():
            return fn()


def _vav_actions_config():
    """The two-zone plan with per-VAV damper actions (tests/test_env.py's
    wide env): the step writes them by a device index."""
    from sbsim_tpu_torch.envs.config import ActionNormalizerConfig

    cfg = tpresets.two_zone_test_config()
    return dataclasses.replace(
        cfg,
        action_normalizers={**cfg.action_normalizers,
                            "supply_air_damper_percentage_command":
                                ActionNormalizerConfig(0.0, 1.0)},
        action_tuples=(("boiler", "supply_water_setpoint"),
                       ("vav_room_1", "supply_air_damper_percentage_command"),
                       ("vav_room_2", "supply_air_damper_percentage_command")),
    )


SYNC_CONFIGS = {
    "sb1": lambda: tpresets.sb1_config(num_days_in_episode=1),
    "sb1_windows": lambda: dataclasses.replace(
        tpresets.sb1_config(num_days_in_episode=1), episode_windows=2,
        window_stride_hours=24.0),
    "two_zone_randomized": lambda: tpresets.two_zone_test_config(
        occupancy_kind="randomized"),
    "two_zone_vav_actions": _vav_actions_config,
}


@pytest.mark.parametrize("solver", ["pallas_env", "pallas_cheby"])
@pytest.mark.parametrize("config", sorted(SYNC_CONFIGS))
def test_step_and_reset_make_no_host_sync(monkeypatch, config, solver):
    env = tbe.BuildingEnv(SYNC_CONFIGS[config](), device="cpu")
    keys = rng.split(rng.PRNGKey(2), 3)
    guard = SyncGuard(monkeypatch)
    states, _ = guard.run_twice(lambda: env.reset(keys))
    acts = torch.linspace(-1.0, 1.0, 3 * env.n_actions).view(3, env.n_actions)
    stepped, out = guard.run_twice(lambda: env.step_batched(states, acts, solver=solver))
    assert (stepped.step_idx == 1).all() and torch.isfinite(out.reward).all()
    if config == "two_zone_vav_actions":
        # The per-VAV dampers are the actions' native values (0..1).
        np.testing.assert_allclose(stepped.hvac.damper.numpy(),
                                   (acts[:, 1:].numpy() + 1.0) / 2.0, rtol=1e-6)


@pytest.mark.parametrize("layout", ["per_env", "flat"])
def test_trainer_steps_make_no_host_sync(monkeypatch, layout):
    env = tbe.BuildingEnv(tpresets.sb1_config(num_days_in_episode=1), device="cpu")
    tr = ttrain.SACTrainer(env, ttrain.recipe_for(
        env, n_envs=2, batch_size=4, replay_capacity=64, seed_steps=4,
        env_solver="pallas_env", replay_layout=layout))
    state = tr.init(rng.PRNGKey(0))
    seed = tr.seed_with_actions(state, tsched.build_schedule_actions(env))
    key = rng.PRNGKey(3)
    guard = SyncGuard(monkeypatch)
    seeded, _ = guard.run_twice(lambda: seed(state))
    for learn in (False, True):
        stepped, metrics = guard.run_twice(lambda: tr.train_step(seeded, learn=learn))
        assert (metrics["critic_loss"] != 0) == learn
    total = guard.run_twice(lambda: tr.evaluate(stepped.sac, key, 2, 4))
    assert torch.isfinite(total)
    # A done env resets inside the collect step without a read either.
    done = seeded.replace(env_states=seeded.env_states.replace(
        step_idx=torch.full_like(seeded.env_states.step_idx, EPISODE - 1)))
    fresh, _ = guard.run_twice(lambda: seed(done))
    assert (fresh.env_states.step_idx == 0).all()


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def test_cpu_path_returns_the_functions_own_results():
    kept = {}

    def fn(x, scale):
        kept["out"] = (x * scale, {"n": x.sum()})
        return kept["out"]

    captured = graphs.capture(fn)
    x = torch.arange(4.0)
    out = captured(x, 3.0)
    assert out is kept["out"]
    assert not captured.programs


@dataclasses.dataclass(frozen=True)
class _Ring:
    buf: torch.Tensor
    cursor: torch.Tensor
    capacity: int


class _StubGraphs:
    """torch.cuda's pieces on the CPU: the capture records nothing (the
    function runs once), and `replays` is what a test makes replay() do;
    a graph has `nodes` device operations."""

    nodes = 0

    @staticmethod
    def new_graph():
        return _StubGraph()

    @classmethod
    def instantiate(cls, graph):
        return cls.nodes

    @staticmethod
    @contextlib.contextmanager
    def capture(graph):
        yield

    @staticmethod
    def device(device):
        return contextlib.nullcontext()

    @staticmethod
    def reserved(device):
        return 0

    @staticmethod
    def side_stream(device):
        return contextlib.nullcontext()


class _StubGraph:
    def __init__(self):
        self.run = lambda: None

    def replay(self):
        self.run()

    def reset(self):
        self.run = None


def _insert(ring, value, counts):
    """A ring insert in place (as the replay ring's), and a fresh output."""
    counts["fdm_jacobi"] += 1
    ring.buf[ring.cursor.long()] = value
    new = ring.__class__(buf=ring.buf, cursor=(ring.cursor + 1) % ring.capacity,
                         capacity=ring.capacity)
    return new, value * 2.0


def _program(fn, args, counts):
    leaves = []
    spec = graphs.flatten(args, leaves)
    program = graphs.Program(fn, args, spec, leaves, (counts,), api=_StubGraphs)

    def rerun():
        # What the graph's replay computes: fn on the static inputs, into
        # the static outputs (the in-place buffer updates itself), without
        # moving the Python counters.
        saved = dict(counts)
        out_leaves = []
        graphs.flatten(fn(*graphs.unflatten(spec, iter(program.static_in))), out_leaves)
        for dst, src in zip(program.static_out, out_leaves):
            if dst is not src:
                dst.copy_(src)
        counts.update(saved)

    program.graph.run = rerun
    return program, leaves


def test_launch_counts_move_once_per_call_with_a_stub_graph():
    counts = {"fdm_jacobi": 0}
    ring = _Ring(torch.zeros(4), torch.zeros((), dtype=torch.int32), 4)
    fn = lambda r, v: _insert(r, v, counts)
    program, leaves = _program(fn, (ring, torch.tensor(1.5)), counts)
    # Warm-up (the first call) launched once; the capture's launch is taken back.
    assert counts["fdm_jacobi"] == 1 and program.per_replay == [{"fdm_jacobi": 1}]
    first = program.take_first()
    assert torch.equal(first[0].buf, torch.tensor([1.5, 0, 0, 0]))
    for n in range(2, 5):
        program(leaves)
        assert counts["fdm_jacobi"] == n and program.replays == n - 1


def test_registered_launch_families_follow_replays_with_a_stub_graph(monkeypatch):
    """A family the kernel modules register as device launches
    (`profiling.family(..., launches=True)`: fdm.launches, rng.launches,
    fdm.swap_groups, and here one of the test's own) is what a captured
    function hands its programs, and the graphs' own set-up family is not:
    what the capture adds to it is taken back, and one replay adds it once.
    """
    from sbsim_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling.REGISTRY, "families", dict(profiling.REGISTRY.families))
    monkeypatch.setattr(profiling.REGISTRY, "launches", list(profiling.REGISTRY.launches))
    mine = profiling.family("test.launches", ("body",), launches=True)
    counters = graphs.capture(lambda x: x).counters
    held = {id(c) for c in counters}
    assert {id(mine), id(fdm_cuda.launch_counts), id(fdm_cuda.swap_counts),
            id(rng.launch_counts)} <= held
    assert id(profiling.family("graphs")) not in held

    def fn(x):
        mine["body"] += 2
        fdm_cuda.swap_counts["swap_groups"] += 3
        return x + 1.0

    groups = fdm_cuda.swap_counts["swap_groups"]
    monkeypatch.setitem(fdm_cuda.swap_counts, "swap_groups", groups)  # restored after
    leaves = [torch.zeros(2)]
    program = graphs.Program(fn, tuple(leaves), graphs.flatten(tuple(leaves), []), leaves,
                             counters, api=_StubGraphs)
    # The warm-up (the first call) counted once; the capture's additions are
    # taken back.
    assert mine["body"] == 2 and fdm_cuda.swap_counts["swap_groups"] == groups + 3
    for n in range(2, 4):
        program(leaves)
        assert mine["body"] == 2 * n and fdm_cuda.swap_counts["swap_groups"] == groups + 3 * n


def test_replay_aliasing_rule_with_a_stub_graph():
    counts = {"fdm_jacobi": 0}
    ring = _Ring(torch.zeros(4), torch.zeros((), dtype=torch.int32), 4)
    value = torch.tensor(1.5)
    fn = lambda r, v: _insert(r, v, counts)
    program, _ = _program(fn, (ring, value), counts)
    state, _ = program.take_first()  # the eager call: the caller's ring written
    assert state.buf is ring.buf and float(ring.buf[0]) == 1.5
    held = (state.buf.clone(), state.cursor)
    leaves = []
    graphs.flatten((state, torch.tensor(2.5)), leaves)
    new, doubled = program(leaves)
    # The caller's tensors are not written; the ring comes back as the
    # program's static buffer, updated in place; other outputs are fresh.
    assert torch.equal(state.buf, held[0]) and state.cursor is held[1]
    assert new.buf is program.static_in[0]
    assert torch.equal(new.buf, torch.tensor([1.5, 2.5, 0, 0]))
    assert int(new.cursor) == 2 and new.capacity == 4 and float(doubled) == 5.0
    assert new.cursor is not program.static_out[1] and doubled is not program.static_out[2]
    # Passed back in, the static buffer is not copied; the cursor is.
    before = new.buf.data_ptr()
    newer, _ = program([new.buf, new.cursor, torch.tensor(3.5)])
    assert newer.buf.data_ptr() == before
    assert torch.equal(newer.buf, torch.tensor([1.5, 2.5, 3.5, 0]))
    assert int(new.cursor) == 2 and int(newer.cursor) == 3


def test_the_collector_is_paused_during_a_capture_alone():
    """No cyclic collection runs inside a capture: one can free an
    unreachable program, whose graph may not be destroyed while a stream
    captures (its destruction invalidated a capture on the card). The
    warm-up before it and the code after it run with the collector as it
    was."""
    seen = []

    class Recording(_StubGraphs):
        @staticmethod
        @contextlib.contextmanager
        def capture(graph):
            seen.append(("capture", gc.isenabled()))
            yield

    def fn(x):
        seen.append(("fn", gc.isenabled()))
        return x * 2.0

    leaves = [torch.ones(2)]
    spec = graphs.flatten(tuple(leaves), [])
    assert gc.isenabled()
    graphs.Program(fn, tuple(leaves), spec, leaves, (), api=Recording)
    assert seen == [("fn", True), ("capture", False), ("fn", False)] and gc.isenabled()
    gc.disable()
    try:
        graphs.Program(fn, tuple(leaves), spec, leaves, (), api=Recording)
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_a_program_freed_during_a_capture_keeps_its_graph_until_it_ends():
    """The graph of a program freed inside another program's capture (here
    by its last reference) is destroyed after the capture, not in it:
    destroying a graph while a stream captures invalidates the capture.
    Freed outside a capture, a program's graph goes at once."""
    leaves = [torch.ones(2)]
    spec = graphs.flatten(tuple(leaves), [])
    fn = lambda x: x * 2.0
    held = [graphs.Program(fn, tuple(leaves), spec, leaves, (), api=_StubGraphs)]
    graph = weakref.ref(held[0].graph)
    seen = []

    class Freeing(_StubGraphs):
        @staticmethod
        @contextlib.contextmanager
        def capture(graph_):
            held.clear()  # the old program's last reference
            seen.append(graph() is not None)
            yield
            seen.append(graph() is not None)

    graphs.Program(fn, tuple(leaves), spec, leaves, (), api=Freeing)
    assert seen == [True, True] and graph() is None
    program = graphs.Program(fn, tuple(leaves), spec, leaves, (), api=_StubGraphs)
    graph = weakref.ref(program.graph)
    del program
    assert graph() is None


def test_in_place_update_without_return_is_refused():
    def fn(x):
        x.add_(1.0)
        return x * 2.0

    leaves = [torch.zeros(2)]
    with pytest.raises(ValueError, match="in place without returning"):
        graphs.Program(fn, tuple(leaves), graphs.flatten(tuple(leaves), []), leaves, (),
                       api=_StubGraphs)


def test_argument_trees_round_trip():
    t = Transition(*(torch.full((2,), float(i)) for i in range(5)))
    args = ({"a": t, "b": [torch.ones(1), 3, None]}, (2.5, "x"), torch.zeros(()))
    leaves = []
    spec = graphs.flatten(args, leaves)
    assert len(leaves) == 7
    back = graphs.unflatten(spec, iter(leaves))
    assert back[0]["a"] == t and back[0]["b"][1:] == [3, None] and back[1] == (2.5, "x")
    assert back[0]["b"][0] is leaves[5] and back[2] is leaves[6]
    again = []
    assert graphs.flatten(back, again) == spec and hash(spec)
    with pytest.raises(TypeError, match="hashable constant"):
        graphs.flatten((np.zeros(2),), [])


def test_constants_are_cached_per_value_and_device():
    a = graphs.constant(0.5, torch.float32, "cpu")
    assert a is graphs.constant(0.5, torch.float32, torch.device("cpu"))
    assert torch.equal(a, torch.tensor(0.5))
    neg, pos = (graphs.constant(v, torch.float32, "cpu") for v in (-0.0, 0.0))
    assert neg is not pos and torch.signbit(neg) and not torch.signbit(pos)
    assert graphs.constant(3, torch.int64, "cpu").dtype == torch.int64

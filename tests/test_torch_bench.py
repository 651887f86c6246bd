"""The port bench (sbsim_tpu_torch/bench.py) and the step tables past the
episode's end: the port against the JAX package on the CPU.

* Past the end: the bench's rollouts never reset, so their steps run past
  the tables (sb1 2-day: 592 steps). JAX reads `jnp` tables, whose gather
  clamps the index; the port's views clamp it too. One xla_jacobi step of
  the sb1 2-day env at B=2 from JAX's reset state with step_idx forced to
  575, 591, 592, 700 and 1400, one window and two: reward, observation and
  temperature within FIELD_ATOL (tests/test_torch_env.py's one-solve
  bound), step counts and done flags exact. SimulatedBuilding's table
  reads (occupants, observations, reward info) past the end against JAX's.
* The bench's config field for field against the JAX bench's recipe
  (bench.py:109-127), with and without --full-scale; its batch and solver
  choice.
* make_rollout at B=4 for 8 steps under xla_jacobi against the JAX bench's
  jitted scan (bench.py:134-146) on the same keys and action table, from
  step 0 and 560: the field within 8 x FIELD_ATOL, the mean reward within
  OUT_ATOL, steps and keys exact; and from step 588 across the 592-step
  end, every state field bitwise JAX's run op by op (jitted, XLA's FMAs
  can flip a Jacobi count at its threshold there, as anywhere).
* The plateau rule and the median against a restatement of
  bench.py:217-235, including an even count where the true median and
  the JAX script's upper middle differ.
* main: a NaN field fails the solver check (exit 1, the figures in the
  line, no other solver tried); without --cpu and without a card, exit 1;
  with --cpu one JSON line with the JAX keys minus the two baseline keys,
  plus card, timing and solver_check.
"""

import dataclasses
import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.agents import schedule_policy as jsched
from sbsim_tpu.core import geometry as jgeometry
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import host_adapter as jha
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu_torch import bench, convert, rng
from sbsim_tpu_torch.agents import schedule_policy as tsched
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import host_adapter as tha
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.proto import building_pb2 as tbuilding
from sbsim_tpu_torch.proto import reward_pb2 as treward

FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_env.py)
OUT_ATOL = 1e-4
PAST_END = (575, 591, 592, 700, 1400)
ROLLOUT_B = 4
ROLLOUT_STEPS = 8
JAX_KEYS = ("metric", "value", "unit", "best", "median", "solver", "batch", "weather",
            "repeats", "plateaued")


def _tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _sb1(lib, windows):
    cfg = lib.sb1_config(num_days_in_episode=2)
    if windows > 1:
        cfg = dataclasses.replace(cfg, episode_windows=windows, window_stride_hours=24.0)
    return cfg


@pytest.fixture(scope="module", params=[1, 2], ids=["one_window", "two_windows"])
def sb1_pair(request):
    windows = request.param
    jenv = jbe.BuildingEnv(_sb1(jpresets, windows))
    tenv = tbe.BuildingEnv(_sb1(tpresets, windows), device="cpu")
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(7), 2))
    step = jax.jit(lambda s, a: jenv.step_batched(s, a, solver="xla_jacobi"))
    return dict(jenv=jenv, tenv=tenv, jstate=jstate, step=step, windows=windows)


@pytest.mark.parametrize("t", PAST_END)
def test_step_tables_past_the_episode_end_match_jax(sb1_pair, t):
    jenv, tenv = sb1_pair["jenv"], sb1_pair["tenv"]
    assert np.asarray(jenv.tables.ambient_temp).shape[-1] == 592 == tenv._tab[
        "ambient_temp"].shape[1]
    jstate = sb1_pair["jstate"].replace(step_idx=jnp.full((2,), t, jnp.int32))
    if sb1_pair["windows"] > 1:
        jstate = jstate.replace(window=jnp.asarray([0, 1], jnp.int32))
    action = np.asarray([[0.3, -0.5], [-0.8, 0.6]], np.float32)
    jnext, jout = sb1_pair["step"](jstate, jnp.asarray(action))
    tstate = convert.env_state_from_numpy(_tree(jstate), "cpu")
    tnext, tout = tenv.step_batched(tstate, torch.as_tensor(action), solver="xla_jacobi")
    np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), atol=FIELD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tout.observation.numpy(), np.asarray(jout.observation),
                               atol=FIELD_ATOL, rtol=0)
    np.testing.assert_allclose(tnext.temp.numpy(), np.asarray(jnext.temp), atol=FIELD_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tnext.step_idx.numpy(), np.asarray(jnext.step_idx))
    np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
    np.testing.assert_array_equal(tnext.occupants.numpy(), np.asarray(jnext.occupants))


def test_the_view_clamps_each_index_once(monkeypatch):
    """Every table read through one view shares one clamp of its index."""
    tenv = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    tab = tenv._state_tables(torch.zeros(2, dtype=torch.int32))
    t = torch.tensor([5, 10**6])
    last = tenv._table_steps - 1
    calls = []
    clamp = torch.Tensor.clamp
    monkeypatch.setattr(torch.Tensor, "clamp",
                        lambda self, *a: calls.append(a) or clamp(self, *a))
    got = [tab(name, t) for name in ("ambient_temp", "heating_setpoint", "comfort")]
    monkeypatch.undo()
    assert calls == [(0, last)]
    for name, value in zip(("ambient_temp", "heating_setpoint", "comfort"), got):
        np.testing.assert_array_equal(value.numpy(), tenv._tab[name][0, [5, last]].numpy())


@pytest.fixture(scope="module")
def two_zone_pair():
    return (jbe.BuildingEnv(jpresets.two_zone_test_config()),
            tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu"))


def _to_port(msg, port_type):
    return port_type.FromString(msg.SerializeToString(deterministic=True))


def _same_reward_info(t_info, j_info):
    assert t_info.start_timestamp == j_info.start_timestamp
    for k, a in t_info.zone_reward_infos.items():
        b = j_info.zone_reward_infos[k]
        for name in ("heating_setpoint_temperature", "cooling_setpoint_temperature",
                     "average_occupancy", "zone_air_temperature"):
            assert abs(getattr(a, name) - getattr(b, name)) <= FIELD_ATOL, name
    a, b = (i.boiler_reward_infos["boiler"] for i in (t_info, j_info))
    assert abs(a.natural_gas_heating_energy_rate - b.natural_gas_heating_energy_rate) <= OUT_ATOL


@pytest.mark.parametrize("t", [303, 304, 400])
def test_host_adapter_reads_past_the_end_match_jax(two_zone_pair, t):
    """The two-zone day's tables hold 304 steps (step-function occupancy:
    num_occupants and the reward info read them)."""
    jenv, tenv = two_zone_pair
    assert tenv._tab["step_occupancy"].shape[1] == 304
    jb, tb = jha.SimulatedBuilding(jenv, seed=0), tha.SimulatedBuilding(tenv, seed=0)
    jb._state = jb._state.replace(step_idx=jnp.int32(t))
    tb._state = tb._state.replace(step_idx=torch.full((1,), t, dtype=torch.int32))
    tb._step_idx = t
    for _ in range(2):
        assert tb.num_occupants == jb.num_occupants
        jreq = jb.default_observation_request()
        jres = jb.request_observations(jreq)
        tres = tb.request_observations(_to_port(jreq, tbuilding.ObservationRequest))
        for a, b in zip(tres.single_observation_responses, jres.single_observation_responses):
            assert a.observation_valid == b.observation_valid
            assert abs(a.continuous_value - b.continuous_value) <= FIELD_ATOL
        _same_reward_info(tb.reward_info, _to_port(jb.reward_info, treward.RewardInfo))
        jb.wait_time()
        tb.wait_time()
    assert tb.is_comfort_mode(tb.current_timestamp) == jb.is_comfort_mode(jb.current_timestamp)


def _plain(x):
    """Config values with each package's dataclasses as plain dicts."""
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


def _jax_bench_config(full_scale):
    """bench.py:109-127, verbatim."""
    floor_plan = None
    if full_scale:
        floor_plan = jgeometry.make_synthetic_office_plan(9, 14, room_cvs=12)
    cfg = jpresets.sb1_config(num_days_in_episode=2, floor_plan=floor_plan)
    if full_scale:
        cfg = dataclasses.replace(
            cfg, building=dataclasses.replace(cfg.building, layout="auto"))
    return cfg


@pytest.mark.parametrize("full_scale", [False, True], ids=["12zone", "126room"])
def test_bench_config_is_the_jax_recipe(full_scale):
    tcfg, jcfg = bench.bench_config(full_scale), _jax_bench_config(full_scale)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("building", "weather"):
            for g in dataclasses.fields(got):
                a, b = getattr(got, g.name), getattr(want, g.name)
                if g.name == "replay_csv_path":
                    with np.load(a) as x, np.load(b) as y:
                        assert sorted(x.files) == sorted(y.files)
                        for k in x.files:
                            np.testing.assert_array_equal(x[k], y[k])
                elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=g.name)
                else:
                    assert _plain(a) == _plain(b), g.name
        else:
            assert _plain(got) == _plain(want), f.name
    assert tcfg.building.layout == ("auto" if full_scale else "ref")
    # The interleave width of the reference orientation, as the JAX bench.
    assert tcfg.pallas_block_envs == (4 if full_scale else 8)
    assert bench.bench_batch(None, full_scale, cpu=False) == (512 if full_scale else 2048)
    assert bench.bench_batch(None, full_scale, cpu=True) == 64
    assert bench.bench_batch(4, full_scale, cpu=True) == 4


def test_solver_choice_has_no_fallback():
    assert bench.pick_solver("auto", cpu=False, no_pallas=False) == "pallas_cheby"
    assert bench.pick_solver("auto", cpu=True, no_pallas=False) == "xla_jacobi"
    assert bench.pick_solver("auto", cpu=False, no_pallas=True) == "xla_jacobi"
    assert bench.pick_solver("pallas_env", cpu=True, no_pallas=True) == "pallas_env"
    args = bench.parse_args(["--force-cpu"])
    assert args.cpu and args.batch is None and args.steps == 64
    assert (args.min_repeats, args.max_repeats, args.budget_sec) == (6, 20, 60.0)


@pytest.fixture(scope="module")
def rollout_pair():
    jenv = jbe.BuildingEnv(_jax_bench_config(False))
    tenv = tbe.BuildingEnv(bench.bench_config(False), device="cpu")
    jactions = jnp.asarray(jsched.build_schedule_actions(jenv))
    tactions = tsched.build_schedule_actions(tenv)
    np.testing.assert_array_equal(tactions, np.asarray(jactions))
    keys = jax.random.split(jax.random.PRNGKey(0), ROLLOUT_B)
    jstates0, _ = jax.jit(jax.vmap(jenv.reset))(keys)

    def rollout(states):  # bench.py:134-146
        def body(s, _):
            act = jactions[jnp.clip(s.step_idx, 0, jactions.shape[0] - 1)]
            s, out = jenv.step_batched(s, act, solver="xla_jacobi")
            return s, out.reward

        states, rewards = jax.lax.scan(body, states, None, length=ROLLOUT_STEPS)
        return states, jnp.mean(rewards)

    return dict(tenv=tenv, tactions=tactions, jstates0=jstates0, jroll=jax.jit(rollout))


@pytest.mark.parametrize("start", [0, 560])
def test_make_rollout_matches_the_jax_scan(rollout_pair, start):
    tenv = rollout_pair["tenv"]
    tstates0, _ = tenv.reset(rng.split(rng.PRNGKey(0, device="cpu"), ROLLOUT_B))
    np.testing.assert_array_equal(tstates0.rng.numpy(),
                                  np.asarray(rollout_pair["jstates0"].rng).astype(np.int64))
    jstates0 = rollout_pair["jstates0"].replace(
        step_idx=jnp.full((ROLLOUT_B,), start, jnp.int32))
    tstates0 = tstates0.replace(step_idx=torch.full((ROLLOUT_B,), start, dtype=torch.int32))
    jstates, jreward = rollout_pair["jroll"](jstates0)
    roll = bench.make_rollout(tenv, rollout_pair["tactions"], ROLLOUT_STEPS, "xla_jacobi")
    tstates, treward = roll(tstates0)
    np.testing.assert_array_equal(tstates.step_idx.numpy(), np.asarray(jstates.step_idx))
    np.testing.assert_array_equal(tstates.rng.numpy(),
                                  np.asarray(jstates.rng).astype(np.int64))
    np.testing.assert_allclose(tstates.temp.numpy(), np.asarray(jstates.temp),
                               atol=ROLLOUT_STEPS * FIELD_ATOL, rtol=0)
    assert abs(float(treward) - float(jreward)) <= OUT_ATOL
    assert treward.shape == ()


def test_make_rollout_across_the_end_bitwise_against_unfused_jax(rollout_pair):
    """From step 588, 8 steps across the 592-step end: every field of the
    state bitwise JAX's run op by op (`jax.disable_jit()`: no FMA
    contraction, as tests/test_torch_unfused.py; jitted, a Jacobi count can
    flip at its threshold, one solve's rounding apart)."""
    tenv = rollout_pair["tenv"]
    jactions = jnp.asarray(rollout_pair["tactions"])
    jenv = jbe.BuildingEnv(_jax_bench_config(False))
    with jax.disable_jit():
        jstates = rollout_pair["jstates0"].replace(
            step_idx=jnp.full((ROLLOUT_B,), 588, jnp.int32))
        start = _tree(jstates)
        rewards = []
        for _ in range(ROLLOUT_STEPS):
            act = jactions[jnp.clip(jstates.step_idx, 0, jactions.shape[0] - 1)]
            jstates, out = jenv.step_batched(jstates, act, solver="xla_jacobi")
            rewards.append(np.asarray(out.reward))
    roll = bench.make_rollout(tenv, rollout_pair["tactions"], ROLLOUT_STEPS, "xla_jacobi")
    tstates, treward = roll(convert.env_state_from_numpy(start, "cpu"))
    got = convert.env_state_to_numpy(tstates)
    want = _tree(jstates)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, np.asarray(v)

    got = dict(flat(got))
    for name, value in flat(want):
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert int(tstates.step_idx.min()) == 596
    assert abs(float(treward) - float(np.mean(rewards))) <= OUT_ATOL


def _jax_rule(rates, min_repeats, max_repeats):
    """bench.py:217-235 with the rates in place of the timed calls and no
    budget: (reps, best, upper-middle median, plateaued)."""
    reps = []
    rates = iter(rates)
    while len(reps) < max_repeats:
        reps.append(next(rates))
        if len(reps) >= max(min_repeats, 5):
            if max(reps) <= max(reps[:-4]) * 1.01:
                break
    best = max(reps)
    median = float(sorted(reps)[len(reps) // 2])
    plateaued = len(reps) >= 5 and max(reps[-4:]) <= max(reps[:-4]) * 1.01
    return reps, best, median, plateaued


RATE_LISTS = {
    "plateau_at_6": ([100.0, 120.0, 117.0, 119.0, 120.5, 118.0, 500.0], 6, 20),
    "rising": ([float(r) for r in range(100, 130)], 6, 20),
    "min_repeats_8": ([100.0, 101.0, 98.0, 99.0, 100.5, 97.0, 100.0, 96.0, 90.0], 8, 20),
    "cap_3": ([1.0, 2.0, 3.0, 4.0], 6, 3),
    "late_jump": ([100.0, 100.0, 100.0, 100.0, 103.0, 100.0, 100.0, 100.0, 100.0, 1.0], 5, 20),
}


@pytest.mark.parametrize("name", list(RATE_LISTS))
def test_plateau_rule_and_median(name):
    rates, lo, hi = RATE_LISTS[name]
    want, best, upper, plateaued = _jax_rule(rates, lo, hi)
    it = iter(rates)
    reps = bench.repeat_until_plateau(lambda: next(it), lo, hi, budget_sec=1e9)
    assert reps == want
    got = bench.summarize(reps)
    assert got["best"] == best and got["plateaued"] == plateaued
    assert got["median"] == float(np.median(reps))
    if len(reps) % 2 == 0:  # the JAX script's upper middle is not the median
        assert sorted(reps)[len(reps) // 2 - 1] != sorted(reps)[len(reps) // 2]
        assert got["median"] < upper
    else:
        assert got["median"] == upper


def test_plateau_rule_budget():
    """The budget is checked before each repeat; one always runs."""
    now = [0.0]

    def clock():
        return now[0]

    def run():
        now[0] += 10.0
        return 1.0

    assert len(bench.repeat_until_plateau(run, 6, 20, budget_sec=25.0, clock=clock)) == 3
    now[0] = 0.0
    assert len(bench.repeat_until_plateau(run, 6, 20, budget_sec=0.0, clock=clock)) == 1


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[0])


def test_main_on_the_cpu_prints_one_line(capsys):
    rc = bench.main(["--cpu", "--batch", "2", "--steps", "2", "--max-repeats", "2"])
    assert rc == 0
    line = _line(capsys)
    assert set(line) == set(JAX_KEYS) | {"card", "timing", "solver_check"}
    assert line["unit"] == "env-steps/s (cpu)" and line["card"] == "cpu"
    assert line["timing"] == "host_clock" and line["solver"] == "xla_jacobi"
    assert line["batch"] == 2 and line["weather"] == "replay" and len(line["repeats"]) == 2
    assert line["value"] == line["best"] == max(line["repeats"]) > 0
    assert line["solver_check"] == {"max_abs_dtemp": 0.0, "temp_limit": 1e-2,
                                    "max_abs_dreward": 0.0, "reward_limit": 1e-3,
                                    "passed": True}


def test_main_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert bench.main(["--full-scale", "--solver", "pallas_env"]) == 1
    assert capsys.readouterr().out == ""


def test_failed_solver_check_exits_1_without_fallback(monkeypatch, capsys):
    """A solver whose field is NaN: the check fails, its line is printed,
    and no other solver runs."""
    seen = []
    step = tbe.BuildingEnv.step_batched

    def nan_step(self, states, actions, use_pallas=True, solver=None):
        seen.append(solver)
        states, out = step(self, states, actions, use_pallas=use_pallas, solver=solver)
        if solver == "pallas_env":
            states = states.replace(temp=torch.full_like(states.temp, float("nan")))
        return states, out

    monkeypatch.setattr(tbe.BuildingEnv, "step_batched", nan_step)
    rc = bench.main(["--cpu", "--batch", "2", "--steps", "2", "--solver", "pallas_env"])
    assert rc == 1
    line = _line(capsys)
    assert line["solver"] == "pallas_env" and line["value"] is None and line["repeats"] == []
    check = line["solver_check"]
    assert not check["passed"] and np.isnan(check["max_abs_dtemp"])
    assert check["temp_limit"] == 1e-2
    assert seen == ["pallas_env", "xla_jacobi"]

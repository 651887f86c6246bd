"""The validation path: the port's numpy FDM oracles and exact host
simulator against the JAX package's, and the port's device path against
its own exact host, on the CPU.

* physics/reference_impl: every oracle bitwise the JAX package's on the
  same geometry and seeded inputs; the port's plain Jacobi solver against
  the oracle at tests/test_fdm.py:58-92's tolerances (one iteration 2e-4 K,
  one step 1e-3 K with the iteration count exact).
* envs/exact_host.ExactHostSimulator bitwise the JAX package's, in every
  state field (dtypes and Python types included), both random streams and
  every returned value, step by step: the two-zone plan at p=1,
  distance=5 with randomized occupancy; distance=-1 (the whole-room
  shuffle); sb1 with replay weather; naive timestamps; a US/Pacific start
  across 2023-03-12's change; the Gauss-Seidel solver; a transposed
  synthetic plan. On a square plan whose diffuser pattern is its own
  transpose, layout="transposed" is taken from the config: the host's
  rebuilds are the geometry's cell for cell (the JAX package guesses the
  layout from the diffusers and misaligns them; that is not copied).
* The port's counterparts of the four tests of tests/test_device_vs_host.py
  (the per-env step on the CPU, i.e. K2's plain version, against the
  port's exact host): the gates at step 24; the 5e-2 K drift budget with
  thermostat modes exact over a day on the two-zone plan; the same on the
  sb1 plan, where one threshold crossing must recover (the JAX package run
  op by op crosses with it: tests/test_torch_opbyop.py); the transposed
  layout, here over a whole day and without a crossing.
* ParityTracker's gate, recovery window and end-of-run check.

The statistics of swap convection against the exact shuffle are in
tests/test_torch_shuffle.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sbsim_tpu.core import geometry as jgeo
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import exact_host as jeh
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.physics import reference_impl as jref
from sbsim_tpu_torch import rng
from sbsim_tpu_torch.core import geometry as tgeo
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import exact_host as teh
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.hvac import devices as hvac_ops
from sbsim_tpu_torch.physics import fdm as tfdm
from sbsim_tpu_torch.physics import reference_impl as tref

SETPOINTS = {"supply_water_setpoint": 340.0,
             "supply_air_heating_temperature_setpoint": 285.0}
DRIFT_BUDGET = teh.DRIFT_BUDGET  # 5e-2 K (tests/test_device_vs_host.py)
MORNING = "2023-07-06 14:00:00+00:00"  # 07:00 in US/Pacific, a Thursday


# ---------------------------------------------------------------------------
# The oracles
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def geoms():
    """(JAX geometry, port geometry) of the two-zone and the sb1 plan."""
    out = {}
    for name, cfgs in (("two_zone", (jpresets.two_zone_test_config(),
                                     tpresets.two_zone_test_config())),
                       ("sb1", (jpresets.sb1_config(num_days_in_episode=1),
                                tpresets.sb1_config(num_days_in_episode=1)))):
        out[name] = (jbe.build_geometry(cfgs[0]), tbe.build_geometry(cfgs[1]))
    return out


def _inputs(geom, seed):
    r = np.random.default_rng(seed)
    temp = (294.0 + r.normal(0, 2.0, geom.shape)).astype(np.float32)
    q = np.zeros(geom.shape, np.float32)
    diff = np.asarray(geom.diffusers)
    q[diff > 0] = 400.0 * diff[diff > 0]
    return temp, q


def _bitwise(a, b, what=""):
    assert type(a) is type(b), (what, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("plan", ["two_zone", "sb1"])
def test_tf_jacobi_oracles_bitwise_jax(geoms, plan):
    jg, tg = geoms[plan]
    temp, q = _inputs(tg, 1)
    for args in ((283.0, 12.0, 300.0), (275.0, 100.0, 300.0)):
        want = jref.tf_jacobi_step(jg, temp, temp, q, *args)
        got = tref.tf_jacobi_step(tg, temp, temp, q, *args)
        _bitwise(got[0], want[0], "x")
        _bitwise(got[1], want[1], "max_delta")
        want = jref.tf_finite_differences_timestep(jg, temp, q, *args, 0.1, 100)
        got = tref.tf_finite_differences_timestep(tg, temp, q, *args, 0.1, 100)
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            _bitwise(a, b, f"timestep output {i}")


def test_scalar_oracles_bitwise_jax(geoms):
    jg, tg = geoms["two_zone"]
    temp, q = _inputs(tg, 2)
    present = np.ones(tg.shape, bool)
    present[0, :] = False
    materials = tuple(np.asarray(getattr(tg, f), np.float64) * 1.0000001
                      for f in ("conductivity", "heat_capacity", "density"))
    for kw in ({}, dict(present=present, materials64=materials)):
        want = jref.scalar_gauss_seidel_step(jg, temp, temp, q, 280.0, 12.0, 300.0, **kw)
        got = tref.scalar_gauss_seidel_step(tg, temp, temp, q, 280.0, 12.0, 300.0, **kw)
        _bitwise(got[0], want[0], "x")
        _bitwise(got[1], want[1], "max_delta")
        want = jref.scalar_finite_differences_timestep(jg, temp, q, 280.0, 12.0, 300.0,
                                                       0.01, 50, **kw)
        got = tref.scalar_finite_differences_timestep(tg, temp, q, 280.0, 12.0, 300.0,
                                                      0.01, 50, **kw)
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            _bitwise(a, b, f"scalar timestep output {i}")


@pytest.mark.parametrize("plan", ["two_zone", "sb1"])
def test_plain_jacobi_against_the_oracle(geoms, plan):
    """tests/test_fdm.py:58-92 on the port: one iteration within 2e-4 K of
    the oracle's, one step within 1e-3 K with the same iteration count and
    convergence."""
    _, tg = geoms[plan]
    coeffs = tfdm.stencil_coefficients(tg, time_step_sec=300.0)
    temp, q = _inputs(tg, 0)
    ambient, h = 283.0, 12.0
    expected, _ = tref.tf_jacobi_step(tg, temp, temp, q, ambient, h, 300.0)
    t, qq = torch.as_tensor(temp)[None], torch.as_tensor(q)[None]
    got = tfdm.jacobi_iteration(
        t,
        coeffs.absorb * t + qq + torch.tensor(h * ambient, dtype=torch.float32) * coeffs.conv_area,
        coeffs.cond_sum + torch.tensor(h, dtype=torch.float32) * coeffs.conv_area + coeffs.absorb,
        coeffs,
        torch.full((1,), ambient),
    )
    np.testing.assert_allclose(got[0].numpy(), expected, atol=2e-4, rtol=0)

    temp, q = _inputs(tg, 1)
    ambient, h = 275.0, 100.0
    expected, conv, n_iter = tref.tf_finite_differences_timestep(
        tg, temp, q, ambient, h, 300.0, 0.1, 100)
    got, converged, n = tfdm.fdm_step(
        torch.as_tensor(temp)[None], torch.as_tensor(q)[None],
        torch.full((1,), ambient), torch.full((1,), h), coeffs,
        convergence_threshold=0.1, iteration_limit=100)
    assert bool(converged[0]) == conv
    assert int(n[0]) == n_iter
    np.testing.assert_allclose(got[0].numpy(), expected, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# ExactHostSimulator against the JAX package's
# ---------------------------------------------------------------------------

_STATE = ("temp", "input_q", "damper", "reheat_valve", "mode", "zone_air_temp", "prev_comfort",
          "ahu_heating_setpoint", "ahu_cooling_setpoint", "ahu_flow", "cooling_request_count",
          "boiler_setpoint", "boiler_current_temp", "boiler_return_water", "boiler_flow",
          "heating_request_count", "boiler_tank_change", "boiler_last_duration",
          "boiler_has_action", "num_occupants_obs", "_diffusers64", "_plan_transposed")


def _same_host(j, t, where):
    for name in _STATE:
        a, b = getattr(t, name), getattr(j, name)
        if isinstance(a, list):
            assert [type(x) for x in a] == [type(x) for x in b], (where, name)
            assert a == b, (where, name)
        else:
            _bitwise(a, b, f"{where}: {name}")
    assert str(t.time) == str(j.time), where
    if hasattr(j, "_last_zone_occupancy"):
        _bitwise(t._last_zone_occupancy, j._last_zone_occupancy, where)
    assert {k: [o.working for o in v] for k, v in t._zone_occupants.items()} == {
        k: [o.working for o in v] for k, v in j._zone_occupants.items()}, where
    js, ts = j._occupancy_rs.get_state(), t._occupancy_rs.get_state()
    assert js[2:] == ts[2:] and np.array_equal(js[1], ts[1]), where
    assert t.convection._rand.getstate() == j.convection._rand.getstate(), where


def _hosts(make_cfg, steps, **kw):
    """Both packages' hosts on the same config, stepped together; every
    state field and returned value compared at every step."""
    j = jeh.ExactHostSimulator(jbe.BuildingEnv(make_cfg(jpresets, jgeo)), **kw)
    t = teh.ExactHostSimulator(tbe.BuildingEnv(make_cfg(tpresets, tgeo), device="cpu"), **kw)
    _same_host(j, t, "reset")
    for i in range(steps):
        want, got = j.step(SETPOINTS), t.step(SETPOINTS)
        assert list(got) == list(want)
        for k in want:
            _bitwise(got[k], want[k], f"step {i}: {k}")
        _same_host(j, t, f"step {i}")
    return j, t


def _two_zone(p=1.0, distance=5, occupancy="randomized", start=MORNING):
    def make(presets, _):
        cfg = presets.two_zone_test_config(occupancy_kind=occupancy)
        return dataclasses.replace(
            cfg, start_timestamp=start,
            convection=dataclasses.replace(cfg.convection, p=p, distance=distance))
    return make


CASES = {
    "two_zone_p1_d5": (_two_zone(), 36, {}),
    "whole_room_shuffle": (_two_zone(distance=-1), 24, {}),
    "naive_timestamps": (_two_zone(), 24, dict(naive_timestamps=True)),
    "pacific_dst_start": (_two_zone(start="2023-03-12 08:00:00+00:00"), 36, {}),
    "gauss_seidel": (_two_zone(p=0.5), 6, dict(solver="gauss_seidel")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_host_bitwise_jax(case):
    make, steps, kw = CASES[case]
    j, t = _hosts(make, steps, **kw)
    if case == "two_zone_p1_d5":
        assert t.num_occupants_obs > 0  # the occupancy stream was drawn from
    if case == "pacific_dst_start":
        assert str(t.time) == "2023-03-12 11:00:00+00:00"


def test_exact_host_sb1_replay_weather_bitwise_jax():
    def make(presets, _):
        cfg = presets.sb1_config(num_days_in_episode=1)
        return dataclasses.replace(cfg, start_timestamp=MORNING)
    j, t = _hosts(make, 24)
    assert t.cfg.weather.kind == "replay"
    assert isinstance(t._weather(t.time), np.float64)
    assert t.env.geom.n_zones == 12


def test_exact_host_transposed_plan_bitwise_jax():
    def make(presets, geo):
        cfg = presets.sb1_config(num_days_in_episode=1, layout="transposed",
                                 floor_plan=geo.make_synthetic_office_plan(2, 3, room_cvs=8))
        return dataclasses.replace(cfg, start_timestamp=MORNING)
    j, t = _hosts(make, 8)
    assert t._plan_transposed and j._plan_transposed


def _square_plan():
    """20 x 20, walls not symmetric about the diagonal, one square room whose
    diffuser pattern is its own transpose."""
    plan = np.full((20, 20), 2.0)
    plan[1:18, 1:19] = 1.0
    plan[3:13, 3:13] = 0.0
    return plan


def test_square_plan_layout_comes_from_the_config():
    plan = _square_plan()
    cfg = tpresets.sb1_config(num_days_in_episode=1, floor_plan=plan, convection_p=0.0,
                              layout="transposed")
    env = tbe.BuildingEnv(cfg, device="cpu")
    diff = np.asarray(env.geom.diffusers) > 0
    assert env.geom.shape == (20, 20) and np.array_equal(diff, diff.T)
    assert not np.array_equal(np.asarray(env.geom.conductivity),
                              np.asarray(env.geom.conductivity).T)
    host = teh.ExactHostSimulator(env, solver="gauss_seidel")
    assert host._plan_transposed
    np.testing.assert_array_equal(host._diffusers64 > 0, diff)
    for arr, field in zip(host._scalar_materials, ("conductivity", "heat_capacity", "density")):
        np.testing.assert_array_equal(arr.astype(np.float32), np.asarray(getattr(env.geom, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(host._present, (plan != 2.0).T)
    ref = teh.ExactHostSimulator(tbe.BuildingEnv(dataclasses.replace(
        cfg, building=dataclasses.replace(cfg.building, layout="ref")), device="cpu"),
        solver="gauss_seidel")
    assert not ref._plan_transposed
    np.testing.assert_array_equal(ref._scalar_materials[0].T, host._scalar_materials[0])
    # The JAX package guesses the layout from the diffusers and gets it wrong.
    jcfg = jpresets.sb1_config(num_days_in_episode=1, floor_plan=plan, convection_p=0.0,
                               layout="transposed")
    assert not jeh.ExactHostSimulator(jbe.BuildingEnv(jcfg), solver="gauss_seidel")._plan_transposed


def test_exact_host_refuses_what_it_cannot_hold():
    cfg = tpresets.two_zone_test_config()
    for part in ("occupancy", "schedule"):
        # The env's tables refuse such a zone already; a config changed after
        # the env was built reaches the host's own check.
        env = tbe.BuildingEnv(cfg, device="cpu")
        env.config = dataclasses.replace(cfg, **{part: dataclasses.replace(
            getattr(cfg, part), time_zone="Australia/Sydney")})
        with pytest.raises(ValueError, match="Australia/Sydney"):
            teh.ExactHostSimulator(env)
    with pytest.raises(ValueError, match="unknown solver"):
        teh.ExactHostSimulator(tbe.BuildingEnv(cfg, device="cpu"), solver="sor")
    # A geometry not built from the config's plan is refused.
    other = tbe.build_geometry(tpresets.sb1_config(num_days_in_episode=1))
    with pytest.raises(ValueError, match="disagree"):
        teh.ExactHostSimulator(tbe.BuildingEnv(cfg, geom=other, device="cpu"))


# ---------------------------------------------------------------------------
# The port's device path against its exact host (tests/test_device_vs_host.py)
# ---------------------------------------------------------------------------


def _energy_rates(env, state):
    """(electricity, gas) rates of the reward at the state's step
    (tests/test_device_vs_host.py:75-96)."""
    t = int(state.step_idx[0])
    ambient = torch.tensor(env.tables.ambient_temp[t], dtype=torch.float32)
    blower = float(hvac_ops.ahu_blower_power(state.hvac, env.hvac_params)[0])
    ac = float(hvac_ops.ahu_thermal_energy_rate(state.hvac, state.temp.mean(dim=(1, 2)),
                                                ambient, env.hvac_params)[0])
    pump = float(hvac_ops.boiler_pump_power(state.hvac, env.hvac_params)[0])
    gas = float(hvac_ops.boiler_thermal_energy_rate(state.hvac, ambient, env.hvac_params)[0])
    return blower + abs(ac) + pump, gas


def _drive(env, host, steps, check=None, strict=True):
    """`steps` per-env steps beside the host, held by a ParityTracker (with
    `strict`, no threshold crossing is allowed either). Returns the
    tracker's report."""
    state, _ = env.reset(rng.PRNGKey(0)[None])
    action = torch.as_tensor(env.default_action(SETPOINTS))[None]
    tracker = teh.ParityTracker()
    for i in range(steps):
        state, _ = env.step(state, action)
        host_out = host.step(SETPOINTS)
        tracker.check(i, state.temp[0].numpy(), state.hvac.thermostat_mode[0].tolist(),
                      state.hvac.zone_air_temp[0].tolist(), host)
        if check is not None:
            check(i, state, host, host_out)
    report = tracker.finish(allow_crossings=not strict)
    assert report.steps == steps and report.max_drift < DRIFT_BUDGET
    assert len(report.windows) == len(report.crossings), report
    return report


def _step_function(cfg):
    return dataclasses.replace(cfg, occupancy=dataclasses.replace(cfg.occupancy,
                                                                  kind="step_function"))


@pytest.fixture(scope="module")
def two_zone_env():
    return tbe.BuildingEnv(tpresets.two_zone_test_config(occupancy_kind="step_function"),
                           device="cpu")


def test_device_trajectory_matches_host_mode(two_zone_env):
    env = two_zone_env

    def check(i, state, host, host_out):
        np.testing.assert_allclose(state.temp[0].numpy(), host.temp, atol=5e-3, rtol=0)
        np.testing.assert_allclose(state.hvac.zone_air_temp[0].numpy(), host.zone_air_temp,
                                   atol=5e-3, rtol=0)
        np.testing.assert_allclose(float(state.hvac.boiler_current_temp[0]),
                                   host.boiler_current_temp, atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(state.hvac.boiler_return_water_temp[0]),
                                   host.boiler_return_water, atol=1e-2, rtol=0)
        if i == 23:
            elec, gas = _energy_rates(env, state)
            np.testing.assert_allclose(elec, host_out["electricity_rate"], rtol=1e-4, atol=1.0)
            np.testing.assert_allclose(gas, host_out["gas_rate"], rtol=1e-3, atol=5.0)

    _drive(env, teh.ExactHostSimulator(env), 24, check)


def test_device_vs_host_drift_budget_full_day(two_zone_env):
    _drive(two_zone_env, teh.ExactHostSimulator(two_zone_env), 288)


def test_device_vs_host_drift_budget_full_day_sb1():
    """The sb1 day: every step within the budget with modes equal, except
    where a zone at a thermostat threshold is put on opposite sides of it
    by the float32 drift (the port, like the JAX package run op by op,
    rounds without FMA contraction and crosses zone 0's heating setpoint
    one step before the host near step 192). Such a crossing must come
    back within the budget, modes equal, inside RECOVERY_STEPS."""
    env = tbe.BuildingEnv(_step_function(tpresets.sb1_config(num_days_in_episode=1,
                                                             convection_p=0.0)), device="cpu")
    assert env.geom.n_zones == 12
    report = _drive(env, teh.ExactHostSimulator(env), 288, strict=False)
    assert len(report.crossings) == len(report.windows)
    for (step, _, margin), (first, last) in zip(report.crossings, report.windows, strict=True):
        assert first == step and last - first < teh.RECOVERY_STEPS and margin < 1e-2


def test_device_vs_host_transposed_layout():
    """tests/test_device_vs_host.py's transposed case on the port, over a
    whole day and strict: on the synthetic plan under
    layout="transposed" the host's float64 rebuilds are aligned to the
    transposed grid, and every one of 288 steps stays within the budget
    with thermostat modes equal, no threshold crossing allowed."""
    plan = tgeo.make_synthetic_office_plan(2, 3, room_cvs=8)
    env = tbe.BuildingEnv(_step_function(tpresets.sb1_config(
        num_days_in_episode=1, floor_plan=plan, convection_p=0.0, layout="transposed")),
        device="cpu")
    assert env.geom.shape == (plan.shape[1], plan.shape[0])
    host = teh.ExactHostSimulator(env)
    assert host._plan_transposed
    np.testing.assert_array_equal(host._diffusers64 > 0, np.asarray(env.geom.diffusers) > 0)
    _drive(env, host, 288)
    gs = teh.ExactHostSimulator(env, solver="gauss_seidel")
    assert gs._scalar_materials[0].shape == env.geom.shape


class _Host:
    """A stand-in host: a field, modes, pre-step zone temperatures and the
    thresholds of the step."""

    def __init__(self, temp, mode, zone_air_temp, thresholds=(294.0, 297.0, 295.5)):
        self.temp, self.mode, self.zone_air_temp = np.asarray(temp, np.float64), mode, zone_air_temp
        self.thermostat_thresholds = thresholds


def test_parity_tracker_holds_the_gate():
    field = np.full((2, 2), 294.0)
    tracker = teh.ParityTracker(recovery_steps=3)
    tracker.check(0, field + 2e-3, [0, 0], [294.01, 295.0], _Host(field, [0, 0], [294.01, 295.0]))
    # A crossing: zone 0 on both sides of 294.0, apart by less than the drift
    # of the step before.
    tracker.check(1, field + 2e-3, [1, 0], [293.999, 295.0], _Host(field, [0, 0], [294.001, 295.0]))
    tracker.check(2, field + 5.0, [1, 0], [293.99, 295.0], _Host(field, [1, 0], [293.99, 295.0]))
    tracker.check(3, field + 1e-3, [1, 0], [293.99, 295.0], _Host(field, [1, 0], [293.99, 295.0]))
    ((step, zones, margin),) = tracker.report.crossings
    assert (step, zones) == (1, (0,)) and margin == pytest.approx(2e-3 + teh.ZONE_MEAN_SLACK)
    assert tracker.report.windows == [(1, 2)]
    assert tracker.report.max_drift == pytest.approx(2e-3)
    with pytest.raises(teh.ParityError, match="drift"):
        tracker.check(4, field + 0.06, [1, 0], [293.99, 295.0], _Host(field, [1, 0], [293.99, 295.0]))
    # A mismatch away from every threshold is no crossing.
    with pytest.raises(teh.ParityError, match="modes"):
        teh.ParityTracker().check(0, field, [1, 0], [293.5, 295.0],
                                  _Host(field, [0, 0], [293.5, 295.0]))
    # Nor one whose zone temperatures differ by more than the drift before.
    tracker = teh.ParityTracker()
    tracker.check(0, field + 1e-4, [0, 0], [294.01, 295.0], _Host(field, [0, 0], [294.01, 295.0]))
    with pytest.raises(teh.ParityError, match="modes"):
        tracker.check(1, field + 1e-4, [1, 0], [293.99, 295.0],
                      _Host(field, [0, 0], [294.01, 295.0]))
    # A window that does not close in time.
    tracker = teh.ParityTracker(recovery_steps=2)
    tracker.check(0, field + 2e-3, [0, 0], [294.01, 295.0], _Host(field, [0, 0], [294.01, 295.0]))
    tracker.check(1, field + 2e-3, [1, 0], [293.999, 295.0], _Host(field, [0, 0], [294.001, 295.0]))
    tracker.check(2, field + 1.0, [1, 0], [293.9, 295.0], _Host(field, [1, 0], [293.9, 295.0]))
    with pytest.raises(teh.ParityError, match="not back"):
        tracker.check(3, field + 1.0, [1, 0], [293.9, 295.0], _Host(field, [1, 0], [293.9, 295.0]))
    # A window still open at the run's end fails the run.
    tracker = teh.ParityTracker()
    tracker.check(0, field + 2e-3, [0, 0], [294.01, 295.0], _Host(field, [0, 0], [294.01, 295.0]))
    tracker.check(1, field + 2e-3, [1, 0], [293.999, 295.0], _Host(field, [0, 0], [294.001, 295.0]))
    tracker.check(2, field + 1.0, [1, 0], [293.9, 295.0], _Host(field, [1, 0], [293.9, 295.0]))
    with pytest.raises(teh.ParityError, match="recovery window"):
        tracker.finish()
    # A closed window passes, unless no crossing is allowed.
    tracker = teh.ParityTracker()
    tracker.check(0, field + 2e-3, [0, 0], [294.01, 295.0], _Host(field, [0, 0], [294.01, 295.0]))
    tracker.check(1, field + 2e-3, [1, 0], [293.999, 295.0], _Host(field, [0, 0], [294.001, 295.0]))
    tracker.check(2, field, [1, 0], [293.9, 295.0], _Host(field, [1, 0], [293.9, 295.0]))
    assert tracker.finish().windows == [(1, 1)]
    with pytest.raises(teh.ParityError, match="none is allowed"):
        tracker.finish(allow_crossings=False)

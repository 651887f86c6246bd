"""The proto host path: the port against the JAX package on the CPU.

two_zone_test_config() in both packages, in one process:

* SimulatedBuilding's devices, zones and default observation request are
  the same bytes; after reset with the same seed, request_observations
  answers the same fields with the same validity and values within
  OUT_ATOL.
* 5 HostEnvironment steps with the same actions: TimeSteps agree (types
  and discounts exact, rewards and observations within OUT_ATOL); the
  reward_info's zone temperatures within (step) x FIELD_ATOL (each
  package on its own trajectory, tests/test_torch_env.py's bound), its AC
  rate within flow x c_p x that bound (the rate is linear in the field
  mean with a slope of at most flow x c_p; the mean's summation order
  differs too, by an ulp), the rest within OUT_ATOL; the
  metrics timeseries alike; shard file names and record counts equal, and
  each package's RecordReader reads the other's shards.
* Op by op (`jax.disable_jit()`, no FMA contraction in JAX; see
  tests/test_torch_unfused.py), 4 HostEnvironment steps give the same
  bytes in every record but one field: action and observation responses,
  reward responses and reward infos, all but the AC rate, which reads the
  mean of the whole field (summed in another order; within flow x c_p x
  three float32 ulps of 300 K).
* Rejection gives -inf; LAST comes at steps_per_episode.
* RealBuildingController: the observation assembled from the proto within
  1e-5 of the env's own (tests/test_real_building.py:40); a saved port
  policy drives the building.
* BuildingEnv.step at B=1 is bitwise the row of step_batched, and within
  FIELD_ATOL (per step of its own trajectory) of JAX's env.step, for the
  Jacobi and the Chebyshev config.
* io/records, utils/conversions, utils/telemetry and interfaces against
  their JAX modules.
"""

import dataclasses
import datetime
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from sbsim_tpu import interfaces as jinterfaces
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import host_adapter as jha
from sbsim_tpu.envs import host_environment as jhe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.envs import real_building as jrb
from sbsim_tpu.io import records as jrecords
from sbsim_tpu.proto import building_pb2 as jbuilding
from sbsim_tpu.utils import conversions as jconv
from sbsim_tpu.utils import telemetry as jtelemetry
from sbsim_tpu_torch import convert, interfaces as tinterfaces, rng
from sbsim_tpu_torch.agents import policies, sac
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import host_adapter as tha
from sbsim_tpu_torch.envs import host_environment as the
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.envs import real_building as trb
from sbsim_tpu_torch.io import records as trecords
from sbsim_tpu_torch.proto import building_pb2 as tbuilding
from sbsim_tpu_torch.proto import reward_pb2 as treward
from sbsim_tpu_torch.utils import conversions as tconv
from sbsim_tpu_torch.utils import telemetry as ttelemetry

FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_env.py)
OUT_ATOL = 1e-4
CP_AIR = 1006.0  # J/kg/K
STEPS = 5
UTC = datetime.timezone.utc


@pytest.fixture(scope="module")
def envs():
    return (jbe.BuildingEnv(jpresets.two_zone_test_config()),
            tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu"))


def _to_port(msg, port_type):
    """A protobuf message as the port's message of the same bytes."""
    return port_type.FromString(msg.SerializeToString(deterministic=True))


def _pd(ts: datetime.datetime) -> pd.Timestamp:
    return pd.Timestamp(ts)


def test_metadata_same_bytes(envs):
    jenv, tenv = envs
    jb, tb = jha.SimulatedBuilding(jenv, seed=0), tha.SimulatedBuilding(tenv, seed=0)
    for a, b in ((jb.devices, tb.devices), (jb.zones, tb.zones)):
        assert [m.SerializeToString(deterministic=True) for m in a] == [
            m.SerializeToString() for m in b]
    assert (jb.default_observation_request().SerializeToString(deterministic=True)
            == tb.default_observation_request().SerializeToString())
    assert _pd(tb.current_timestamp) == jb.current_timestamp
    assert tb.time_step_sec == jb.time_step_sec and tb.num_occupants == jb.num_occupants
    for minutes in (-5, 0, 60, 600, 10**6):
        now = tb.current_timestamp + datetime.timedelta(minutes=minutes)
        assert tb.is_comfort_mode(now) == jb.is_comfort_mode(_pd(now))


def test_reset_observations_agree(envs):
    jenv, tenv = envs
    jb, tb = jha.SimulatedBuilding(jenv, seed=4), tha.SimulatedBuilding(tenv, seed=4)
    jreq = jb.default_observation_request()
    jreq.single_observation_requests.add(device_id="nope", measurement_name="x")
    jreq.single_observation_requests.add(device_id="boiler", measurement_name="no_such")
    jres = _to_port(jb.request_observations(jreq), tbuilding.ObservationResponse)
    tres = tb.request_observations(_to_port(jreq, tbuilding.ObservationRequest))
    assert tres.timestamp == jres.timestamp and tres.request == jres.request
    assert len(tres.single_observation_responses) == len(jres.single_observation_responses)
    for a, b in zip(tres.single_observation_responses, jres.single_observation_responses):
        assert a.single_observation_request == b.single_observation_request
        assert a.timestamp == b.timestamp
        assert a.observation_valid == b.observation_valid
        assert a.WhichOneof("observation_value") == b.WhichOneof("observation_value")
        assert abs(a.continuous_value - b.continuous_value) <= OUT_ATOL
    np.testing.assert_allclose(tb._last_obs_vector, np.asarray(jb._last_obs_vector), atol=OUT_ATOL)


def _check_reward_info(t_info, j_info, steps):
    assert t_info.start_timestamp == j_info.start_timestamp
    assert t_info.end_timestamp == j_info.end_timestamp
    assert sorted(t_info.zone_reward_infos) == sorted(j_info.zone_reward_infos)
    for k, a in t_info.zone_reward_infos.items():
        b = j_info.zone_reward_infos[k]
        assert abs(a.zone_air_temperature - b.zone_air_temperature) <= steps * FIELD_ATOL
        for name in ("heating_setpoint_temperature", "cooling_setpoint_temperature",
                     "air_flow_rate_setpoint", "air_flow_rate", "average_occupancy"):
            assert abs(getattr(a, name) - getattr(b, name)) <= OUT_ATOL, name
    a, b = (i.air_handler_reward_infos["air_handler"] for i in (t_info, j_info))
    flow = max(z.air_flow_rate for z in t_info.zone_reward_infos.values())
    assert abs(a.air_conditioning_electrical_energy_rate
               - b.air_conditioning_electrical_energy_rate) <= flow * CP_AIR * steps * FIELD_ATOL
    assert abs(a.blower_electrical_energy_rate - b.blower_electrical_energy_rate) <= OUT_ATOL
    a, b = (i.boiler_reward_infos["boiler"] for i in (t_info, j_info))
    assert abs(a.natural_gas_heating_energy_rate - b.natural_gas_heating_energy_rate) <= OUT_ATOL
    assert abs(a.pump_electrical_energy_rate - b.pump_electrical_energy_rate) <= OUT_ATOL


def test_host_environment_against_jax(envs, tmp_path):
    jenv, tenv = envs
    jb, tb = jha.SimulatedBuilding(jenv, seed=0), tha.SimulatedBuilding(tenv, seed=0)
    jhost = jhe.HostEnvironment(jb, jenv, metrics_path=str(tmp_path / "jax"), label="ep")
    thost = the.HostEnvironment(tb, tenv, metrics_path=str(tmp_path / "port"), label="ep")
    a, b = jhost.reset(), thost.reset()
    assert (a.step_type, a.reward, a.discount) == (b.step_type, b.reward, b.discount) == (
        the.FIRST, 0.0, 1.0)
    np.testing.assert_array_equal(b.observation, np.asarray(a.observation))
    actions = np.random.default_rng(0).uniform(-1, 1, (STEPS, tenv.n_actions)).astype(np.float32)
    for i in range(STEPS):
        a, b = jhost.step(actions[i]), thost.step(actions[i])
        assert (b.step_type, b.discount) == (a.step_type, a.discount) == (
            the.MID, tenv.config.discount_factor)
        assert abs(b.reward - a.reward) <= OUT_ATOL
        np.testing.assert_allclose(b.observation, np.asarray(a.observation), atol=OUT_ATOL)
        _check_reward_info(tb.reward_info, _to_port(jb.reward_info, treward.RewardInfo), i + 1)
    jm, tm = jhost.metrics, thost.metrics
    assert sorted(jm) == sorted(tm)
    assert [_pd(t) for t in tm["timestamps"]] == jm["timestamps"]
    assert sorted(tm["avg_temps_timeseries"]) == sorted(jm["avg_temps_timeseries"])
    for k, series in tm["avg_temps_timeseries"].items():
        np.testing.assert_allclose(series, jm["avg_temps_timeseries"][k], atol=STEPS * FIELD_ATOL)
    for k in ("ambient_temps", "rewards", "productivity_rewards", "electricity_energy_costs",
              "natural_gas_energy_costs", "carbon_emitted", "occupancy",
              "boiler_gas_energy_rates", "boiler_pump_energy_rates",
              "air_handler_blower_energy_rates"):
        np.testing.assert_allclose(tm[k], jm[k], atol=OUT_ATOL, err_msg=k)

    # Shards: the same files with the same record counts, each package
    # reading the other's.
    (jdir,), (tdir,) = os.listdir(tmp_path / "jax"), os.listdir(tmp_path / "port")
    jdir, tdir = tmp_path / "jax" / jdir, tmp_path / "port" / tdir
    assert jdir.name.startswith("ep_") and tdir.name.startswith("ep_")
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert "observation_response_2023.07.06.07" in os.listdir(tdir)
    jr, tr = jrecords.RecordReader(str(jdir)), trecords.RecordReader(str(tdir))
    jr_port, tr_jax = jrecords.RecordReader(str(tdir)), trecords.RecordReader(str(jdir))
    for read, n in (("read_observation_responses", STEPS), ("read_action_responses", STEPS),
                    ("read_reward_infos", STEPS), ("read_reward_responses", STEPS),
                    ("read_device_infos", len(tb.devices)), ("read_zone_infos", 2)):
        ours, theirs = getattr(tr, read)(), getattr(jr, read)()
        assert len(ours) == len(theirs) == n, read
        # The port's records read by JAX, and JAX's read by the port.
        assert [m.SerializeToString(deterministic=True) for m in getattr(jr_port, read)()] == [
            m.SerializeToString() for m in ours]
        assert [m.SerializeToString() for m in getattr(tr_jax, read)()] == [
            m.SerializeToString(deterministic=True) for m in theirs]
    for ours, theirs in zip(tr.read_reward_responses(), jr.read_reward_responses()):
        assert abs(ours.agent_reward_value - theirs.agent_reward_value) <= OUT_ATOL
    data = trecords.get_episode_data(str(tmp_path / "port"))
    frame = jrecords.get_episode_data(str(tmp_path / "jax"))
    assert list(data["n_steps"]) == list(frame["n_steps"]) == [STEPS]
    rewards = [r.agent_reward_value for r in tr.read_reward_responses()]
    assert data["cumulative_reward"][0] == sum(float(np.float32(r)) for r in rewards)
    assert abs(data["cumulative_reward"][0] - frame["cumulative_reward"][0]) <= STEPS * OUT_ATOL


def test_host_records_bitwise_against_op_by_op_jax(envs, tmp_path):
    jenv, tenv = envs
    steps = 4
    actions = np.random.default_rng(0).uniform(-1, 1, (steps, tenv.n_actions)).astype(np.float32)
    with jax.disable_jit():
        jb, tb = jha.SimulatedBuilding(jenv, seed=0), tha.SimulatedBuilding(tenv, seed=0)
        jhost = jhe.HostEnvironment(jb, jenv, metrics_path=str(tmp_path / "jax"))
        thost = the.HostEnvironment(tb, tenv, metrics_path=str(tmp_path / "port"))
        jhost.reset()
        thost.reset()
        for i in range(steps):
            a, b = jhost.step(actions[i]), thost.step(actions[i])
            assert a.reward == b.reward
    (jdir,), (tdir,) = os.listdir(tmp_path / "jax"), os.listdir(tmp_path / "port")
    jr = jrecords.RecordReader(str(tmp_path / "jax" / jdir))
    tr = trecords.RecordReader(str(tmp_path / "port" / tdir))
    for read in ("read_action_responses", "read_observation_responses",
                 "read_reward_responses", "read_device_infos", "read_zone_infos"):
        assert [m.SerializeToString(deterministic=True) for m in getattr(jr, read)()] == [
            m.SerializeToString() for m in getattr(tr, read)()], read
    # The whole-field mean is summed in another order (an ulp of ~300 K),
    # the mixed-air temperature rounds again (another), and the rate once
    # more: three float32 ulps of 300 K through flow x c_p.
    tol_k = 3 * 2.0**-15
    for j_info, t_info in zip(jr.read_reward_infos(), tr.read_reward_infos(), strict=True):
        j_info = _to_port(j_info, treward.RewardInfo)
        j_ahu = j_info.air_handler_reward_infos["air_handler"]
        t_ahu = t_info.air_handler_reward_infos["air_handler"]
        flow = t_info.zone_reward_infos["zone_id_1"].air_flow_rate
        assert abs(j_ahu.air_conditioning_electrical_energy_rate
                   - t_ahu.air_conditioning_electrical_energy_rate) <= flow * CP_AIR * tol_k
        j_ahu.air_conditioning_electrical_energy_rate = 0.0
        t_ahu.air_conditioning_electrical_energy_rate = 0.0
        assert j_info == t_info


def test_rejection_and_episode_end(envs):
    _, tenv = envs
    building = tha.RejectionSimulatedBuilding(tha.SimulatedBuilding(tenv, seed=1),
                                              num_rejections=2)
    host = the.HostEnvironment(building, tenv)
    host.reset()
    action = np.zeros(tenv.n_actions, np.float32)
    rewards = [host.step(action).reward for _ in range(3)]
    assert rewards[:2] == [the.ACTION_REJECTION_REWARD] * 2 and rewards[0] == -np.inf
    assert np.isfinite(rewards[2])
    assert building.time_step_sec == 300.0  # delegation
    host.reset()
    types = [host.step(action).step_type for _ in range(host.steps_per_episode)]
    assert host.steps_per_episode == 288
    assert types == [the.MID] * 287 + [the.LAST]
    assert host.step(action).step_type == the.FIRST  # the step after LAST resets


def _closed_loop(env, building, policy, steps):
    controller = trb.RealBuildingController(building, env, policy)
    actions = []
    for _ in range(steps):
        obs = controller.observe()
        np.testing.assert_allclose(obs, building._last_obs_vector, atol=1e-5)
        t0 = building.current_timestamp
        actions.append(controller.control_step())
        assert building.current_timestamp == t0 + datetime.timedelta(seconds=300)
    return actions


def test_controller_closes_the_loop(envs):
    jenv, tenv = envs
    zero = lambda obs: np.zeros((obs.shape[0], tenv.n_actions), np.float32)
    actions = _closed_loop(tenv, tha.SimulatedBuilding(tenv, seed=1), zero, 3)
    assert all(a.shape == (tenv.n_actions,) for a in actions)
    # The same observation as JAX's assembly of the same response.
    jb, tb = jha.SimulatedBuilding(jenv, seed=1), tha.SimulatedBuilding(tenv, seed=1)
    jb.wait_time()
    tb.wait_time()
    response = jb.request_observations(jb.default_observation_request())
    now = jb.current_timestamp
    kw = dict(comfort_now=jb.is_comfort_mode(now), comfort_soon=True, num_occupants=3.7)
    want = jrb.assemble_observation_from_values(jenv, jrb.response_to_value_map(response),
                                                timestamp=now, **kw)
    got = trb.assemble_observation_from_values(
        tenv, trb.response_to_value_map(_to_port(response, tbuilding.ObservationResponse)),
        timestamp=now.to_pydatetime(), **kw)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_saved_port_policy_drives_the_building(envs, tmp_path):
    _, tenv = envs
    learner = sac.SACLearner(tenv.obs_dim, tenv.n_actions, device="cpu")
    state = learner.init(rng.PRNGKey(0))
    policies.save_policy(str(tmp_path), learner, state, tenv.action_names)
    policy, meta = policies.load_policy(str(tmp_path), device="cpu")
    assert meta["action_names"] == list(tenv.action_names)
    building = tha.SimulatedBuilding(tenv, seed=2)
    seen = []

    def recorded(obs):
        seen.append(obs)
        return policy(obs)

    actions = _closed_loop(tenv, building, recorded, 2)
    for obs, action in zip(seen, actions):
        assert (np.abs(action) <= 1.0).all()
        greedy = learner.act_greedy(state, torch.as_tensor(obs)).numpy()[0]
        np.testing.assert_array_equal(action, greedy)


def test_simulated_building_refuses_episode_windows():
    env = tbe.BuildingEnv(dataclasses.replace(tpresets.two_zone_test_config(),
                                              episode_windows=2), device="cpu")
    with pytest.raises(ValueError, match="episode_windows"):
        tha.SimulatedBuilding(env)


@pytest.mark.parametrize("solver", ["jacobi", "chebyshev"])
def test_step_is_the_row_of_step_batched_and_near_jax(solver):
    cfg = dict(fdm_solver=solver)
    jenv = jbe.BuildingEnv(dataclasses.replace(jpresets.two_zone_test_config(), **cfg))
    tenv = tbe.BuildingEnv(dataclasses.replace(tpresets.two_zone_test_config(), **cfg),
                           device="cpu")
    keys = rng.split(rng.PRNGKey(3), 4)
    states, _ = tenv.reset(keys)
    row = convert.env_state_to_numpy(states)
    pick = lambda tree: {k: (pick(v) if isinstance(v, dict) else v[2:3]) for k, v in tree.items()}
    one = convert.env_state_from_numpy(pick(row), "cpu")
    jstate, _ = jenv.reset(jax.random.split(jax.random.PRNGKey(3), 4)[2])
    jstep = jax.jit(jenv.step)
    actions = np.random.default_rng(1).uniform(-1, 1, (3, 4, tenv.n_actions)).astype(np.float32)
    for i in range(3):
        act = torch.as_tensor(actions[i])
        states, out = tenv.step_batched(states, act, solver=f"pallas_{'cheby' if solver == 'chebyshev' else 'env'}")
        one, one_out = tenv.step(one, act[2:3])
        assert not _diff_leaves(pick(convert.env_state_to_numpy(states)),
                                convert.env_state_to_numpy(one))
        assert torch.equal(one_out.observation, out.observation[2:3])
        assert torch.equal(one_out.reward, out.reward[2:3])
        jstate, jout = jstep(jstate, actions[i, 2])
        np.testing.assert_allclose(one.temp[0].numpy(), np.asarray(jstate.temp),
                                   atol=(i + 1) * FIELD_ATOL)
        np.testing.assert_allclose(one_out.observation[0].numpy(), np.asarray(jout.observation),
                                   atol=OUT_ATOL)
        assert abs(float(one_out.reward[0]) - float(jout.reward)) <= OUT_ATOL
        assert int(one.fdm_iterations[0]) == int(jstate.fdm_iterations)
    with pytest.raises(ValueError, match="batch of one"):
        tenv.step(states, torch.as_tensor(actions[0]))


def _diff_leaves(a, b, prefix=""):
    """Leaves of two nested numpy dicts that differ (NaN = NaN)."""
    out = []
    for k, x in a.items():
        if isinstance(x, dict):
            out += _diff_leaves(x, b[k], prefix + k + ".")
        elif not np.array_equal(x, b[k], equal_nan=x.dtype.kind == "f"):
            out.append(prefix + k)
    return out


# ---- io/records, conversions, telemetry, interfaces -------------------------------


def test_records_round_trip_and_hourly_selection(envs, tmp_path):
    _, tenv = envs
    building = tha.SimulatedBuilding(tenv, seed=0)
    writer = trecords.RecordWriterFactory().create(str(tmp_path / "ep"))
    ts = datetime.datetime(2023, 7, 6, 7, 0, tzinfo=UTC)
    obs = building.request_observations(building.default_observation_request())
    for h in range(5):
        writer.write_observation_response(obs, ts + datetime.timedelta(hours=h))
    writer.write_reward_info(building.reward_info, ts)
    writer.write_reward_response(treward.RewardResponse(agent_reward_value=-0.25), ts)
    writer.write_device_infos(building.devices)
    writer.write_zone_infos(building.zones)
    reader = trecords.RecordReader(str(tmp_path / "ep"))
    back = reader.read_observation_responses()
    assert len(back) == 5 and all(m == obs for m in back)
    assert back[0].SerializeToString() == obs.SerializeToString()
    window = reader.read_observation_responses(start=ts + datetime.timedelta(hours=1, minutes=30),
                                               end=ts + datetime.timedelta(hours=3))
    jwindow = jrecords.RecordReader(str(tmp_path / "ep")).read_observation_responses(
        start=_pd(ts) + pd.Timedelta(hours=1, minutes=30), end=_pd(ts) + pd.Timedelta(hours=3))
    assert len(window) == len(jwindow) == 3
    assert reader.read_reward_responses()[0].agent_reward_value == -0.25
    assert len(reader.read_device_infos()) == len(building.devices)
    assert len(reader.read_zone_infos()) == 2 and reader.read_normalization_info() == {}
    data = trecords.get_episode_data(str(tmp_path))
    assert list(data["episode"]) == ["ep"] and list(data["cumulative_reward"]) == [-0.25]


@pytest.mark.parametrize("ts", [
    datetime.datetime(2023, 7, 6, 7, 0, tzinfo=UTC),
    datetime.datetime(2023, 7, 4, 23, 59, 59, 500000, tzinfo=UTC),  # a holiday
    datetime.datetime(2023, 11, 25, 13, 5),  # naive: UTC
    datetime.datetime(2024, 2, 29, 12, 0, tzinfo=datetime.timezone(datetime.timedelta(hours=-8))),
])
def test_conversions_against_jax(ts):
    jts = pd.Timestamp(ts) if ts.tzinfo else pd.Timestamp(ts).tz_localize("UTC")
    assert (tconv.pandas_to_proto_timestamp(ts).SerializeToString()
            == jconv.pandas_to_proto_timestamp(jts).SerializeToString(deterministic=True))
    proto = tconv.pandas_to_proto_timestamp(ts)
    assert _pd(tconv.proto_to_pandas_timestamp(proto)) == jconv.proto_to_pandas_timestamp(
        jconv.pandas_to_proto_timestamp(jts))
    for interval in ("DAY_OF_WEEK", "HOUR_OF_DAY"):
        assert tconv.get_radian_time(ts, tconv.TimeIntervalEnum[interval]) == (
            jconv.get_radian_time(jts, jconv.TimeIntervalEnum[interval]))
    assert tconv.is_work_day(ts) == jconv.is_work_day(jts)
    assert tconv.zone_coordinates_to_id((3, 4)) == jconv.zone_coordinates_to_id((3, 4))
    assert tconv.zone_id_to_coordinates("zone_id_(3, 4)") == (3, 4)
    assert tconv.floor_plan_based_zone_identifier_to_id("room_7") == "zone_id_7"
    assert tconv.normalize_hod(23) == jconv.normalize_hod(23) and tconv.normalize_dow(6) == 1.0
    assert tconv.kelvin_to_fahrenheit(300.0) == jconv.kelvin_to_fahrenheit(300.0)
    assert tconv.fahrenheit_to_kelvin(80.0) == jconv.fahrenheit_to_kelvin(80.0)


def test_energy_use_telemetry_and_interfaces_against_jax(envs):
    jenv, tenv = envs
    jb = jha.SimulatedBuilding(jenv, seed=0)
    jb.wait_time()
    jinfo = jb.reward_info
    assert tconv.reward_info_energy_use(_to_port(jinfo, treward.RewardInfo)) == (
        jconv.reward_info_energy_use(jinfo))
    assert ttelemetry.get_time_feature_names(3) == jtelemetry.get_time_feature_names(3)
    for k, v in ttelemetry.expand_time_features(4, 1.3, "dow").items():
        assert v == jtelemetry.expand_time_features(4, 1.3, "dow")[k]
    # Imputation: invalid and missing readings come from the previous
    # response, as in JAX.
    prev = jb.request_observations(jb.default_observation_request())
    cur = jbuilding.ObservationResponse()
    cur.CopyFrom(prev)
    cur.single_observation_responses[0].observation_valid = False
    cur.single_observation_responses[1].continuous_value = 123.0
    del cur.single_observation_responses[-1]
    want = jtelemetry.impute_missing_observations(cur, prev)
    got = ttelemetry.impute_missing_observations(_to_port(cur, tbuilding.ObservationResponse),
                                                 _to_port(prev, tbuilding.ObservationResponse))
    assert got.SerializeToString() == want.SerializeToString(deterministic=True)
    assert ttelemetry.impute_missing_observations(got, None) is got
    consts = {"zone_air_temperature_sensor": (294.0, 4.0), "supply_water_setpoint": (330.0, 0.0)}
    jn = jinterfaces.StandardScoreObservationNormalizer(consts)
    tn = tinterfaces.StandardScoreObservationNormalizer(consts)
    port_prev = _to_port(prev, tbuilding.ObservationResponse)
    for fwd in ("normalize", "denormalize"):
        assert getattr(tn, fwd)(port_prev).SerializeToString() == getattr(jn, fwd)(
            prev).SerializeToString(deterministic=True)
    ja = jinterfaces.BoundedActionNormalizer(280.0, 350.0)
    ta = tinterfaces.BoundedActionNormalizer(280.0, 350.0)
    for v in (-1.0, -0.3, 0.0, 0.7, 1.0):
        assert ta.setpoint_value(v) == ja.setpoint_value(v)
        assert ta.agent_value(ta.setpoint_value(v)) == ja.agent_value(ja.setpoint_value(v))
    assert (ta.setpoint_min, ta.setpoint_max) == (280.0, 350.0)
    assert issubclass(tha.SimulatedBuilding, tinterfaces.BaseBuilding)
    with pytest.raises(TypeError):
        tinterfaces.BaseBuilding()

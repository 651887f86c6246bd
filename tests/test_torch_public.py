"""Public functions of ported modules that the first slices left out, each
against the JAX function on the CPU:

* scenario/weather: get_replay_temperatures, ReplayWeather.from_observations,
  min_timestamp and max_timestamp (over the port's protos and datetimes);
* envs/reward.compute_absolute_reward (batched; the JAX function per env);
* core/geometry.BuildingGeometry.n_cvs;
* scenario/conv_cache.record, into a file the test names.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from google.protobuf import timestamp_pb2

from sbsim_tpu.core import geometry as jgeo
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.envs import reward as jreward
from sbsim_tpu.envs.building_env import build_geometry as jbuild
from sbsim_tpu.proto import building_pb2 as jbuilding
from sbsim_tpu.scenario import conv_cache as jcache
from sbsim_tpu.scenario import weather as jweather
from sbsim_tpu_torch.core import geometry as tgeo
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.envs import reward as treward
from sbsim_tpu_torch.envs.building_env import build_geometry as tbuild
from sbsim_tpu_torch.proto import building_pb2 as tbuilding
from sbsim_tpu_torch.scenario import conv_cache as tcache
from sbsim_tpu_torch.scenario import weather as tweather

START = 1688626800  # 2023-07-06 07:00:00 UTC


def _responses(seed, n=12):
    """ObservationResponses every 5 minutes (some half a second later),
    all but every fifth with an outside-air reading, in a shuffled order; the JAX
    package's protos and the port's parsed from the same bytes."""
    r = np.random.default_rng(seed)
    out = []
    for i in r.permutation(n):
        resp = jbuilding.ObservationResponse(
            timestamp=timestamp_pb2.Timestamp(seconds=START + 300 * int(i),
                                              nanos=500_000_000 * int(i % 2)))
        readings = ["zone_air_temperature_sensor"]
        if i % 5 != 3:
            readings.append("outside_air_temperature_sensor")
        for name in readings:
            single = resp.single_observation_responses.add()
            single.single_observation_request.device_id = "ahu"
            single.single_observation_request.measurement_name = name
            single.continuous_value = float(280.0 + 10.0 * r.random())
        out.append(resp)
    return out, [tbuilding.ObservationResponse.FromString(m.SerializeToString()) for m in out]


@pytest.mark.parametrize("seed", [0, 1])
def test_replay_temperatures_equal_jax(seed):
    jmsgs, tmsgs = _responses(seed)
    got, want = tweather.get_replay_temperatures(tmsgs), jweather.get_replay_temperatures(jmsgs)
    assert got == want
    assert -1.0 in got.values()
    tw = tweather.ReplayWeather.from_observations(tmsgs)
    jw = jweather.ReplayWeather.from_observations(jmsgs)
    np.testing.assert_array_equal(tw._epoch_seconds, jw._epoch_seconds)
    np.testing.assert_array_equal(tw._temps_raw, jw._temps_raw)
    assert pd.Timestamp(tw.min_timestamp) == jw.min_timestamp
    assert pd.Timestamp(tw.max_timestamp) == jw.max_timestamp
    utc = datetime.timezone.utc
    when = [datetime.datetime.fromtimestamp(START + s, utc) for s in (400, 1234.5, 2000)]
    np.testing.assert_array_equal(tw.temperatures(when),
                                  jw.temperatures([pd.Timestamp(t) for t in when]))
    with pytest.raises(ValueError, match="outside the recorded range"):
        tw.temperatures([datetime.datetime.fromtimestamp(START - 60, utc)])


def test_replay_record_bounds_equal_jax():
    tw = tweather.ReplayWeather(tpresets.SB1_WEATHER_NPZ)
    jw = jweather.ReplayWeather(jpresets.SB1_WEATHER_NPZ)
    assert pd.Timestamp(tw.min_timestamp) == jw.min_timestamp
    assert pd.Timestamp(tw.max_timestamp) == jw.max_timestamp
    assert tw.min_timestamp.tzinfo is not None


def _reward_inputs(seed, b=3, z=4):
    r = np.random.default_rng(seed)
    f = lambda *shape, lo=0.0, hi=1.0: r.uniform(lo, hi, shape).astype(np.float32)
    return dict(
        heating_setpoint=f(b, lo=292.0, hi=294.0),
        cooling_setpoint=f(b, lo=296.0, hi=298.0),
        zone_temps=f(b, z, lo=288.0, hi=302.0),
        zone_occupancy=np.floor(f(b, z, hi=6.0)),
        electricity_energy_rate=f(b, lo=-5e4, hi=2e5),
        natural_gas_energy_rate=f(b, lo=-1e4, hi=5e5),
        elec_price=f(b, hi=1e-7),
        elec_carbon=f(b, hi=1e-7),
        gas_price=f(b, hi=1e-8),
    )


@pytest.mark.parametrize("weights", [{}, dict(energy_cost_weight=0.5, carbon_cost_weight=2.0,
                                             carbon_cost_factor_usd_per_kg=0.1,
                                             reward_shift=1.5, reward_scale=0.25)],
                         ids=["defaults", "weighted"])
def test_absolute_reward_equals_jax(weights):
    inputs = _reward_inputs(5)
    cfg = tpresets.sb1_config(num_days_in_episode=1).reward
    jcfg = jpresets.sb1_config(num_days_in_episode=1).reward
    got = treward.compute_absolute_reward(
        **{k: torch.as_tensor(v) for k, v in inputs.items()},
        dt_sec=torch.tensor(300.0), params=treward.make_reward_params(cfg), **weights)
    jparams = jreward.make_reward_params(jcfg)
    for row in range(3):
        want = jreward.compute_absolute_reward(
            **{k: jnp.asarray(v[row]) for k, v in inputs.items()},
            dt_sec=jnp.float32(300.0), params=jparams, **weights)
        for field in ("agent_reward_value", "productivity_reward", "electricity_energy_cost",
                      "natural_gas_energy_cost", "carbon_emitted", "total_occupancy",
                      "productivity_regret", "normalized_productivity_regret",
                      "normalized_energy_cost", "normalized_carbon_emission"):
            np.testing.assert_allclose(getattr(got, field)[row].numpy(),
                                       np.asarray(getattr(want, field)), rtol=1e-5, atol=1e-6,
                                       err_msg=field)


def test_n_cvs_equals_jax():
    for jcfg, tcfg in ((jpresets.two_zone_test_config(), tpresets.two_zone_test_config()),
                       (jpresets.sb1_config(num_days_in_episode=1),
                        tpresets.sb1_config(num_days_in_episode=1))):
        tg, jg = tbuild(tcfg), jbuild(jcfg)
        assert tg.n_cvs == jg.n_cvs == tg.shape[0] * tg.shape[1]


def test_conv_cache_record_equals_jax(tmp_path):
    plans = [tgeo.make_synthetic_office_plan(2, 3, room_cvs=8),
             tgeo.make_synthetic_office_plan(3, 4, room_cvs=14)]
    np.testing.assert_array_equal(plans[1], jgeo.make_synthetic_office_plan(3, 4, room_cvs=14))
    tpath, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    for i, plan in enumerate(plans):
        args = (plan, 10 + i, 101 + i, 0.125 + i, 0.25, f"plan {i}", "test")
        assert tcache.record(*args, path=tpath) == jcache.record(*args, path=jpath)
    # Recording a plan again updates its entry.
    tcache.record(plans[0], 12, 7, 0.1, 0.2, "plan 0", "again", path=tpath)
    jcache.record(plans[0], 12, 7, 0.1, 0.2, "plan 0", "again", path=jpath)
    assert open(tpath).read() == open(jpath).read()
    entry = tcache.lookup(plans[0], path=tpath)
    assert (entry["rounds"], entry["seed"], entry["source"]) == (12, 7, "again")
    assert tcache.lookup(plans[1], path=tpath) == jcache.lookup(plans[1], path=jpath)

"""The gin calibration loader: the port's envs/gin_compat against the JAX
package's, on gin text held here (the reference's sim_config.gin is not in
the repo).

* parse_gin_bindings equal to JAX's: macros (%name), scoped observation and
  action normalization constants, the normalizer maps with aliased keys,
  histogram tuples, simulator wiring, time_zone.
* extract_observation_normalization, extract_observation_normalizer_map
  and extract_action_normalizers equal to JAX's.
* env_config_from_gin equal to JAX's field by field (the building's arrays
  and the weather record compared by value), for both simulator wirings:
  TFSimulator gives host_solver "jacobi", SimulatorFlexibleGeometries
  "gauss_seidel".
* 3 batched env steps on the CPU of the port's env from the gin config
  within FIELD_ATOL per step of the JAX env from its own.
* A time_zone outside the port's table raises ValueError naming it, in
  env_config_from_gin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import gin_compat as jgin
from sbsim_tpu_torch import rng
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import gin_compat as tgin

FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_env.py)
OUT_ATOL = 1e-4
STEPS = 3
B = 4

GIN = """
# A calibration in the layout of sim_config.gin, cut to what the loader reads.
time_step_sec = 300
convergence_threshold = 0.1
iteration_limit = 60
num_days_in_episode = 1
discount_factor = 0.95
control_volume_cm = 20
floor_height_cm = 300.0
initial_temp = 292.5
air_heat = 286.0
heating_setpoint_day = 294
cooling_setpoint_day = 297
heating_setpoint_night = 289
cooling_setpoint_night = 299
morning_start_hour = 7
evening_start_hour = 18
time_zone = 'US/Eastern'
start_timestamp = '2023-07-06 12:00:00+00:00'

vav_max_air_flowrate = 0.04
vav_reheat_water_flowrate = 0.025
air_handler_recirculation_ratio = 0.25
air_handler_heating_setpoint = %air_heat
air_handler_cooling_setpoint = 297.5
fan_differential_pressure = 12000.0
fan_efficiency = 0.85
reheat_water_setpoint = 350.0
water_pump_differential_head = 5.5
water_pump_efficiency = 0.95
boiler_heating_rate = 0.6
boiler_cooling_rate = 0.15
max_productivity_personhour_usd = 250.0
min_productivity_personhour_usd = 120.0
max_electricity_rate = 150000.0
max_natural_gas_rate = 350000.0
productivity_midpoint_delta = 0.6
productivity_decay_stiffness = 4.0
productivity_weight = 0.3
energy_cost_weight = 0.35
carbon_emission_weight = 0.35

StochasticConvectionSimulator.p = 0.8
StochasticConvectionSimulator.distance = 4
StochasticConvectionSimulator.seed = 7
SimulatorBuilding.simulator = @TFSimulator()

histogram_parameters_tuples = (
    ('zone_air_temperature_sensor', (285.0, 290.0, 292.5, 295.0, 297.5, 300.0, 305.0)),
    ('supply_air_damper_percentage_command', (0.0, 0.25, 0.5, 0.75, 1.0)),
)

zone_air_temperature_normalizer/set_observation_normalization_constants.field_id = 'zone_air_temperature_sensor'
zone_air_temperature_normalizer/set_observation_normalization_constants.sample_mean = 295.5
zone_air_temperature_normalizer/set_observation_normalization_constants.sample_variance = 9.25
supply_water_temperature_setpoint_normalizer/set_observation_normalization_constants.field_id = 'supply_water_temperature_setpoint'
supply_water_temperature_setpoint_normalizer/set_observation_normalization_constants.sample_mean = 320.261985
supply_water_temperature_setpoint_normalizer/set_observation_normalization_constants.sample_variance = 240.195517
supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants.field_id = 'supply_air_temperature_setpoint'
supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants.sample_mean = 289.329414
supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants.sample_variance = 3.186769
request_count_observation_normalizer/set_observation_normalization_constants.field_id = 'request_count'
request_count_observation_normalizer/set_observation_normalization_constants.sample_mean = 100.0
request_count_observation_normalizer/set_observation_normalization_constants.sample_variance = 25.0
unwired_normalizer/set_observation_normalization_constants.field_id = 'supply_air_flowrate_sensor'
unwired_normalizer/set_observation_normalization_constants.sample_mean = 0.5
unwired_normalizer/set_observation_normalization_constants.sample_variance = 0.1

observation_normalizer_map = {
    'zone_air_temperature_sensor': @zone_air_temperature_normalizer/set_observation_normalization_constants(),
    'supply_water_setpoint': @supply_water_temperature_setpoint_normalizer/set_observation_normalization_constants(),
    'supply_air_cooling_temperature_setpoint': @supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants(),
    'supply_air_heating_temperature_setpoint': @supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants(),
    'cooling_request_count': @request_count_observation_normalizer/set_observation_normalization_constants(),
}

supply_water_setpoint/set_action_normalization_constants.min_native_value = 310.0
supply_water_setpoint/set_action_normalization_constants.max_native_value = 350.0
supply_water_setpoint/set_action_normalization_constants.min_normalized_value = -1.0
supply_water_setpoint/set_action_normalization_constants.max_normalized_value = 1.0
supply_air_heating_temperature_setpoint/set_action_normalization_constants.min_native_value = 285.0
supply_air_heating_temperature_setpoint/set_action_normalization_constants.max_native_value = 300.0

action_normalizer_map = {
    'supply_water_setpoint': @supply_water_setpoint/set_action_normalization_constants(),
    'supply_air_heating_temperature_setpoint': @supply_air_heating_temperature_setpoint/set_action_normalization_constants(),
}
"""
LEGACY = GIN.replace("@TFSimulator()", "@SimulatorFlexibleGeometries()")


def _write(tmp_path, text, name="sim_config.gin"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _plain(x):
    """Config values with each package's dataclasses as plain dicts."""
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


def _same_config(tcfg, jcfg):
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "building":
            for g in dataclasses.fields(got):
                a, b = getattr(got, g.name), getattr(want, g.name)
                if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=g.name)
                else:
                    assert _plain(a) == _plain(b), g.name
        elif f.name == "weather":
            for g in dataclasses.fields(got):
                a, b = getattr(got, g.name), getattr(want, g.name)
                if g.name == "replay_csv_path":
                    with np.load(a) as x, np.load(b) as y:
                        assert sorted(x.files) == sorted(y.files)
                        for k in x.files:
                            np.testing.assert_array_equal(x[k], y[k])
                else:
                    assert _plain(a) == _plain(b), g.name
        else:
            assert _plain(got) == _plain(want), f.name


@pytest.fixture(scope="module")
def gin_path(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("gin"), GIN)


def test_bindings_equal_jax(gin_path):
    got, want = tgin.parse_gin_bindings(gin_path), jgin.parse_gin_bindings(gin_path)
    assert got == want
    assert got["air_handler_heating_setpoint"] == 286.0  # through the macro
    assert got["time_zone"] == "US/Eastern"
    assert got["SimulatorBuilding.simulator"] == "@TFSimulator()"
    assert len(got["histogram_parameters_tuples"]) == 2


def test_extractors_equal_jax(gin_path):
    b = tgin.parse_gin_bindings(gin_path)
    jb = jgin.parse_gin_bindings(gin_path)
    norms = tgin.extract_observation_normalization(b)
    assert norms == jgin.extract_observation_normalization(jb)
    assert norms["supply_air_flowrate_sensor"] == (0.5, 0.1) and len(norms) == 5
    effective = tgin.extract_observation_normalizer_map(b)
    assert effective == jgin.extract_observation_normalizer_map(jb)
    assert effective["supply_air_cooling_temperature_setpoint"] == effective[
        "supply_air_heating_temperature_setpoint"] == (289.329414, 3.186769)
    assert "supply_air_flowrate_sensor" not in effective and len(effective) == 5
    actions = tgin.extract_action_normalizers(b)
    assert _plain(actions) == _plain(jgin.extract_action_normalizers(jb))
    assert actions["supply_air_heating_temperature_setpoint"].max_normalized_value == 1.0


@pytest.mark.parametrize("text,solver", [(GIN, "jacobi"), (LEGACY, "gauss_seidel")],
                         ids=["tf_simulator", "flexible_geometries"])
def test_env_config_equal_jax(tmp_path, text, solver):
    path = _write(tmp_path, text)
    tcfg, jcfg = tgin.env_config_from_gin(path), jgin.env_config_from_gin(path)
    _same_config(tcfg, jcfg)
    assert tcfg.host_solver == solver
    assert tcfg.schedule.time_zone == "US/Eastern"
    assert tcfg.hvac.ahu_heating_setpoint == 286.0 and tcfg.iteration_limit == 60
    assert tcfg.convection.p == 0.8 and tcfg.convection.seed == 7


def test_env_steps_from_gin_within_field_atol_of_jax(gin_path):
    tenv = tbe.BuildingEnv(tgin.env_config_from_gin(gin_path), device="cpu")
    jenv = jbe.BuildingEnv(jgin.env_config_from_gin(gin_path))
    assert tenv.n_actions == jenv.n_actions == 2 and tenv.obs_dim == jenv.obs_dim
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jstates, jobs = jax.vmap(jenv.reset)(keys)
    tstates, tobs = tenv.reset(torch.as_tensor(np.asarray(keys, np.int64)))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=OUT_ATOL, rtol=0)
    actions = np.random.default_rng(4).uniform(-1, 1, (STEPS, B, tenv.n_actions)).astype(np.float32)
    jstep = jax.jit(lambda s, a: jenv.step_batched(s, a, use_pallas=False))
    for i in range(STEPS):
        jstates, jout = jstep(jstates, jnp.asarray(actions[i]))
        tstates, tout = tenv.step_batched(tstates, torch.as_tensor(actions[i]), solver="xla_jacobi")
        np.testing.assert_allclose(tstates.temp.numpy(), np.asarray(jstates.temp),
                                   atol=FIELD_ATOL, rtol=0, err_msg=f"step {i}")
        np.testing.assert_array_equal(tstates.hvac.thermostat_mode.numpy(),
                                      np.asarray(jstates.hvac.thermostat_mode))
        np.testing.assert_allclose(tout.observation.numpy(), np.asarray(jout.observation),
                                   atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward),
                                   atol=OUT_ATOL, rtol=0)
    assert rng.PRNGKey(3).tolist() == np.asarray(jax.random.PRNGKey(3)).tolist()


def test_unsupported_time_zone_raises(tmp_path):
    path = _write(tmp_path, GIN.replace("'US/Eastern'", "'Australia/Sydney'"))
    with pytest.raises(ValueError, match="Australia/Sydney"):
        tgin.env_config_from_gin(path)

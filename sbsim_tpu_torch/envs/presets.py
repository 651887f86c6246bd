"""Canonical configurations.

`sb1_config` mirrors the released calibrated office-building config
(configs/resources/sb1/sim_config.gin) including its z-score normalization
constants and histogram bins; `building_suite` is three calibrated-scale
buildings; `two_zone_test_config` is the tiny test building. Port of
sbsim_tpu/envs/presets.py: each function returns the same EnvConfigs field
for field, over the port's own copies of the packaged data.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import numpy as np

from sbsim_tpu_torch.core.geometry import (
    MaterialProperties,
    make_synthetic_office_plan,
    padded_grid_cost,
)
from sbsim_tpu_torch.envs.config import (
    BuildingConfig,
    ConvectionConfig,
    EnvConfig,
    HvacConfig,
    OccupancyConfig,
    RegretRewardConfig,
    ScheduleConfig,
    WeatherConfig,
)

# The EFFECTIVE calibrated z-score mapping of the released sb1 config: the
# 50 keys of observation_normalizer_map (sim_config.gin:527-583) resolved to
# their scoped (sample_mean, sample_variance) constants, extracted via
# gin_compat.extract_observation_normalizer_map and pinned against the
# reference gin by tests/golden/test_golden_misc.py. Matching is EXACT
# key match, else the value passes through unnormalized
# (observation_normalizer.py:61-66) — reference quirks preserved:
# - the map ALIASES keys onto shared scopes: 'supply_water_setpoint' uses the
#   supply_water_temperature_setpoint constants (gin:573),
#   'supply_air_cooling/heating_temperature_setpoint' use the
#   supply_air_temperature_setpoint constants (gin:567-568), and
#   'cooling_request_count' uses the request_count constants (gin:579);
# - many gin-declared scopes ('temperature', 'percentage', ...) are NOT wired
#   into the map, so fields like zone_air_temperature_sensor and
#   supply_air_flowrate_sensor reach the agent RAW — which is why the
#   zone-temperature histogram bins below are in plain Kelvin;
# - heating_request_count and supply_air_damper_percentage_command have no
#   entry either and also pass through raw.
SB1_OBSERVATION_NORMALIZATION: Mapping[str, Tuple[float, float]] = {
    "building_air_static_pressure_sensor": (3.779228, 14.599437),
    "building_air_static_pressure_setpoint": (7.472401, 0.0),
    "cooling_percentage_command": (9.658281, 295.833612),
    "cooling_request_count": (100.0, 25.0),
    "differential_pressure_sensor": (31611.814379, 1844378631.487996),
    "differential_pressure_setpoint": (83810.26954, 14889040.603647),
    "discharge_air_temperature_sensor": (69.889025, 541.455462),
    "discharge_air_temperature_setpoint": (57.665244, 97.254479),
    "exhaust_air_damper_percentage_command": (25.0, 0.0),
    "exhaust_air_damper_percentage_sensor": (10.680755, 539.207818),
    "exhaust_fan_speed_frequency_sensor": (4.273057, 138.559759),
    "exhaust_fan_speed_percentage_command": (7.121761, 384.888218),
    "heating_water_valve_percentage_command": (3.105189, 202.006249),
    "mixed_air_temperature_sensor": (293.71871, 12.517696),
    "mixed_air_temperature_setpoint": (288.218302, 3.186768),
    "outside_air_damper_percentage_command": (34.504101, 2053.149002),
    "outside_air_dewpoint_temperature_sensor": (285.774428, 2.50461),
    "outside_air_flowrate_sensor": (3.70193, 20.300565),
    "outside_air_flowrate_setpoint": (8.730134, 0.240364),
    "outside_air_relative_humidity_sensor": (71.799372, 172.388773),
    "outside_air_specificenthalpy_sensor": (60711.656343, 25491060.173822),
    "outside_air_temperature_sensor": (291.244931, 12.904175),
    "outside_air_wetbulb_temperature_sensor": (287.709943, 3.59426),
    "program_differential_pressure_setpoint": (83808.578375, 14897544.664858),
    "program_supply_air_static_pressure_setpoint": (163.396282, 1092.073231),
    "program_supply_air_temperature_setpoint": (289.490004, 2.854515),
    "program_supply_water_temperature_setpoint": (341.467705, 74.961483),
    "return_air_temperature_sensor": (295.602164, 11.30993),
    "return_water_temperature_sensor": (326.219913, 497.847788),
    "run_status": (-0.63834, 0.592523),
    "speed_frequency_sensor": (7.003487, 227.751249),
    "speed_percentage_command": (11.330966, 602.718159),
    "supervisor_supply_air_static_pressure_setpoint": (179.409052, 352.049768),
    "supervisor_supply_air_temperature_setpoint": (290.2, 9.66245),
    "supervisor_supply_water_temperature_setpoint": (332.164444, 1.534112),
    "supply_air_cooling_temperature_setpoint": (289.329414, 3.186769),
    "supply_air_heating_temperature_setpoint": (289.329414, 3.186769),
    "supply_air_static_pressure_sensor": (128.527912, 6679.599175),
    "supply_air_static_pressure_setpoint": (181.307432, 361.757966),
    "supply_air_temperature_sensor": (289.737939, 6.265837),
    "supply_air_temperature_setpoint": (289.329414, 3.186769),
    "supply_fan_run_status": (0.439849, 0.806533),
    "supply_fan_speed_frequency_sensor": (15.926249, 207.034194),
    "supply_fan_speed_percentage_command": (26.543748, 575.094979),
    "supply_water_setpoint": (320.261985, 240.195517),
    "supply_water_temperature_sensor": (321.520315, 658.413066),
    "zone_air_co2_concentration_sensor": (432.092062, 962.90384),
    "zone_air_co2_concentration_setpoint": (739.337708, 3618.117781),
    "zone_air_cooling_temperature_setpoint": (82.084227, 402.158853),
    "zone_air_heating_temperature_setpoint": (64.231868, 24.461668),
}

# Histogram bins (sim_config.gin:586-590).
SB1_HISTOGRAM_PARAMETERS: Mapping[str, Tuple[float, ...]] = {
    "zone_air_temperature_sensor": (
        285.0, 286.0, 287.0, 288.0, 289.0, 290.0, 291.0, 292.0, 293.0,
        294.0, 295.0, 296.0, 297.0, 298.0, 299.0, 300.0, 301.0, 302.0, 303.0,
    ),
    "supply_air_damper_percentage_command": (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    "supply_air_flowrate_setpoint": (
        0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.7, 0.9,
    ),
}

# sb1 material constants (sim_config.gin:45-86; note the gin file transposes
# heat_capacity and density for the interior walls - the values are identical
# for sb1 air so the effective grids match).
SB1_AIR = MaterialProperties(conductivity=50.0, heat_capacity=700.0, density=1.0)
SB1_WALL = MaterialProperties(conductivity=50.0, heat_capacity=1.0, density=700.0)
SB1_EXTERIOR = MaterialProperties(
    conductivity=0.05, heat_capacity=700.0, density=1.0
)


# The sb1 Moffett Field weather record (derived from the reference's
# local_weather_moffett_field_20230701_20231122.csv: epoch seconds + °F,
# exactly what ReplayWeatherController interpolates over), packaged so the
# calibrated default works standalone.
SB1_WEATHER_NPZ = os.path.join(
    os.path.dirname(__file__), "..", "data", "sb1_weather_moffett.npz"
)


def _interleave_width(floor_plan: np.ndarray, layout: str) -> int:
    """The JAX package's Pallas interleave width E for this plan (8 for
    planes of at most 7 padded (8, 128) tiles, else the widest of 4 or 2
    that its TPU memory model admits, else 1).

    Copied so that sb1_config fills pallas_block_envs exactly as the JAX
    package does; in the stack layout the CUDA block kernels take it as
    their envs per thread block, clamped to each kernel's measured best."""
    h, w = floor_plan.shape
    cost = padded_grid_cost((h, w))
    if layout in ("auto", "transposed"):
        t = padded_grid_cost((w, h))
        cost = min(cost, t) if layout == "auto" else t
    tiles = cost // (8 * 128)
    if tiles <= 7:
        return 8
    for e in (4, 2):
        if e * tiles * 0.1 <= 14.0:
            return e
    return 1


def _searched_convection(
    floor_plan: np.ndarray, p: float, distance: int
) -> ConvectionConfig:
    """ConvectionConfig carrying the plan's searched schedule, if any."""
    from sbsim_tpu_torch.scenario import conv_cache

    entry = conv_cache.lookup(floor_plan)
    if entry is not None:
        return ConvectionConfig(
            p=p,
            distance=distance,
            seed=int(entry["seed"]),
            rounds=int(entry["rounds"]),
        )
    return ConvectionConfig(p=p, distance=distance, seed=5)


def sb1_config(
    floor_plan: Optional[np.ndarray] = None,
    weather_csv: Optional[str] = None,
    num_days_in_episode: int = 14,
    convection_p: float = 1.0,
    convection_distance: int = 5,
    weather_kind: str = "replay",
    layout: str = "ref",
) -> EnvConfig:
    """The calibrated sb1 environment (sim_config.gin:15-614).

    Weather defaults to REPLAY of the real Moffett Field record — the
    reference's sb1 config wires ReplayWeatherController over this very CSV
    (sim_config.gin:31-34) — via the packaged npz. Pass `weather_csv` to
    replay a different record, or `weather_kind="sinusoid"` for the
    synthetic 273-283 K diurnal profile (WeatherController semantics).
    """
    default_plan = floor_plan is None
    if default_plan:
        floor_plan = make_synthetic_office_plan(
            n_rooms_x=3, n_rooms_y=4, room_cvs=14
        )
    if weather_csv or weather_kind == "replay":
        weather = WeatherConfig(
            kind="replay",
            replay_csv_path=weather_csv or os.path.abspath(SB1_WEATHER_NPZ),
            convection_coefficient=100.0,
        )
    elif weather_kind == "sinusoid":
        weather = WeatherConfig(
            kind="sinusoid",
            low_temp=273.0,
            high_temp=283.0,
            convection_coefficient=100.0,
        )
    else:
        raise ValueError(f"unknown weather_kind: {weather_kind!r}")
    return EnvConfig(
        building=BuildingConfig(
            kind="floor_plan",
            cv_size_cm=10.0,
            floor_height_cm=300.0,
            initial_temp=294.0,
            inside_air=SB1_AIR,
            inside_wall=SB1_WALL,
            building_exterior=SB1_EXTERIOR,
            floor_plan=floor_plan,
            buffer_from_walls=3,
            # "auto" transposes where geometry.padded_grid_cost shrinks
            # (the 126-room building); "ref" (default) keeps the plan
            # orientation.
            layout=layout,
        ),
        hvac=HvacConfig(
            vav_max_air_flow_rate=0.035,
            vav_reheat_max_water_flow_rate=0.03,
            ahu_recirculation=0.3,
            ahu_heating_setpoint=285.0,
            ahu_cooling_setpoint=298.0,
            ahu_fan_differential_pressure=10000.0,
            ahu_fan_efficiency=0.9,
            ahu_max_air_flow_rate=8.67,
            boiler_setpoint=360.0,
            boiler_pump_differential_head=6.0,
            boiler_pump_efficiency=0.98,
            boiler_heating_rate=0.5,
            boiler_cooling_rate=0.1,
        ),
        weather=weather,
        schedule=ScheduleConfig(
            morning_start_hour=6,
            evening_start_hour=19,
            comfort_temp_window=(294.0, 297.0),
            eco_temp_window=(289.0, 298.0),
            time_zone="US/Pacific",
        ),
        occupancy=OccupancyConfig(
            kind="randomized",
            zone_assignment=1,
            earliest_expected_arrival_hour=7,
            latest_expected_arrival_hour=12,
            earliest_expected_departure_hour=13,
            latest_expected_departure_hour=18,
            time_zone="US/Pacific",
        ),
        # Per-plan searched swap schedule (scenario/conv_cache); plans
        # that were never searched keep the auto-sized selection.
        convection=_searched_convection(
            floor_plan, convection_p, convection_distance
        ),
        reward=RegretRewardConfig(),
        start_timestamp="2023-07-06 07:00:00+00:00",
        time_step_sec=300.0,
        convergence_threshold=0.1,
        iteration_limit=100,
        # Sample the Chebyshev residual every 4 sub-iterations; the solve
        # only gets more converged. Jacobi paths are unaffected.
        cheby_check_every=4,
        # The JAX package's Pallas block layout, kept so configs match.
        pallas_block_envs=_interleave_width(floor_plan, layout),
        pallas_block_mode="interleave",
        num_days_in_episode=num_days_in_episode,
        discount_factor=0.9,
        observation_normalization=SB1_OBSERVATION_NORMALIZATION,
        histogram_parameters=SB1_HISTOGRAM_PARAMETERS,
        # The sb1 action space, expressed through the generic
        # device_action_tuples mechanism (sim_config.gin:228-244 wires
        # exactly these two setpoints).
        action_tuples=(
            ("boiler", "supply_water_setpoint"),
            ("air_handler", "supply_air_heating_temperature_setpoint"),
        ),
    )


def two_zone_test_config(
    num_days_in_episode: int = 1,
    occupancy_kind: str = "step_function",
) -> EnvConfig:
    """A tiny two-room building for fast deterministic tests (the analogue of
    simulator_building_test_lib.py:36-78)."""
    plan = np.full((9, 11), 2.0)
    plan[1:8, 1:10] = 1.0
    plan[2:7, 2:5] = 0.0
    plan[2:7, 6:9] = 0.0
    return EnvConfig(
        building=BuildingConfig(
            kind="floor_plan",
            cv_size_cm=20.0,
            floor_height_cm=250.0,
            initial_temp=294.0,
            inside_air=SB1_AIR,
            inside_wall=MaterialProperties(2.0, 500.0, 1800.0),
            building_exterior=SB1_EXTERIOR,
            floor_plan=plan,
            buffer_from_walls=0,
        ),
        weather=WeatherConfig(
            kind="sinusoid",
            low_temp=278.0,
            high_temp=288.0,
            convection_coefficient=12.0,
        ),
        occupancy=OccupancyConfig(kind=occupancy_kind),
        convection=ConvectionConfig(p=0.0, distance=0),
        num_days_in_episode=num_days_in_episode,
        observation_normalization=SB1_OBSERVATION_NORMALIZATION,
        histogram_parameters={},
    )


def building_suite(
    num_days_in_episode: int = 14,
    weather_csv: Optional[str] = None,
) -> list:
    """Three calibrated-scale office buildings with distinct geometries and
    weather profiles (the JAX package's multi-building suite, BASELINE.md
    config #3). Each entry is an independent EnvConfig; batch them with
    envs.suite.BuildingSuite."""
    import dataclasses

    plans = [
        make_synthetic_office_plan(3, 4, room_cvs=14),
        make_synthetic_office_plan(4, 3, room_cvs=12),
        make_synthetic_office_plan(2, 6, room_cvs=16),
    ]
    weathers = [
        WeatherConfig(kind="sinusoid", low_temp=273.0, high_temp=283.0,
                      convection_coefficient=100.0),
        WeatherConfig(kind="sinusoid", low_temp=278.0, high_temp=292.0,
                      convection_coefficient=100.0),
        WeatherConfig(kind="sinusoid", low_temp=268.0, high_temp=279.0,
                      convection_coefficient=100.0),
    ]
    configs = []
    for plan, weather in zip(plans, weathers):
        cfg = sb1_config(
            floor_plan=plan,
            weather_csv=weather_csv,
            num_days_in_episode=num_days_in_episode,
        )
        if weather_csv is None:
            cfg = dataclasses.replace(cfg, weather=weather)
        configs.append(cfg)
    return configs

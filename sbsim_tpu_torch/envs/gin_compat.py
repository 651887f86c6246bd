"""Reads calibration constants from the reference's gin config files.

Port of sbsim_tpu/envs/gin_compat.py over the port's presets and EnvConfig.
The reference wires everything through gin
(configs/resources/sb1/sim_config.gin); this loader parses the small gin
subset those files use (scalar/string/tuple bindings, %macro references,
scoped `set_*_normalization_constants` blocks and the normalizer maps) and
builds an EnvConfig carrying the same calibrated constants, so a user can
point the port directly at an existing gin calibration file.

This is a data-extraction parser, not a gin runtime: @configurable object
wiring is interpreted structurally for the known sb1 schema. The file's
`time_zone` must be one of scenario/tables.TIME_ZONES (the port carries its
own daylight-saving rules, no tz database); another zone raises ValueError
in env_config_from_gin.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from sbsim_tpu_torch.envs import presets
from sbsim_tpu_torch.envs.config import (
    ActionNormalizerConfig,
    ConvectionConfig,
    EnvConfig,
    HvacConfig,
    ScheduleConfig,
)
from sbsim_tpu_torch.scenario import tables


def _parse_value(raw: str, macros: Dict[str, Any]) -> Any:
    raw = raw.strip()
    if raw.startswith("%"):
        return macros.get(raw[1:], raw)
    if raw.startswith("@"):
        return raw  # configurable reference: handled structurally
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def parse_gin_bindings(path: str) -> Dict[str, Any]:
    """Flat dict of bindings: 'name' or 'scope/target.param' -> value."""
    bindings: Dict[str, Any] = {}
    macros: Dict[str, Any] = {}
    with open(path) as f:
        lines = f.readlines()

    # Join simple multi-line values (dicts/tuples spanning lines).
    joined: list = []
    buffer = ""
    depth = 0
    for line in lines:
        stripped = line.split("#", 1)[0].rstrip()
        if not stripped.strip():
            continue
        buffer = buffer + " " + stripped.strip() if buffer else stripped.strip()
        depth += (
            stripped.count("(") - stripped.count(")")
            + stripped.count("{") - stripped.count("}")
            + stripped.count("[") - stripped.count("]")
        )
        # Block-style bindings "Target: \n  param = value" are flattened by
        # tracking the pending block header.
        if depth <= 0 and "=" in buffer:
            joined.append(buffer)
            buffer = ""
            depth = 0
        elif depth <= 0 and buffer.endswith(":"):
            joined.append(buffer)
            buffer = ""
            depth = 0

    block_prefix: Optional[str] = None
    for item in joined:
        if item.endswith(":") and "=" not in item:
            block_prefix = item[:-1].strip()
            continue
        if "=" not in item:
            continue
        lhs, rhs = item.split("=", 1)
        lhs = lhs.strip()
        value = _parse_value(rhs, macros)
        is_ref = isinstance(value, str) and value.startswith("@")
        if "." not in lhs and "/" not in lhs:
            # Block-scoped params that reference configurables must not
            # clobber same-named top-level macros (e.g. TFSimulator's
            # start_timestamp = @sim/to_timestamp()).
            if not (is_ref and lhs in macros):
                macros[lhs] = value
                bindings[lhs] = value
        else:
            key = lhs
            if block_prefix and not any(c in lhs for c in "./"):
                key = f"{block_prefix}.{lhs}"
            bindings[key] = value
        # Block headers apply to following "param = value" lines that gin
        # writes indented; our joiner loses indentation, so block params are
        # detected as bare names with a pending block prefix.
        if block_prefix and "." not in lhs and "/" not in lhs:
            bindings[f"{block_prefix}.{lhs}"] = value
    return bindings


def extract_observation_normalization(
    bindings: Mapping[str, Any],
) -> Dict[str, Tuple[float, float]]:
    """field_id -> (mean, variance) from the scoped
    set_observation_normalization_constants blocks (sim_config.gin:252-583)."""
    scoped: Dict[str, Dict[str, Any]] = {}
    pattern = re.compile(
        r"^(?P<scope>[\w/]+)/set_observation_normalization_constants"
        r"\.(?P<param>\w+)$"
    )
    for key, value in bindings.items():
        m = pattern.match(key)
        if m:
            scoped.setdefault(m.group("scope"), {})[m.group("param")] = value
    out: Dict[str, Tuple[float, float]] = {}
    for params in scoped.values():
        fid = params.get("field_id")
        if fid is None:
            continue
        out[str(fid)] = (
            float(params.get("sample_mean", 0.0)),
            float(params.get("sample_variance", 0.0)),
        )
    return out


def extract_observation_normalizer_map(
    bindings: Mapping[str, Any],
) -> Dict[str, Tuple[float, float]]:
    """The EFFECTIVE normalization mapping: observation_normalizer_map KEYS
    -> (mean, variance) of the scope each key references
    (sim_config.gin:527-583).

    This — not the per-scope field_id — is what the reference's
    StandardScoreObservationNormalizer exact-matches against
    (observation_normalizer.py:61-66): the map aliases several keys onto
    shared scopes (e.g. 'supply_water_setpoint' ->
    supply_water_temperature_setpoint_normalizer, 'supply_air_cooling/
    heating_temperature_setpoint' -> supply_air_temperature_setpoint_
    normalizer, 'cooling_request_count' -> request_count_observation_
    normalizer) and leaves many gin-declared scopes unwired (their fields
    pass through raw — including zone_air_temperature_sensor).
    """
    scoped: Dict[str, Dict[str, Any]] = {}
    pattern = re.compile(
        r"^(?P<scope>[\w/]+)/set_observation_normalization_constants"
        r"\.(?P<param>\w+)$"
    )
    for key, value in bindings.items():
        m = pattern.match(key)
        if m:
            scoped.setdefault(m.group("scope"), {})[m.group("param")] = value
    mapping_raw = bindings.get("observation_normalizer_map", "")
    pairs = re.findall(
        r"['\"](?P<field>[\w]+)['\"]\s*:\s*@(?P<scope>[\w/]+)/"
        r"set_observation_normalization_constants",
        str(mapping_raw),
    )
    out: Dict[str, Tuple[float, float]] = {}
    for field, scope in pairs:
        params = scoped.get(scope)
        if params:
            out[str(field)] = (
                float(params.get("sample_mean", 0.0)),
                float(params.get("sample_variance", 0.0)),
            )
    return out


def extract_action_normalizers(
    bindings: Mapping[str, Any],
) -> Dict[str, ActionNormalizerConfig]:
    """setpoint -> bounds from set_action_normalization_constants blocks
    (sim_config.gin:228-242)."""
    scoped: Dict[str, Dict[str, Any]] = {}
    pattern = re.compile(
        r"^(?P<scope>[\w/]+)/set_action_normalization_constants"
        r"\.(?P<param>\w+)$"
    )
    for key, value in bindings.items():
        m = pattern.match(key)
        if m:
            scoped.setdefault(m.group("scope"), {})[m.group("param")] = value

    # The action_normalizer_map ties setpoint names to scopes. Its gin value
    # contains @configurable references, so it survives parsing as a raw
    # string; extract the ('setpoint', scope) pairs directly.
    mapping_raw = bindings.get("action_normalizer_map", "")
    pairs = re.findall(
        r"['\"](?P<setpoint>[\w]+)['\"]\s*:\s*@(?P<scope>[\w/]+)/"
        r"set_action_normalization_constants",
        str(mapping_raw),
    )
    out: Dict[str, ActionNormalizerConfig] = {}
    if pairs:
        for setpoint, scope in pairs:
            params = scoped.get(scope)
            if params:
                out[str(setpoint)] = ActionNormalizerConfig(
                    min_native_value=float(params["min_native_value"]),
                    max_native_value=float(params["max_native_value"]),
                    min_normalized_value=float(
                        params.get("min_normalized_value", -1.0)
                    ),
                    max_normalized_value=float(
                        params.get("max_normalized_value", 1.0)
                    ),
                )
    return out


def env_config_from_gin(
    path: str,
    floor_plan: Optional[np.ndarray] = None,
    weather_csv: Optional[str] = None,
) -> EnvConfig:
    """Builds an EnvConfig carrying the gin file's calibrated constants.

    Structural parameters (FDM settings, schedule hours, HVAC device
    constants, reward weights) are read from their gin macros; the floor plan
    itself must be supplied (the released blobs are absent from the
    snapshot).
    """
    b = parse_gin_bindings(path)

    def get(name, default):
        value = b.get(name, default)
        return value if not isinstance(value, str) else default

    hist_raw = b.get("histogram_parameters_tuples", ())
    histogram = {
        name: tuple(edges) for name, edges in hist_raw
    } if hist_raw else {}

    # Which simulator the file wires into SimulatorBuilding decides the
    # host-path solver semantics: TFSimulator (sim_config.gin:195) is the
    # f32 whole-grid Jacobi; SimulatorFlexibleGeometries
    # (sim_config_legacy.gin:208) is the f64 scalar Gauss-Seidel sweep.
    simulator_ref = str(b.get("SimulatorBuilding.simulator", ""))
    if "SimulatorFlexibleGeometries" in simulator_ref:
        host_solver = "gauss_seidel"
    else:
        host_solver = "jacobi"
    time_zone = str(b.get("time_zone", "US/Pacific"))
    if time_zone not in tables.TIME_ZONES:
        raise ValueError(
            f"{path}: time_zone {time_zone!r} is not supported; one of "
            f"{sorted(tables.TIME_ZONES)}"
        )

    cfg = presets.sb1_config(
        floor_plan=floor_plan, weather_csv=weather_csv
    )
    return dataclasses.replace(
        cfg,
        building=dataclasses.replace(
            cfg.building,
            cv_size_cm=float(get("control_volume_cm", 10.0)),
            floor_height_cm=float(get("floor_height_cm", 300.0)),
            initial_temp=float(get("initial_temp", 294.0)),
        ),
        hvac=HvacConfig(
            vav_max_air_flow_rate=float(get("vav_max_air_flowrate", 0.035)),
            vav_reheat_max_water_flow_rate=float(
                get("vav_reheat_water_flowrate", 0.03)
            ),
            ahu_recirculation=float(
                get("air_handler_recirculation_ratio", 0.3)
            ),
            ahu_heating_setpoint=float(
                get("air_handler_heating_setpoint", 285.0)
            ),
            ahu_cooling_setpoint=float(
                get("air_handler_cooling_setpoint", 298.0)
            ),
            ahu_fan_differential_pressure=float(
                get("fan_differential_pressure", 10000.0)
            ),
            ahu_fan_efficiency=float(get("fan_efficiency", 0.9)),
            boiler_setpoint=float(get("reheat_water_setpoint", 360.0)),
            boiler_pump_differential_head=float(
                get("water_pump_differential_head", 6.0)
            ),
            boiler_pump_efficiency=float(get("water_pump_efficiency", 0.98)),
            boiler_heating_rate=float(get("boiler_heating_rate", 0.5)),
            boiler_cooling_rate=float(get("boiler_cooling_rate", 0.1)),
        ),
        schedule=ScheduleConfig(
            morning_start_hour=int(get("morning_start_hour", 6)),
            evening_start_hour=int(get("evening_start_hour", 19)),
            comfort_temp_window=(
                float(get("heating_setpoint_day", 294.0)),
                float(get("cooling_setpoint_day", 297.0)),
            ),
            eco_temp_window=(
                float(get("heating_setpoint_night", 289.0)),
                float(get("cooling_setpoint_night", 298.0)),
            ),
            time_zone=time_zone,
        ),
        convection=ConvectionConfig(
            p=float(get("StochasticConvectionSimulator.p", 1.0)),
            distance=int(get("StochasticConvectionSimulator.distance", 5)),
            seed=int(get("StochasticConvectionSimulator.seed", 5)),
        ),
        reward=dataclasses.replace(
            cfg.reward,
            max_productivity_personhour_usd=float(
                get("max_productivity_personhour_usd", 300.0)
            ),
            min_productivity_personhour_usd=float(
                get("min_productivity_personhour_usd", 100.0)
            ),
            max_electricity_rate=float(get("max_electricity_rate", 160000.0)),
            max_natural_gas_rate=float(get("max_natural_gas_rate", 400000.0)),
            productivity_midpoint_delta=float(
                get("productivity_midpoint_delta", 0.5)
            ),
            productivity_decay_stiffness=float(
                get("productivity_decay_stiffness", 4.3)
            ),
            productivity_weight=float(get("productivity_weight", 0.2)),
            energy_cost_weight=float(get("energy_cost_weight", 0.4)),
            carbon_emission_weight=float(get("carbon_emission_weight", 0.4)),
        ),
        host_solver=host_solver,
        start_timestamp=str(
            b.get("start_timestamp", "2023-07-06 07:00:00+00:00")
        ),
        time_step_sec=float(get("time_step_sec", 300.0)),
        convergence_threshold=float(get("convergence_threshold", 0.1)),
        iteration_limit=int(get("iteration_limit", 100)),
        num_days_in_episode=int(get("num_days_in_episode", 14)),
        discount_factor=float(get("discount_factor", 0.9)),
        observation_normalization=(
            extract_observation_normalizer_map(b)
            or cfg.observation_normalization
        ),
        histogram_parameters=histogram or cfg.histogram_parameters,
        action_normalizers=(
            extract_action_normalizers(b) or cfg.action_normalizers
        ),
    )

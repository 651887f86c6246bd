"""HVAC parameters and batched HVAC state.

Port of sbsim_tpu/hvac/params.py. Parameters are 0-d / (Z,) float32 tensors
shared by the batch (kept as tensors, not Python floats, so every product
rounds in float32 exactly where the JAX package's does). The state is a
dataclass of tensors with a leading env-batch dimension B.

Parity sources: vav.py:29-286, air_handler.py:29-320, boiler.py:30-333,
thermostat.py:39-148 in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

# Thermostat modes (thermostat.py:52-66).
MODE_OFF = 0
MODE_HEAT = 1
MODE_COOL = 2
MODE_PASSIVE_COOL = 3


@dataclasses.dataclass(frozen=True)
class HvacParams:
    """Static HVAC configuration (shared across the env batch)."""

    # VAV (vav.py:45-92). Per-zone vectors to allow heterogeneous buildings.
    vav_max_air_flow_rate: torch.Tensor  # f32 (Z,) kg/s
    vav_reheat_max_water_flow_rate: torch.Tensor  # f32 (Z,) m3/s

    # Air handler (air_handler.py:47-135).
    ahu_recirculation: torch.Tensor  # f32 0-d
    ahu_max_air_flow_rate: torch.Tensor  # f32 0-d
    ahu_fan_differential_pressure: torch.Tensor  # f32 0-d, Pa
    ahu_fan_efficiency: torch.Tensor  # f32 0-d
    ahu_init_heating_setpoint: torch.Tensor  # f32 0-d, K
    ahu_init_cooling_setpoint: torch.Tensor  # f32 0-d, K

    # Boiler (boiler.py:54-110).
    boiler_init_setpoint: torch.Tensor  # f32 0-d, K
    boiler_pump_differential_head: torch.Tensor  # f32 0-d, m
    boiler_pump_efficiency: torch.Tensor  # f32 0-d
    boiler_heating_rate: torch.Tensor  # f32 0-d, K/min
    boiler_cooling_rate: torch.Tensor  # f32 0-d, K/min
    boiler_convection_coefficient: torch.Tensor  # f32 0-d, W/m2/K
    boiler_tank_length: torch.Tensor  # f32 0-d, m
    boiler_tank_radius: torch.Tensor  # f32 0-d, m
    boiler_water_capacity: torch.Tensor  # f32 0-d, m3
    boiler_insulation_conductivity: torch.Tensor  # f32 0-d, W/m/K
    boiler_insulation_thickness: torch.Tensor  # f32 0-d, m


def make_hvac_params(
    n_zones: int,
    *,
    vav_max_air_flow_rate: float,
    vav_reheat_max_water_flow_rate: float,
    ahu_recirculation: float,
    ahu_heating_setpoint: float,
    ahu_cooling_setpoint: float,
    ahu_fan_differential_pressure: float,
    ahu_fan_efficiency: float,
    ahu_max_air_flow_rate: float = 8.67,
    boiler_setpoint: float = 360.0,
    boiler_pump_differential_head: float = 6.0,
    boiler_pump_efficiency: float = 0.98,
    boiler_heating_rate: float = 0.0,
    boiler_cooling_rate: float = 0.0,
    boiler_convection_coefficient: float = 5.6,
    boiler_tank_length: float = 2.0,
    boiler_tank_radius: float = 0.5,
    boiler_water_capacity: float = 1.5,
    boiler_insulation_conductivity: float = 0.067,
    boiler_insulation_thickness: float = 0.06,
    device=None,
) -> HvacParams:
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return HvacParams(
        vav_max_air_flow_rate=torch.full(
            (n_zones,), vav_max_air_flow_rate, dtype=torch.float32,
            device=device,
        ),
        vav_reheat_max_water_flow_rate=torch.full(
            (n_zones,), vav_reheat_max_water_flow_rate, dtype=torch.float32,
            device=device,
        ),
        ahu_recirculation=f(ahu_recirculation),
        ahu_max_air_flow_rate=f(ahu_max_air_flow_rate),
        ahu_fan_differential_pressure=f(ahu_fan_differential_pressure),
        ahu_fan_efficiency=f(ahu_fan_efficiency),
        ahu_init_heating_setpoint=f(ahu_heating_setpoint),
        ahu_init_cooling_setpoint=f(ahu_cooling_setpoint),
        boiler_init_setpoint=f(boiler_setpoint),
        boiler_pump_differential_head=f(boiler_pump_differential_head),
        boiler_pump_efficiency=f(boiler_pump_efficiency),
        boiler_heating_rate=f(boiler_heating_rate),
        boiler_cooling_rate=f(boiler_cooling_rate),
        boiler_convection_coefficient=f(boiler_convection_coefficient),
        boiler_tank_length=f(boiler_tank_length),
        boiler_tank_radius=f(boiler_tank_radius),
        boiler_water_capacity=f(boiler_water_capacity),
        boiler_insulation_conductivity=f(boiler_insulation_conductivity),
        boiler_insulation_thickness=f(boiler_insulation_thickness),
    )


@dataclasses.dataclass(frozen=True)
class HvacState:
    """HVAC state of a batch of B envs (JAX's per-env HvacState with an
    explicit leading batch dimension)."""

    # VAV / thermostat, per zone.
    damper: torch.Tensor  # f32 (B, Z) in [0, 1]
    reheat_valve: torch.Tensor  # f32 (B, Z) in [0, 1]
    thermostat_mode: torch.Tensor  # i32 (B, Z)
    zone_air_temp: torch.Tensor  # f32 (B, Z) last temp given to the VAV
    prev_comfort: torch.Tensor  # bool (B,): previous update in comfort mode

    # Air handler.
    ahu_air_flow_rate: torch.Tensor  # f32 (B,), accumulated demand
    ahu_cooling_request_count: torch.Tensor  # i32 (B,)
    ahu_heating_setpoint: torch.Tensor  # f32 (B,) (agent action)
    ahu_cooling_setpoint: torch.Tensor  # f32 (B,) (agent action)

    # Boiler.
    boiler_setpoint: torch.Tensor  # f32 (B,) (agent action)
    boiler_current_temp: torch.Tensor  # f32 (B,), ramped measured supply temp
    boiler_return_water_temp: torch.Tensor  # f32 (B,)
    boiler_total_flow_rate: torch.Tensor  # f32 (B,), accumulated demand
    boiler_heating_request_count: torch.Tensor  # i32 (B,)
    boiler_tank_temp_change: torch.Tensor  # f32 (B,), last obs-phase ramp delta
    boiler_last_step_duration: torch.Tensor  # f32 (B,), seconds
    boiler_has_action: torch.Tensor  # bool (B,): an action timestamp exists

    def replace(self, **changes) -> "HvacState":
        return dataclasses.replace(self, **changes)


def initial_hvac_state(params: HvacParams, batch: int) -> HvacState:
    """Reset state of `batch` envs (vav.py:93-99, air_handler.py:127-135,
    boiler.py:112-123)."""
    n_zones = params.vav_max_air_flow_rate.shape[0]
    device = params.vav_max_air_flow_rate.device
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    flag = dict(dtype=torch.bool, device=device)
    per_env = lambda x: x.expand(batch).clone()
    return HvacState(
        damper=torch.full((batch, n_zones), 0.1, **f32),
        reheat_valve=torch.zeros((batch, n_zones), **f32),
        thermostat_mode=torch.full((batch, n_zones), MODE_OFF, **i32),
        zone_air_temp=torch.zeros((batch, n_zones), **f32),
        prev_comfort=torch.zeros((batch,), **flag),
        ahu_air_flow_rate=torch.zeros((batch,), **f32),
        ahu_cooling_request_count=torch.zeros((batch,), **i32),
        ahu_heating_setpoint=per_env(params.ahu_init_heating_setpoint),
        ahu_cooling_setpoint=per_env(params.ahu_init_cooling_setpoint),
        boiler_setpoint=per_env(params.boiler_init_setpoint),
        boiler_current_temp=per_env(params.boiler_init_setpoint),
        boiler_return_water_temp=torch.zeros((batch,), **f32),
        boiler_total_flow_rate=torch.zeros((batch,), **f32),
        boiler_heating_request_count=torch.zeros((batch,), **i32),
        boiler_tank_temp_change=torch.zeros((batch,), **f32),
        boiler_last_step_duration=torch.zeros((batch,), **f32),
        boiler_has_action=torch.zeros((batch,), **flag),
    )

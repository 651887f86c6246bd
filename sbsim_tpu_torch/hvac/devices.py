"""Batched HVAC device transitions: thermostat, VAV, air handler, boiler.

Port of sbsim_tpu/hvac/devices.py with an explicit leading batch dimension
in place of vmap: per-zone quantities are (B, Z) and per-env scalars (B,);
functions that combine the two broadcast the scalars over zones themselves.
The arithmetic follows the JAX package op for op.

Parity sources are cited per function.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from sbsim_tpu_torch import constants
from sbsim_tpu_torch.hvac.params import (
    HvacParams,
    HvacState,
    MODE_COOL,
    MODE_HEAT,
    MODE_OFF,
    MODE_PASSIVE_COOL,
)

CP_AIR = float(constants.AIR_HEAT_CAPACITY)
CP_WATER = float(constants.WATER_HEAT_CAPACITY)


def _zones(x: torch.Tensor) -> torch.Tensor:
    """(B,) per-env scalar -> (B, 1), broadcasting over zones."""
    return x.unsqueeze(-1)


def thermostat_update(
    mode: torch.Tensor,
    zone_temp: torch.Tensor,
    heating_setpoint: torch.Tensor,
    cooling_setpoint: torch.Tensor,
    comfort_now: torch.Tensor,
    prev_comfort: torch.Tensor,
) -> torch.Tensor:
    """4-mode deadband state machine with eco passive-cool entry.

    Parity: thermostat.py:76-148. `heating/cooling_setpoint` (B,) are the
    window for the current schedule mode (comfort or eco); mode and
    zone_temp are (B, Z).
    """
    heat_sp = _zones(heating_setpoint)
    cool_sp = _zones(cooling_setpoint)
    mid = 0.5 * (cool_sp - heat_sp) + heat_sp
    const = lambda m: torch.full_like(mode, m)
    default_mode = torch.where(
        zone_temp < heat_sp,
        const(MODE_HEAT),
        torch.where(
            zone_temp > cool_sp,
            const(MODE_COOL),
            torch.where(
                (zone_temp < mid) & (mode == MODE_HEAT),
                const(MODE_HEAT),
                torch.where(
                    (zone_temp > mid) & (mode == MODE_COOL),
                    const(MODE_COOL),
                    const(MODE_OFF),
                ),
            ),
        ),
    )
    stay_passive = (mode == MODE_PASSIVE_COOL) & (zone_temp > heat_sp)
    eco_mode = torch.where(
        _zones(prev_comfort) | stay_passive,
        const(MODE_PASSIVE_COOL),
        default_mode,
    )
    return torch.where(_zones(comfort_now), default_mode, eco_mode)


def vav_settings_for_mode(
    mode: torch.Tensor, damper: torch.Tensor, reheat_valve: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thermostat mode -> (damper, reheat valve) settings (vav.py:219-243)."""
    is_heat = mode == MODE_HEAT
    is_cool = mode == MODE_COOL
    is_vent = (mode == MODE_OFF) | (mode == MODE_PASSIVE_COOL)
    new_damper = torch.where(
        is_heat | is_cool, 1.0, torch.where(is_vent, 0.1, damper)
    )
    new_valve = torch.where(
        is_heat, 1.0, torch.where(is_cool | is_vent, 0.0, reheat_valve)
    )
    return new_damper, new_valve


def vav_zone_supply_temp(
    supply_air_temp: torch.Tensor,
    water_temp: torch.Tensor,
    damper: torch.Tensor,
    reheat_valve: torch.Tensor,
    params: HvacParams,
) -> torch.Tensor:
    """Air temp delivered to the zone after reheat (vav.py:168-195)."""
    reheat_flow = reheat_valve * params.vav_reheat_max_water_flow_rate
    air_flow = damper * params.vav_max_air_flow_rate
    heat_difference = CP_AIR * air_flow - CP_WATER * reheat_flow
    input_water_heat = _zones(water_temp) * CP_WATER * reheat_flow
    return (
        (_zones(supply_air_temp) * heat_difference + input_water_heat)
        / air_flow
        / CP_AIR
    )


def vav_output(
    zone_temp: torch.Tensor,
    supply_air_temp: torch.Tensor,
    water_temp: torch.Tensor,
    damper: torch.Tensor,
    reheat_valve: torch.Tensor,
    params: HvacParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q_zone, zone_supply_temp), each (B, Z) (vav.py:197-264).

    The water temperature is the boiler *setpoint*, not the ramped measured
    temperature (vav.py:259).
    """
    zone_supply_temp = vav_zone_supply_temp(
        supply_air_temp, water_temp, damper, reheat_valve, params
    )
    air_flow = damper * params.vav_max_air_flow_rate
    q_zone = air_flow * CP_AIR * (zone_supply_temp - zone_temp)
    # damper == 0 -> no output (vav.py:207-208).
    q_zone = torch.where(air_flow > 0, q_zone, 0.0)
    return q_zone, zone_supply_temp


def ahu_mixed_air_temp(
    recirculation_temp: torch.Tensor,
    ambient_temp: torch.Tensor,
    params: HvacParams,
) -> torch.Tensor:
    """air_handler.py:204-216."""
    r = params.ahu_recirculation
    return r * recirculation_temp + (1.0 - r) * ambient_temp


def ahu_supply_air_temp(
    recirculation_temp: torch.Tensor,
    ambient_temp: torch.Tensor,
    heating_setpoint: torch.Tensor,
    cooling_setpoint: torch.Tensor,
    params: HvacParams,
) -> torch.Tensor:
    """Mixed air clamped to the heating/cooling setpoints
    (air_handler.py:218-233)."""
    mixed = ahu_mixed_air_temp(recirculation_temp, ambient_temp, params)
    return torch.minimum(torch.maximum(mixed, heating_setpoint), cooling_setpoint)


def ahu_accumulate_demand(
    flow_rate_demands: torch.Tensor, params: HvacParams
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sums positive VAV flow demands, clamped at the AHU max
    (air_handler.py:250-268). Returns (air_flow_rate, cooling_request_count).
    """
    positive = flow_rate_demands > 0
    total = torch.where(positive, flow_rate_demands, 0.0).sum(dim=-1)
    flow = torch.minimum(total, params.ahu_max_air_flow_rate)
    count = positive.sum(dim=-1).to(torch.int32)
    return flow, count


def ahu_fan_power(flow_rate: torch.Tensor, params: HvacParams) -> torch.Tensor:
    """air_handler.py:287-304."""
    return (
        flow_rate
        * params.ahu_fan_differential_pressure
        / params.ahu_fan_efficiency
    )


def ahu_blower_power(state: HvacState, params: HvacParams) -> torch.Tensor:
    """Intake fan (full flow) + exhaust fan (non-recirculated flow)
    (air_handler.py:306-320)."""
    intake = ahu_fan_power(state.ahu_air_flow_rate, params)
    exhaust = ahu_fan_power(
        state.ahu_air_flow_rate * (1.0 - params.ahu_recirculation), params
    )
    return intake + exhaust


def ahu_thermal_energy_rate(
    state: HvacState,
    recirculation_temp: torch.Tensor,
    ambient_temp: torch.Tensor,
    params: HvacParams,
) -> torch.Tensor:
    """Energy to move mixed air to the supply temp (air_handler.py:270-285)."""
    mixed = ahu_mixed_air_temp(recirculation_temp, ambient_temp, params)
    supply = ahu_supply_air_temp(
        recirculation_temp,
        ambient_temp,
        state.ahu_heating_setpoint,
        state.ahu_cooling_setpoint,
        params,
    )
    return state.ahu_air_flow_rate * CP_AIR * (supply - mixed)


def boiler_accumulate_demand(
    reheat_demands: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sums positive VAV reheat demands (boiler.py:219-231)."""
    positive = reheat_demands > 0
    total = torch.where(positive, reheat_demands, 0.0).sum(dim=-1)
    count = positive.sum(dim=-1).to(torch.int32)
    return total, count


def boiler_observe_supply_temp(
    state: HvacState, params: HvacParams, dt_sec: torch.Tensor
) -> HvacState:
    """Ramps the measured supply-water temp toward the setpoint.

    The reference ramps lazily when the supply_water_temperature_sensor is
    observed, using (observation_ts - action_ts) (boiler.py:158-217). In the
    env loop that gap is exactly one time step after the first action; before
    any action the duration is zero. `dt_sec` is a float32 0-d tensor.
    """
    dur = torch.where(
        state.boiler_has_action, dt_sec, state.boiler_last_step_duration
    )
    rates_set = (params.boiler_heating_rate > 0.0) & (
        params.boiler_cooling_rate > 0.0
    )
    begin = state.boiler_current_temp
    target = state.boiler_setpoint
    heated = torch.minimum(
        begin + params.boiler_heating_rate * dur / 60.0, target
    )
    cooled = torch.maximum(
        begin - params.boiler_cooling_rate * dur / 60.0, target
    )
    ramped = torch.where(
        target > begin, heated, torch.where(target < begin, cooled, target)
    )
    new_temp = torch.where(rates_set, ramped, target)
    tank_change = torch.where(
        rates_set, new_temp - begin, state.boiler_tank_temp_change
    )
    return state.replace(
        boiler_current_temp=new_temp,
        boiler_tank_temp_change=tank_change,
        boiler_last_step_duration=dur,
        boiler_has_action=torch.ones_like(state.boiler_has_action),
    )


def boiler_thermal_dissipation_rate(
    water_temp: torch.Tensor, outside_temp: torch.Tensor, params: HvacParams
) -> torch.Tensor:
    """Cylindrical-annulus tank loss solved in closed form (boiler.py:275-320)."""
    delta = water_temp - outside_temp
    numerator = params.boiler_tank_length * 2.0 * math.pi * delta
    r1 = params.boiler_tank_radius
    r2 = r1 + params.boiler_insulation_thickness
    conduction = torch.log(r2 / r1) / params.boiler_insulation_conductivity
    convection = 1.0 / params.boiler_convection_coefficient / r2
    return numerator / (conduction + convection)


def boiler_thermal_energy_rate(
    state: HvacState, outside_temp: torch.Tensor, params: HvacParams
) -> torch.Tensor:
    """Flow heating + tank dissipation + tank heat-up (boiler.py:233-273)."""
    return_temp = state.boiler_return_water_temp
    supply_temp = torch.maximum(state.boiler_setpoint, return_temp)
    flow_heating = CP_WATER * state.boiler_total_flow_rate * (
        supply_temp - return_temp
    )
    dissipation = boiler_thermal_dissipation_rate(
        supply_temp, outside_temp, params
    )
    tank_heating = torch.where(
        state.boiler_last_step_duration > 0,
        CP_WATER
        * params.boiler_water_capacity
        * state.boiler_tank_temp_change
        / torch.clamp(state.boiler_last_step_duration, min=1e-9),
        0.0,
    )
    return flow_heating + dissipation + tank_heating


def boiler_pump_power(state: HvacState, params: HvacParams) -> torch.Tensor:
    """boiler.py:322-333."""
    return (
        state.boiler_total_flow_rate
        * constants.WATER_DENSITY
        * constants.GRAVITY
        * params.boiler_pump_differential_head
        / params.boiler_pump_efficiency
    )


def return_water_temperature(
    reheat_valves: torch.Tensor, zone_supply_temps: torch.Tensor
) -> torch.Tensor:
    """Reheat-weighted mean zone supply temp (simulator.py:373-381)."""
    numerator = (reheat_valves * zone_supply_temps).sum(dim=-1)
    denominator = reheat_valves.sum(dim=-1)
    return numerator / (denominator + 1e-6)

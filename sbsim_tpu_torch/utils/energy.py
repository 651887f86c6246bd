"""Psychrometrics and device power models for real-building telemetry.

Port of sbsim_tpu/utils/energy.py, which is numpy already; the constants
come from the port's own constants module.

Vectorized numpy implementations of the energy-estimation toolkit the
reference provides for analyzing *real* building telemetry
(smart_control/utils/energy_utils.py:24-588): water-vapor saturation,
humidity ratio, moist-air conditioning energy, fan/pump affinity-law power,
compressor power (thermal and utilization methods), and water-loop heating
rates. Formulas follow the cited public sources (Baehr, Thermodynamik 1992;
engineering-toolbox affinity laws).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from sbsim_tpu_torch import constants

# Water saturation pressure table, -40C..70C in 10 K steps
# (Baehr, Thermodynamik 1992, Tabelle 5.4, p. 213; mbar).
_SATURATION_TEMPS_K = np.array([t + 273.0 for t in range(-40, 80, 10)])
_SATURATION_PRESSURES_MBAR = np.array([
    0.1285, 0.3802, 1.0328, 2.5992, 6.1115, 12.279,
    23.385, 42.452, 73.813, 123.448, 199.33, 311.77,
])

FAN_SPEED_OPERATIONAL_THRESHOLD_PCT = 5.0
SUPPLY_STATIC_PRESSURE_OPERATIONAL_THRESHOLD = 0.2
DEFAULT_EER = 12.0
_WATTS_PER_HP_KW = 0.746  # kW per horsepower


def water_vapor_partial_pressure(temps_k: Sequence[float]) -> np.ndarray:
    """Saturation partial pressure of water vapor [mbar] at temps [K]."""
    return np.interp(temps_k, _SATURATION_TEMPS_K, _SATURATION_PRESSURES_MBAR)


def humidity_ratio(
    temps_k: Sequence[float],
    relative_humidities: Sequence[float],
    pressures_bar: Sequence[float],
) -> np.ndarray:
    """Water-to-dry-air mass ratio [kg/kg] (Baehr Gl. 5.26)."""
    temps_k = np.asarray(temps_k, float)
    rh = np.asarray(relative_humidities, float)
    p = np.asarray(pressures_bar, float)
    psat_bar = water_vapor_partial_pressure(temps_k) / 1000.0
    return 0.622 * psat_bar / (p / rh - psat_bar)


def air_conditioning_energy_rate(
    *,
    air_flow_rates: Sequence[float],
    outside_temps: Sequence[float],
    outside_relative_humidities: Sequence[float],
    supply_temps: Sequence[float],
    ambient_pressures: Sequence[float],
) -> np.ndarray:
    """Thermal power [W] to bring moist outside air to the supply temp
    (isobaric, no (de)humidification; Baehr Beispiel 5.6)."""
    m = np.asarray(air_flow_rates, float)
    t_out = np.asarray(outside_temps, float)
    t_sup = np.asarray(supply_temps, float)
    x = humidity_ratio(
        t_out, outside_relative_humidities, ambient_pressures
    )
    cp = constants.AIR_HEAT_CAPACITY + x * constants.WATER_VAPOR_HEAT_CAPACITY
    return m * cp * (t_sup - t_out)


def fan_power(
    *,
    design_hp: Optional[float] = None,
    brake_hp: Optional[float] = None,
    fan_speed_percentage: Optional[float] = None,
    supply_static_pressure: Optional[float] = None,
    motor_factor: Optional[float] = None,
    num_fans: int = 1,
) -> float:
    """Fan power [kW] from nameplate horsepower and the 2.5-power affinity
    law; zero when the supply static pressure says the fan is off."""
    if design_hp is None and brake_hp is None:
        raise ValueError("Provide design_hp or brake_hp.")
    if fan_speed_percentage is None:
        fan_speed_percentage = 100.0
    if motor_factor is None:
        motor_factor = 0.85
    hp = brake_hp if brake_hp else motor_factor * design_hp
    operational = float(
        supply_static_pressure is None
        or supply_static_pressure
        >= SUPPLY_STATIC_PRESSURE_OPERATIONAL_THRESHOLD
    )
    return (
        hp
        * _WATTS_PER_HP_KW
        * (fan_speed_percentage / 100.0) ** 2.5
        * operational
        * num_fans
    )


def air_volumetric_flowrate(
    *, average_fan_speed_percentage: float, design_cfm: float
) -> float:
    """AHU volumetric flow [cfm] = design flow x fan speed fraction."""
    return design_cfm * average_fan_speed_percentage / 100.0


def compressor_power_thermal(
    *,
    mixed_air_temp: float,
    supply_air_temp: float,
    volumetric_flow_rate: float,
    fan_speed_percentage: float = 100.0,
    eer: float = DEFAULT_EER,
    fan_heat_temp: float = 0.0,
) -> float:
    """Compressor power [kW], thermal method: 1.08 * cfm * dT(F) / 12000
    tons, times 12/EER kW per ton; zero when the fan is off."""
    operational = float(
        fan_speed_percentage >= FAN_SPEED_OPERATIONAL_THRESHOLD_PCT
    )
    kw_per_ton = 12.0 / eer
    return (
        1.08
        * volumetric_flow_rate
        * (mixed_air_temp - supply_air_temp + fan_heat_temp)
        * operational
        / 12000.0
        * kw_per_ton
    )


def compressor_power_utilization(
    *,
    design_capacity: float,
    cooling_percentage: Optional[float] = None,
    count_stages_on: Optional[int] = None,
    total_stages: Optional[int] = None,
    eer: Optional[float] = None,
) -> float:
    """Compressor power [kW], utilization method: stage/percentage
    utilization x design tons x 12/EER."""
    if eer is None:
        eer = DEFAULT_EER
    if cooling_percentage is not None:
        if not 0.0 <= cooling_percentage <= 100.0:
            raise ValueError("cooling_percentage must be within [0, 100].")
        utilization = cooling_percentage / 100.0
    elif total_stages is not None and count_stages_on is not None:
        if total_stages <= 0:
            raise ValueError("total_stages must be positive.")
        if count_stages_on < 0 or count_stages_on > total_stages:
            raise ValueError("count_stages_on must be in [0, total_stages].")
        utilization = count_stages_on / total_stages
    else:
        raise ValueError(
            "Provide cooling_percentage or (count_stages_on, total_stages)."
        )
    return utilization * design_capacity * (12.0 / eer)


def water_pump_power(
    *,
    pump_duty_cycle: float,
    pump_speed_percentage: float = 100.0,
    brake_horse_power: Optional[float] = None,
    design_motor_horse_power: Optional[float] = None,
    motor_factor: float = 0.85,
    num_pumps: int = 1,
) -> float:
    """Pump power [kW] from nameplate horsepower + affinity law."""
    if brake_horse_power is None and design_motor_horse_power is None:
        raise ValueError(
            "Provide brake_horse_power or design_motor_horse_power."
        )
    hp = (
        brake_horse_power
        if brake_horse_power
        else design_motor_horse_power * motor_factor
    )
    return (
        hp
        * _WATTS_PER_HP_KW
        * (pump_speed_percentage / 100.0) ** 2.5
        * pump_duty_cycle
        * num_pumps
    )


def water_volumetric_flow_rate(
    *,
    design_flow_rate: float,
    pump_speed_percentage: float,
    num_pumps_on: int = 1,
) -> float:
    """Water flow [gpm] = pumps x speed fraction x design flow."""
    return num_pumps_on * (pump_speed_percentage / 100.0) * design_flow_rate


def water_heating_energy_rate(
    *,
    volumetric_flow_rate: float,
    supply_water_temperature: float,
    return_water_temperature: float,
) -> float:
    """Hydronic loop load [BTU/hr] = 500 * gpm * dT(F), clamped at 0."""
    return max(
        0.0,
        500.0
        * volumetric_flow_rate
        * (supply_water_temperature - return_water_temperature),
    )


def water_heating_energy_rate_primary(
    *,
    design_boiler_flow_rate: float,
    boiler_outlet_temperature: float,
    return_water_temperature: float,
    num_active_boilers: int = 1,
) -> float:
    """Primary-loop boiler load [BTU/hr]."""
    return water_heating_energy_rate(
        volumetric_flow_rate=design_boiler_flow_rate * num_active_boilers,
        supply_water_temperature=boiler_outlet_temperature,
        return_water_temperature=return_water_temperature,
    )


def water_heating_energy_rate_primary_secondary(
    *,
    design_primary_boiler_flow_rate: float,
    design_secondary_boiler_flow_rate: float,
    boiler_outlet_temperature: float,
    return_water_temperature: float,
    num_active_boilers: int = 1,
) -> float:
    """Primary/secondary loop load [BTU/hr]: the secondary loop sees the
    smaller of the two design flows."""
    flow = (
        min(design_primary_boiler_flow_rate, design_secondary_boiler_flow_rate)
        * num_active_boilers
    )
    return water_heating_energy_rate(
        volumetric_flow_rate=flow,
        supply_water_temperature=boiler_outlet_temperature,
        return_water_temperature=return_water_temperature,
    )

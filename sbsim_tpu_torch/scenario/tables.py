"""Per-step lookup tables: all calendar/timezone/tariff logic, precomputed.

The device program is pure tensor math; anything that depends on wall-clock
time (comfort schedules, holidays, DST, TOU tariffs, occupancy windows,
weather, time-of-day features) is folded host-side into arrays indexed by the
episode step counter. Tables carry `margin` extra steps past the episode end
because several quantities are evaluated at t+1 (reward) or t+12
(comfort-in-one-hour observation, environment.py:946-951).

Port of sbsim_tpu/scenario/tables.py on `datetime` instead of pandas, and
with its own time-zone rule instead of a tz database: "UTC", and the US
daylight-saving rule (second Sunday of March to first Sunday of November,
02:00 local) for "US/Pacific". Other zone names raise.

Parity sources: setpoint_schedule.py:86-128 (comfort/eco windows),
conversion_utils.py:65-135 (workday + radian time),
electricity_energy_cost.py:166-224 and natural_gas_energy_cost.py:75-138
(tariffs; note the reference indexes TOU tables with the *raw* timestamp hour,
which for the sb1 config is the UTC hour - preserved here),
weather_controller.py (ambient temperature).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import List

import numpy as np

from sbsim_tpu_torch import constants
from sbsim_tpu_torch.envs.config import EnvConfig
from sbsim_tpu_torch.scenario import uscalendar
from sbsim_tpu_torch.scenario import weather as weather_lib

_UTC = datetime.timezone.utc
# Standard-time UTC offsets (hours) of the zones that follow the US rule.
_US_STANDARD_OFFSET_HOURS = {"US/Pacific": -8}


def _first_sunday(year: int, month: int) -> int:
    return 1 + (6 - datetime.date(year, month, 1).weekday()) % 7


def to_local(ts: datetime.datetime, time_zone: str) -> datetime.datetime:
    """Naive local wall-clock time of a timezone-aware timestamp.

    "UTC", or the US daylight-saving rule in force since 2007: daylight
    time (standard + 1 h) from 02:00 standard time on the second Sunday of
    March to 02:00 daylight time on the first Sunday of November.
    """
    utc = ts.astimezone(_UTC).replace(tzinfo=None)
    if time_zone == "UTC":
        return utc
    if time_zone not in _US_STANDARD_OFFSET_HOURS:
        raise ValueError(
            f"time zone {time_zone!r} not supported; one of "
            f"{['UTC'] + sorted(_US_STANDARD_OFFSET_HOURS)}"
        )
    if utc.year < 2007:
        raise ValueError("the US daylight-saving rule is carried from 2007 on")
    std = _US_STANDARD_OFFSET_HOURS[time_zone]
    dst_start = datetime.datetime(
        utc.year, 3, _first_sunday(utc.year, 3) + 7, 2
    ) - datetime.timedelta(hours=std)
    dst_end = datetime.datetime(
        utc.year, 11, _first_sunday(utc.year, 11), 2
    ) - datetime.timedelta(hours=std + 1)
    offset = std + 1 if dst_start <= utc < dst_end else std
    return utc + datetime.timedelta(hours=offset)


def _local_midnight_utc(local: datetime.datetime, time_zone: str) -> datetime.datetime:
    """The UTC instant of local midnight on `local`'s date (no US rule
    changes the offset between midnight and 02:00)."""
    midnight = datetime.datetime(local.year, local.month, local.day)
    std = datetime.timedelta(hours=_US_STANDARD_OFFSET_HOURS.get(time_zone, 0))
    guess = midnight - std
    offset = to_local(guess.replace(tzinfo=_UTC), time_zone) - guess
    return (midnight - offset).replace(tzinfo=_UTC)


@dataclasses.dataclass(frozen=True)
class EpisodeTables:
    """Step-indexed scenario tables (host numpy, all length T = steps +
    margin); dtypes match the JAX package's."""

    ambient_temp: np.ndarray  # f32 (T,) K
    convection_coeff: np.ndarray  # f32 (T,) W/m2/K
    comfort: np.ndarray  # bool (T,) schedule comfort mode at step start
    heating_setpoint: np.ndarray  # f32 (T,) window low for current mode
    cooling_setpoint: np.ndarray  # f32 (T,) window high for current mode
    comfort_soon: np.ndarray  # bool (T,) comfort at step start + 60 min
    hod_rad: np.ndarray  # f32 (T,) time-of-day angle, 0..2pi
    dow_rad: np.ndarray  # f32 (T,) day-of-week angle, 0..2pi
    elec_price: np.ndarray  # f32 (T,) USD per W-second
    elec_carbon: np.ndarray  # f32 (T,) kg CO2 per W-second
    gas_price: np.ndarray  # f32 (T,) USD per Joule
    local_hour: np.ndarray  # i32 (T,) hour in the occupancy time zone
    workday_local: np.ndarray  # bool (T,) workday in the occupancy time zone
    step_occupancy: np.ndarray  # f32 (T,) step-function occupancy (0 if unused)
    reset_local_hour: int  # local hour 5 min before episode start
    reset_workday: bool  # workday 5 min before episode start
    n_steps: int  # episode length
    time_step_sec: float


def _schedule_comfort(ts: datetime.datetime, cfg: EnvConfig) -> bool:
    """setpoint_schedule.is_comfort_mode (:86-98)."""
    local = to_local(ts, cfg.schedule.time_zone)
    sched = cfg.schedule
    return (
        sched.morning_start_hour <= local.hour < sched.evening_start_hour
        and local.timetuple().tm_yday not in set(sched.holidays)
        and local.weekday() < 5
    )


def _step_function_occupancy(
    start: datetime.datetime, end: datetime.datetime, cfg: EnvConfig
) -> float:
    """Average occupancy of [start, end] under the deterministic model.

    Parity: step_function_occupancy.py:37-173 - occupancy is work-level
    during work hours on workdays, nonwork-level otherwise, weighted by the
    overlap of the query interval with work time. Work hours are offsets
    of absolute time from local midnight, as in the JAX package.
    """
    occ = cfg.occupancy
    tz = occ.time_zone
    total = (end - start).total_seconds()
    if total <= 0:
        return occ.nonwork_occupancy
    local_start = to_local(start, tz)
    if not uscalendar.is_work_day(local_start.date()):
        work_seconds = 0.0
    else:
        day = _local_midnight_utc(local_start, tz)
        work_start = day + datetime.timedelta(hours=occ.work_start_hour)
        work_end = day + datetime.timedelta(hours=occ.work_end_hour)
        overlap_start = max(start, work_start)
        overlap_end = min(end, work_end)
        work_seconds = max(0.0, (overlap_end - overlap_start).total_seconds())
    frac = work_seconds / total
    return frac * occ.work_occupancy + (1.0 - frac) * occ.nonwork_occupancy


def build_episode_tables(
    config: EnvConfig, margin_steps: int = 16
) -> EpisodeTables:
    """Precomputes step-indexed scenario tables."""
    if config.episode_windows > 1:
        raise NotImplementedError(
            "episode_windows > 1 is not ported yet (one episode window only)"
        )
    start = weather_lib.parse_timestamp(config.start_timestamp)
    dt = datetime.timedelta(seconds=config.time_step_sec)
    n_steps = config.steps_per_episode
    total = n_steps + margin_steps
    timestamps: List[datetime.datetime] = [start + i * dt for i in range(total)]

    sched_tz = config.schedule.time_zone
    occ_tz = config.occupancy.time_zone
    to_local(start, sched_tz)  # raises early on an unsupported zone
    to_local(start, occ_tz)

    ambient = weather_lib.ambient_temperature_table(config.weather, timestamps)
    conv = np.full(total, config.weather.convection_coefficient)

    comfort = np.array([_schedule_comfort(t, config) for t in timestamps])
    hour = datetime.timedelta(minutes=60)
    comfort_soon = np.array(
        [_schedule_comfort(t + hour, config) for t in timestamps]
    )
    heat_sp = np.where(
        comfort,
        config.schedule.comfort_temp_window[0],
        config.schedule.eco_temp_window[0],
    )
    cool_sp = np.where(
        comfort,
        config.schedule.comfort_temp_window[1],
        config.schedule.eco_temp_window[1],
    )

    # Time-of-day / day-of-week angles use the raw timestamp (its own UTC
    # offset), matching conversion_utils.get_radian_time called on the
    # simulation timestamp (environment.py:916-940).
    hod_rad = np.array(
        [
            2.0
            * math.pi
            * (t.hour * 3600 + t.minute * 60 + t.second)
            / 86400.0
            for t in timestamps
        ]
    )
    dow_rad = np.array(
        [2.0 * math.pi * t.weekday() / 7.0 for t in timestamps]
    )

    # Tariffs: indexed by the raw timestamp's hour and weekday/holiday status
    # (electricity_energy_cost.py:186-190 uses start_time.hour directly).
    weekday_prices = np.asarray(config.reward.weekday_electricity_prices)
    weekend_prices = np.asarray(config.reward.weekend_electricity_prices)
    carbon_rates = np.asarray(config.reward.carbon_emission_rates)
    gas_prices = np.asarray(config.reward.gas_prices_by_month)
    elec_price = np.empty(total)
    elec_carbon = np.empty(total)
    gas_price = np.empty(total)
    for i, t in enumerate(timestamps):
        workday_utc = uscalendar.is_work_day(t.date())
        prices = weekday_prices if workday_utc else weekend_prices
        # cents/kWh -> USD per W-second (electricity_energy_cost.py:150-164).
        elec_price[i] = prices[t.hour] / 100.0 / 1000.0 / 3600.0
        # kg/MWh -> kg per W-second (:146-148).
        elec_carbon[i] = carbon_rates[t.hour] / 1.0e6 / 3600.0
        # USD/kft3 -> USD/J (natural_gas_energy_cost.py:61-66).
        gas_price[i] = (
            gas_prices[t.month - 1]
            / constants.KWH_PER_KFT3_GAS
            / constants.JOULES_PER_KWH
        )

    local = [to_local(t, occ_tz) for t in timestamps]
    local_hour = np.array([t.hour for t in local], dtype=np.int32)
    workday_local = np.array([uscalendar.is_work_day(t.date()) for t in local])

    if config.occupancy.kind == "step_function":
        step_occ = np.array(
            [_step_function_occupancy(t, t + dt, config) for t in timestamps]
        )
    else:
        step_occ = np.zeros(total)

    # The reset observation peeks occupancy over [start - 5 min, start]
    # (simulator_building.py:305-315 via environment.py:1174).
    reset_probe = to_local(start - datetime.timedelta(minutes=5), occ_tz)

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return EpisodeTables(
        ambient_temp=f32(ambient),
        convection_coeff=f32(conv),
        comfort=comfort.astype(bool),
        heating_setpoint=f32(heat_sp),
        cooling_setpoint=f32(cool_sp),
        comfort_soon=comfort_soon.astype(bool),
        hod_rad=f32(hod_rad),
        dow_rad=f32(dow_rad),
        elec_price=f32(elec_price),
        elec_carbon=f32(elec_carbon),
        gas_price=f32(gas_price),
        local_hour=local_hour,
        workday_local=workday_local.astype(bool),
        step_occupancy=f32(step_occ),
        reset_local_hour=int(reset_probe.hour),
        reset_workday=bool(uscalendar.is_work_day(reset_probe.date())),
        n_steps=n_steps,
        time_step_sec=float(config.time_step_sec),
    )

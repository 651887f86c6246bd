"""Per-step lookup tables: all calendar/timezone/tariff logic, precomputed.

The device program is pure tensor math; anything that depends on wall-clock
time (comfort schedules, holidays, DST, TOU tariffs, occupancy windows,
weather, time-of-day features) is folded host-side into arrays indexed by the
episode step counter. Tables carry `margin` extra steps past the episode end
because several quantities are evaluated at t+1 (reward) or t+12
(comfort-in-one-hour observation, environment.py:946-951).

Port of sbsim_tpu/scenario/tables.py on `datetime` instead of pandas, and
with its own table of time zones instead of a tz database (TIME_ZONES: a
standard offset and a daylight-saving rule each, US or EU). Other zone
names, and years before a zone's rule, raise.

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
_HOUR = datetime.timedelta(hours=1)


def _first_sunday(year: int, month: int) -> int:
    return 1 + (6 - datetime.date(year, month, 1).weekday()) % 7


def _last_sunday(year: int, month: int) -> int:
    last = datetime.date(year + month // 12, month % 12 + 1, 1) - datetime.timedelta(days=1)
    return last.day - (last.weekday() + 1) % 7


def _us_daylight(year: int, std: datetime.timedelta):
    """US daylight time as naive UTC [start, end): from 02:00 standard time
    on the second Sunday of March to 02:00 daylight time on the first Sunday
    of November since 2007; 1987-2006 from the first Sunday of April to the
    last Sunday of October."""
    if year >= 2007:
        start = datetime.datetime(year, 3, _first_sunday(year, 3) + 7, 2)
        end = datetime.datetime(year, 11, _first_sunday(year, 11), 2)
    else:
        start = datetime.datetime(year, 4, _first_sunday(year, 4), 2)
        end = datetime.datetime(year, 10, _last_sunday(year, 10), 2)
    return start - std, end - std - _HOUR


def _eu_daylight(year: int, std: datetime.timedelta):
    """EU summer time as naive UTC [start, end): 01:00 UTC on the last
    Sunday of March to 01:00 UTC on the last Sunday of October."""
    del std
    return (datetime.datetime(year, 3, _last_sunday(year, 3), 1),
            datetime.datetime(year, 10, _last_sunday(year, 10), 1))


# Daylight-saving rules: (first year the rule covers, [start, end) in UTC).
_RULES = {"US": (1987, _us_daylight), "EU": (1996, _eu_daylight)}


def _zones(std_minutes: int, rule, *names: str):
    return {name: (std_minutes, rule) for name in names}


# Zone name -> (standard UTC offset in minutes, daylight-saving rule or None).
TIME_ZONES = {
    **_zones(0, None, "UTC"),
    **_zones(-300, "US", "US/Eastern", "America/New_York"),
    **_zones(-360, "US", "US/Central", "America/Chicago"),
    **_zones(-420, "US", "US/Mountain", "America/Denver"),
    **_zones(-480, "US", "US/Pacific", "America/Los_Angeles"),
    **_zones(-540, "US", "US/Alaska", "America/Anchorage"),
    **_zones(-600, None, "US/Hawaii", "Pacific/Honolulu"),
    **_zones(-420, None, "US/Arizona", "America/Phoenix"),
    **_zones(0, "EU", "Europe/London", "Europe/Dublin"),
    **_zones(60, "EU", "Europe/Berlin", "Europe/Paris", "Europe/Amsterdam",
             "Europe/Brussels", "Europe/Madrid", "Europe/Rome", "Europe/Zurich"),
    **_zones(120, "EU", "Europe/Helsinki", "Europe/Athens"),
}


def _standard_offset(time_zone: str) -> datetime.timedelta:
    if time_zone not in TIME_ZONES:
        raise ValueError(
            f"time zone {time_zone!r} not supported; one of {sorted(TIME_ZONES)}"
        )
    return datetime.timedelta(minutes=TIME_ZONES[time_zone][0])


def to_local(ts: datetime.datetime, time_zone: str) -> datetime.datetime:
    """Naive local wall-clock time of a timezone-aware timestamp in a zone
    of TIME_ZONES: its standard offset, plus one hour while its rule's
    daylight time holds."""
    utc = ts.astimezone(_UTC).replace(tzinfo=None)
    std = _standard_offset(time_zone)
    rule = TIME_ZONES[time_zone][1]
    if rule is None:
        return utc + std
    first_year, daylight = _RULES[rule]
    if utc.year < first_year:
        raise ValueError(
            f"{time_zone} follows the {rule} daylight-saving rule, which is "
            f"carried from {first_year} on; got {utc.year}"
        )
    start, end = daylight(utc.year, std)
    return utc + std + (_HOUR if start <= utc < end else datetime.timedelta(0))


def _local_midnight_utc(local: datetime.datetime, time_zone: str) -> datetime.datetime:
    """The UTC instant of local midnight on `local`'s date (every rule of
    TIME_ZONES changes the offset an hour or more after local midnight, so
    the offset at midnight taken as standard time is the offset then)."""
    midnight = datetime.datetime(local.year, local.month, local.day)
    guess = midnight - _standard_offset(time_zone)
    offset = to_local(guess.replace(tzinfo=_UTC), time_zone) - guess
    return (midnight - offset).replace(tzinfo=_UTC)


@dataclasses.dataclass(frozen=True)
class EpisodeTables:
    """Step-indexed scenario tables (host numpy, all length T = steps +
    margin; stacked over episode windows, see build_episode_tables); dtypes
    match the JAX package's."""

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


# Fields that are one value per episode, not per window.
STATIC_FIELDS = ("n_steps", "time_step_sec")


def tables_for_window(tables: EpisodeTables, window: int) -> EpisodeTables:
    """Selects one window's tables from a (W, T)-stacked EpisodeTables."""
    return dataclasses.replace(tables, **{
        f.name: getattr(tables, f.name)[window]
        for f in dataclasses.fields(tables) if f.name not in STATIC_FIELDS
    })


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
    """Precomputes step-indexed scenario tables.

    With config.episode_windows > 1, every leaf but n_steps and
    time_step_sec gains a leading window axis: (W, T) tables, and (W,)
    reset_local_hour (int32) and reset_workday, window w starting
    w * window_stride_hours after start_timestamp; `tables_for_window`
    selects one window's tables.
    """
    start = weather_lib.parse_timestamp(config.start_timestamp)
    if config.episode_windows == 1:
        return _window_tables(config, start, margin_steps)
    stride = datetime.timedelta(hours=config.window_stride_hours)
    windows = [
        _window_tables(config, start + w * stride, margin_steps)
        for w in range(config.episode_windows)
    ]
    dtypes = {"reset_local_hour": np.int32, "reset_workday": bool}
    return dataclasses.replace(windows[0], **{
        f.name: np.stack([
            np.asarray(getattr(t, f.name), dtypes.get(f.name)) for t in windows
        ])
        for f in dataclasses.fields(EpisodeTables) if f.name not in STATIC_FIELDS
    })


def _window_tables(
    config: EnvConfig, start: datetime.datetime, margin_steps: int
) -> EpisodeTables:
    """The tables of one episode window starting at `start`."""
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

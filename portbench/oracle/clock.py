"""The episode's clock, worked out from the configuration file: each step's
UTC timestamp, its local time (US time zones by the federal daylight-saving
rule), workdays (weekdays that are no US federal holiday, the observed day
included), the setpoint schedule, the time-of-use tariffs and carbon
rates, and the replayed outside temperature (linear in the record's
Fahrenheit readings, converted to Kelvin after interpolating), as float64
arrays over the steps."""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict

import numpy as np

UTC = datetime.timezone.utc
# Standard offsets in hours; each keeps daylight time by the US rule.
US_ZONES = {"US/Eastern": -5, "US/Central": -6, "US/Mountain": -7, "US/Pacific": -8}
KWH_PER_KFT3_GAS = 293.07107
JOULES_PER_KWH = 3.6e6
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _nth_weekday(year, month, weekday, n):
    """The n-th `weekday` (Monday 0) of the month; n = -1 the last."""
    if n > 0:
        d = datetime.date(year, month, 1)
        d += datetime.timedelta(days=(weekday - d.weekday()) % 7)
        return d + datetime.timedelta(weeks=n - 1)
    nxt = datetime.date(year + month // 12, month % 12 + 1, 1)
    d = nxt - datetime.timedelta(days=1)
    return d - datetime.timedelta(days=(d.weekday() - weekday) % 7)


def to_local(ts: datetime.datetime, zone: str) -> datetime.datetime:
    """Naive local wall time of an aware UTC timestamp: daylight time from
    2:00 local standard time on March's second Sunday to 2:00 local
    daylight time on November's first Sunday."""
    std = datetime.timedelta(hours=US_ZONES[zone])
    local_std = (ts.astimezone(UTC) + std).replace(tzinfo=None)
    y = local_std.year
    start = datetime.datetime.combine(_nth_weekday(y, 3, 6, 2), datetime.time(2))
    end = datetime.datetime.combine(_nth_weekday(y, 11, 6, 1), datetime.time(1))
    return local_std + datetime.timedelta(hours=1) if start <= local_std < end else local_std


def _observed(d: datetime.date) -> datetime.date:
    return d - datetime.timedelta(days=1) if d.weekday() == 5 else (
        d + datetime.timedelta(days=1) if d.weekday() == 6 else d)


def us_holidays(year: int) -> set:
    fixed = [(1, 1), (7, 4), (11, 11), (12, 25)] + ([(6, 19)] if year >= 2021 else [])
    days = {_observed(datetime.date(year, m, d)) for m, d in fixed}
    days |= {_nth_weekday(year, 1, 0, 3), _nth_weekday(year, 2, 0, 3),
             _nth_weekday(year, 5, 0, -1), _nth_weekday(year, 9, 0, 1),
             _nth_weekday(year, 10, 0, 2), _nth_weekday(year, 11, 3, 4)}
    # New Year's Day of the next year observed on this year's 31 December.
    if _observed(datetime.date(year + 1, 1, 1)).year == year:
        days.add(_observed(datetime.date(year + 1, 1, 1)))
    return days


def is_work_day(d: datetime.date) -> bool:
    return d.weekday() < 5 and d not in us_holidays(d.year)


def start_of(spec) -> datetime.datetime:
    return datetime.datetime.fromisoformat(spec["start_timestamp"]).astimezone(UTC)


@dataclasses.dataclass
class Clock:
    """Per-step values, index t = the step's start."""

    comfort: np.ndarray  # bool
    comfort_soon: np.ndarray  # bool: comfort an hour after the step's start
    hod_rad: np.ndarray  # the UTC timestamp's time of day as an angle
    dow_rad: np.ndarray  # its day of the week as an angle
    heating_setpoint: np.ndarray
    cooling_setpoint: np.ndarray
    ambient: np.ndarray  # K
    convection: np.ndarray
    elec_price: np.ndarray  # USD per W-second
    elec_carbon: np.ndarray  # kg per W-second
    gas_price: np.ndarray  # USD per J
    local_hour: np.ndarray  # the occupancy time zone's
    workday_local: np.ndarray
    reset_local_hour: int
    reset_workday: bool


def _comfort(ts, sched) -> bool:
    local = to_local(ts, sched["time_zone"])
    return (sched["morning_start_hour"] <= local.hour < sched["evening_start_hour"]
            and local.timetuple().tm_yday not in set(sched["holidays"])
            and local.weekday() < 5)


def replay_temperatures(path: str, stamps) -> np.ndarray:
    with np.load(path) as blob:
        seconds = np.asarray(blob["epoch_seconds"], np.float64)
        temps = np.asarray(blob["temps_fahrenheit"], np.float64)
    order = np.argsort(seconds, kind="stable")
    targets = np.array([t.timestamp() for t in stamps])
    if targets.min() < seconds[order][0] or targets.max() > seconds[order][-1]:
        raise ValueError("the episode lies outside the weather record")
    return (np.interp(targets, seconds[order], temps[order]) - 32.0) * 5.0 / 9.0 + 273.15


def build(spec, steps: int) -> Clock:
    """The clock of `steps` steps from the file's start timestamp."""
    start = start_of(spec)
    dt = datetime.timedelta(seconds=spec["time_step_sec"])
    stamps = [start + i * dt for i in range(steps)]
    sched, occ, rw = spec["schedule"], spec["occupancy"], spec["reward"]
    comfort = np.array([_comfort(t, sched) for t in stamps])
    lo = np.where(comfort, sched["comfort_temp_window"][0], sched["eco_temp_window"][0])
    hi = np.where(comfort, sched["comfort_temp_window"][1], sched["eco_temp_window"][1])
    elec, carbon, gas = [], [], []
    for t in stamps:
        prices = rw["weekday_electricity_prices" if is_work_day(t.date())
                    else "weekend_electricity_prices"]
        elec.append(prices[t.hour] / 100.0 / 1000.0 / 3600.0)
        carbon.append(rw["carbon_emission_rates"][t.hour] / 1.0e6 / 3600.0)
        gas.append(rw["gas_prices_by_month"][t.month - 1] / KWH_PER_KFT3_GAS / JOULES_PER_KWH)
    local = [to_local(t, occ["time_zone"]) for t in stamps]
    probe = to_local(start - datetime.timedelta(minutes=5), occ["time_zone"])
    w = spec["weather"]
    if w["kind"] != "replay":
        raise ValueError("the reference replays recorded weather only")
    hour = datetime.timedelta(hours=1)
    return Clock(
        comfort=comfort, heating_setpoint=lo.astype(np.float64),
        comfort_soon=np.array([_comfort(t + hour, sched) for t in stamps]),
        hod_rad=np.array([2.0 * np.pi * (t.hour * 3600 + t.minute * 60 + t.second) / 86400.0
                          for t in stamps]),
        dow_rad=np.array([2.0 * np.pi * t.weekday() / 7.0 for t in stamps]),
        cooling_setpoint=hi.astype(np.float64),
        ambient=replay_temperatures(os.path.join(ROOT, w["file"]), stamps),
        convection=np.full(steps, float(w["convection_coefficient"])),
        elec_price=np.array(elec), elec_carbon=np.array(carbon), gas_price=np.array(gas),
        local_hour=np.array([t.hour for t in local]),
        workday_local=np.array([is_work_day(t.date()) for t in local]),
        reset_local_hour=probe.hour, reset_workday=is_work_day(probe.date()))


def tensors(clock: Clock, device) -> Dict[str, "torch.Tensor"]:
    import torch

    out = {}
    for f in dataclasses.fields(clock):
        v = getattr(clock, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = torch.as_tensor(v, device=device)
    return out

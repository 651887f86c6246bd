"""Time, unit and id conversions (conversion_utils.py parity).

Port of sbsim_tpu/utils/conversions.py on `datetime` instead of pandas.
Timestamps are UTC-aware `datetime.datetime`s (a naive one is taken as
UTC); the proto conversions keep pandas' names and take and give
`datetime`. No time-zone database is read.
"""

from __future__ import annotations

import datetime
import enum
import math
import re
from typing import Mapping, Tuple

from sbsim_tpu_torch.proto import timestamp_pb2
from sbsim_tpu_torch.scenario import uscalendar

_SECONDS_IN_DAY = 24 * 3600
_DAYS_IN_WEEK = 7
UTC = datetime.timezone.utc


def as_utc(ts: datetime.datetime) -> datetime.datetime:
    """`ts` as a UTC-aware datetime; a naive one is taken as UTC."""
    return ts.replace(tzinfo=UTC) if ts.tzinfo is None else ts.astimezone(UTC)


def pandas_to_proto_timestamp(ts: datetime.datetime) -> timestamp_pb2.Timestamp:
    out = timestamp_pb2.Timestamp()
    out.FromDatetime(as_utc(ts))
    return out


def proto_to_pandas_timestamp(proto_ts: timestamp_pb2.Timestamp) -> datetime.datetime:
    return proto_ts.ToDatetime(tzinfo=UTC)


def is_work_day(timestamp: datetime.datetime) -> bool:
    """Weekday and not a US holiday (conversion_utils.py:65-70)."""
    return uscalendar.is_work_day(timestamp.date()) and timestamp.weekday() < 5


def zone_coordinates_to_id(coordinates: Tuple[int, int]) -> str:
    return "zone_id_" + str(coordinates)


def floor_plan_based_zone_identifier_to_id(identifier: str) -> str:
    return "zone_id_" + identifier.replace("room_", "")


def zone_id_to_coordinates(zone_id: str) -> Tuple[int, int]:
    m = re.match(r"^zone_id_[(](\d+), (\d+)[)]", zone_id)
    if not m:
        raise ValueError("Could not convert zone_id to coordinates!")
    return int(m.group(1)), int(m.group(2))


def normalize_dow(dow: int) -> float:
    """Day of week [0, 6] -> [-1, 1]."""
    if not 0 <= dow <= 6:
        raise ValueError(f"day of week {dow} outside [0, 6]")
    return (float(dow) - 3.0) / 3.0


def normalize_hod(hod: int) -> float:
    """Hour of day [0, 23] -> [-1, 1]."""
    if not 0 <= hod <= 23:
        raise ValueError(f"hour of day {hod} outside [0, 23]")
    return (float(hod) - 11.5) / 11.5


class TimeIntervalEnum(enum.Enum):
    DAY_OF_WEEK = 1
    HOUR_OF_DAY = 2


def get_radian_time(timestamp: datetime.datetime, time_interval: TimeIntervalEnum) -> float:
    """Maps the timestamp into [0, 2pi) over a day or a week
    (conversion_utils.py:107-135), in the timestamp's own zone."""
    if time_interval == TimeIntervalEnum.DAY_OF_WEEK:
        frac = float(timestamp.weekday()) / _DAYS_IN_WEEK
    elif time_interval == TimeIntervalEnum.HOUR_OF_DAY:
        seconds = (timestamp.hour * 3600 + timestamp.minute * 60 + timestamp.second
                   + timestamp.microsecond / 1e6)
        frac = seconds / _SECONDS_IN_DAY
    else:
        raise ValueError(f"No cycle conversion for {time_interval}.")
    return 2.0 * math.pi * frac


def kelvin_to_fahrenheit(kelvin: float) -> float:
    return (kelvin - 273.15) * 9.0 / 5.0 + 32.0


def fahrenheit_to_kelvin(fahrenheit: float) -> float:
    return (fahrenheit - 32.0) * 5.0 / 9.0 + 273.15


def kelvin_to_celsius(kelvin: float) -> float:
    return kelvin - 273.15


def celsius_to_kelvin(celsius: float) -> float:
    return celsius + 273.15


def reward_info_energy_use(reward_info, time_step_sec: float | None = None) -> Mapping[str, float]:
    """RewardInfo -> kWh breakdown (conversion_utils.py:173-213)."""
    if time_step_sec is None:
        start = proto_to_pandas_timestamp(reward_info.start_timestamp)
        end = proto_to_pandas_timestamp(reward_info.end_timestamp)
        time_step_sec = (end - start).total_seconds()
    to_kwh = time_step_sec / 3.6e6
    ahus = reward_info.air_handler_reward_infos.values()
    boilers = reward_info.boiler_reward_infos.values()
    return {
        "air_handler_blower_electricity": sum(i.blower_electrical_energy_rate for i in ahus) * to_kwh,
        "air_handler_air_conditioning": sum(
            abs(i.air_conditioning_electrical_energy_rate) for i in ahus) * to_kwh,
        "boiler_natural_gas_heating_energy": sum(
            i.natural_gas_heating_energy_rate for i in boilers) * to_kwh,
        "boiler_pump_electrical_energy": sum(i.pump_electrical_energy_rate for i in boilers) * to_kwh,
    }

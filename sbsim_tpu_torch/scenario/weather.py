"""Weather models: diurnal sinusoid and recorded-weather replay.

Host-side: weather is precomputed into per-step ambient-temperature tables so
the device program never touches timestamps. Port of
sbsim_tpu/scenario/weather.py on `datetime` instead of pandas: timestamps
are timezone-aware `datetime.datetime` values.

Parity: smart_control/simulator/weather_controller.py:47-218.
"""

from __future__ import annotations

import csv
import datetime
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from sbsim_tpu_torch.envs.config import WeatherConfig

_SECONDS_IN_A_DAY = 24 * 3600
_DAYS_IN_A_YEAR = 365
_MIN_RADIANS = -math.pi / 2.0
_MAX_RADIANS = 3.0 * math.pi / 2.0
_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def epoch_seconds(ts: datetime.datetime) -> float:
    """Seconds since the Unix epoch of a timezone-aware timestamp."""
    return (ts - _EPOCH).total_seconds()


def parse_timestamp(text: str) -> datetime.datetime:
    """ISO-8601 timestamp; a naive one is taken as UTC (as pandas'
    `Timestamp(...).tz_localize("UTC")` and `to_datetime(utc=True)` do)."""
    ts = datetime.datetime.fromisoformat(text.strip())
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=datetime.timezone.utc)
    return ts


def sinusoid_temperature(
    timestamp: datetime.datetime,
    low: float,
    high: float,
    special_days: Optional[Mapping[int, Tuple[float, float]]] = None,
) -> float:
    """Diurnal sinusoid: minimum at midnight, maximum at noon.

    Parity: WeatherController.get_current_temp (weather_controller.py:93-123),
    including the afternoon interpolation toward *tomorrow's* low.
    """
    special_days = special_days or {}
    today = timestamp.timetuple().tm_yday
    tomorrow = (today + 1) % _DAYS_IN_A_YEAR

    today_low, today_high = special_days.get(today, (low, high))
    tomorrow_low = special_days.get(tomorrow, (low, high))[0]

    high_t = today_high
    low_t = today_low if timestamp.hour < 12 else tomorrow_low

    seconds_in_day = (
        timestamp.hour * 3600.0
        + timestamp.minute * 60.0
        + timestamp.second
        + timestamp.microsecond / 1e6
    )
    rad = (seconds_in_day / _SECONDS_IN_A_DAY) * (
        _MAX_RADIANS - _MIN_RADIANS
    ) + _MIN_RADIANS
    return 0.5 * (math.sin(rad) + 1.0) * (high_t - low_t) + low_t


def get_replay_temperatures(observation_responses) -> Dict[str, float]:
    """Outside-air temperatures of recorded ObservationResponses.

    Returns {str(timestamp): temperature K} (UTC timestamps, as pandas
    prints them to the microsecond), with -1.0 where the response carries
    no outside_air_temperature_sensor reading.
    Parity: weather_controller.get_replay_temperatures
    (weather_controller.py:135-162).
    """
    temps: Dict[str, float] = {}
    for response in observation_responses:
        value = -1.0
        for r in response.single_observation_responses:
            if r.single_observation_request.measurement_name == "outside_air_temperature_sensor":
                value = r.continuous_value
                break
        ts = _EPOCH + datetime.timedelta(
            seconds=response.timestamp.seconds, microseconds=response.timestamp.nanos // 1000)
        temps[str(ts)] = value
    return temps


class ReplayWeather:
    """Linear interpolation over recorded weather.

    Built from a CSV (Time, TempF columns), a packaged .npz of the same
    data (epoch_seconds + temps_fahrenheit arrays; data/sb1_weather_moffett.npz
    carries the sb1 Moffett Field record), or, through `from_observations`,
    from recorded ObservationResponse protos.

    Parity: ReplayWeatherController (weather_controller.py:166-218). Like
    the reference, interpolation runs in the recorded unit (°F for weather
    files) and converts to Kelvin AFTER interpolating.
    """

    def __init__(self, path: Optional[str] = None):
        self._fahrenheit = True
        if path is None:
            self._epoch_seconds = np.zeros((0,))
            self._temps_raw = np.zeros((0,))
            return
        if str(path).endswith(".npz"):
            with np.load(path) as blob:
                seconds = np.asarray(blob["epoch_seconds"], np.float64)
                temps = np.asarray(blob["temps_fahrenheit"], np.float64)
        else:
            with open(path, newline="") as f:
                rows = list(csv.DictReader(f))
            seconds = np.array(
                [epoch_seconds(parse_timestamp(r["Time"])) for r in rows]
            )
            temps = np.asarray([float(r["TempF"]) for r in rows], np.float64)
        order = np.argsort(seconds, kind="stable")
        self._epoch_seconds = seconds[order]
        self._temps_raw = temps[order]

    @classmethod
    def from_observations(cls, observation_responses) -> "ReplayWeather":
        """ReplayWeather driven by recorded building telemetry: the one-call
        equivalent of get_replay_temperatures + ReplayWeatherController.
        Responses without an outside-air reading are skipped."""
        out = cls(None)
        out._fahrenheit = False  # telemetry readings are already Kelvin
        seconds, kelvin = [], []
        for ts, value in get_replay_temperatures(observation_responses).items():
            if value <= 0.0:
                continue
            seconds.append(epoch_seconds(datetime.datetime.fromisoformat(ts)))
            kelvin.append(value)
        order = np.argsort(np.asarray(seconds))
        out._epoch_seconds = np.asarray(seconds, np.float64)[order]
        out._temps_raw = np.asarray(kelvin, np.float64)[order]
        return out

    @property
    def min_timestamp(self) -> datetime.datetime:
        return _EPOCH + datetime.timedelta(seconds=float(self._epoch_seconds[0]))

    @property
    def max_timestamp(self) -> datetime.datetime:
        return _EPOCH + datetime.timedelta(seconds=float(self._epoch_seconds[-1]))

    def temperatures(self, timestamps: Sequence[datetime.datetime]) -> np.ndarray:
        targets = np.array([epoch_seconds(t) for t in timestamps])
        if targets.min() < self._epoch_seconds[0] or (
            targets.max() > self._epoch_seconds[-1]
        ):
            raise ValueError(
                "Requested weather outside the recorded range "
                f"[{self.min_timestamp}, {self.max_timestamp}]"
            )
        values = np.interp(targets, self._epoch_seconds, self._temps_raw)
        if self._fahrenheit:
            # conversion_utils.fahrenheit_to_kelvin, applied post-interp
            # exactly as ReplayWeatherController.get_current_temp does.
            return (values - 32.0) * 5.0 / 9.0 + 273.15
        return values


def ambient_temperature_table(
    config: WeatherConfig, timestamps: Sequence[datetime.datetime]
) -> np.ndarray:
    """Ambient temperature (K) at each timestamp."""
    if config.kind == "replay":
        if not config.replay_csv_path:
            raise ValueError("replay weather requires replay_csv_path")
        return ReplayWeather(config.replay_csv_path).temperatures(timestamps)
    if config.kind == "sinusoid":
        return np.array(
            [
                sinusoid_temperature(
                    t, config.low_temp, config.high_temp, config.special_days
                )
                for t in timestamps
            ]
        )
    raise ValueError(f"Unknown weather kind: {config.kind}")

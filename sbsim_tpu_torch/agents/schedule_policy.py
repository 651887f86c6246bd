"""Rules-based schedule baseline policy.

Port of sbsim_tpu/agents/schedule_policy.py without pandas or a time-zone
database: local time comes from the port's own table of zones and their
daylight-saving rules (scenario/tables.to_local), as the episode tables do. The reference
bootstraps SAC's replay buffer from a weekday/weekend setpoint schedule
(SAC_Demo.ipynb cells 13-18): on workdays 06:00-19:00 local time the
hot-water setpoint is 350 K and the AHU heating setpoint 292 K, otherwise
315 K / 285 K; weekends and holidays use the night values all day. The
whole schedule is precomputed into a per-step normalized action table.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Mapping

import numpy as np

from sbsim_tpu_torch.scenario import tables as tables_lib
from sbsim_tpu_torch.scenario import uscalendar


@dataclasses.dataclass(frozen=True)
class ScheduleValues:
    day_start_hour: int = 6
    day_end_hour: int = 19
    weekday_day: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {
            "supply_water_setpoint": 350.0,
            "supply_air_heating_temperature_setpoint": 292.0,
        }
    )
    night_and_weekend: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {
            "supply_water_setpoint": 315.0,
            "supply_air_heating_temperature_setpoint": 285.0,
        }
    )


def _utc_start(stamp: str) -> datetime.datetime:
    """An ISO timestamp as an aware datetime; naive stamps are UTC (as
    pandas' tz_localize("UTC") reads them)."""
    start = datetime.datetime.fromisoformat(stamp)
    if start.tzinfo is None:
        start = start.replace(tzinfo=datetime.timezone.utc)
    return start


def build_schedule_actions(env, values: ScheduleValues = ScheduleValues()) -> np.ndarray:
    """Normalized action table (T + 1, A) for one episode of `env` (a
    BuildingEnv)."""
    cfg = env.config
    start = _utc_start(cfg.start_timestamp)
    dt = datetime.timedelta(seconds=cfg.time_step_sec)
    n = env.steps_per_episode + 1
    actions = np.zeros((n, env.n_actions), np.float32)
    for i in range(n):
        local = tables_lib.to_local(start + i * dt, cfg.schedule.time_zone)
        is_day = (
            values.day_start_hour <= local.hour < values.day_end_hour
            and uscalendar.is_work_day(local.date())
        )
        setpoints = values.weekday_day if is_day else values.night_and_weekend
        actions[i] = env.default_action(dict(setpoints))
    return actions

"""Inputs the benchmark makes and hands to both sides: the floor plan, the
schedule policy's action table of an episode, and the keys, all from the
configuration file, the traffic mix and the seed."""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

from portbench.oracle import building, clock


def floor_plan(spec: Dict) -> np.ndarray:
    return building.office_plan(**spec["floor_plan"])


def schedule_table(spec: Dict, traffic: Dict) -> np.ndarray:
    """The (T + 1, A) normalized actions of the mix's schedule policy: its
    day setpoints on workday hours [day_start, day_end) local, its night
    and weekend setpoints otherwise (SAC_Demo.ipynb's schedule policy)."""
    policy = traffic["schedule_policy"]
    start = clock.start_of(spec)
    dt = datetime.timedelta(seconds=spec["time_step_sec"])
    steps = int(spec["num_days_in_episode"] * 24 * 3600 / spec["time_step_sec"]) + 1
    out = np.zeros((steps, len(spec["actions"])), np.float32)
    for i in range(steps):
        local = clock.to_local(start + i * dt, spec["schedule"]["time_zone"])
        day = (policy["day_start_hour"] <= local.hour < policy["day_end_hour"]
               and clock.is_work_day(local.date()))
        values = policy["day" if day else "night_and_weekend"]
        for j, a in enumerate(spec["actions"]):
            lo, hi = a["native"]
            out[i, j] = (values[a["field"]] - lo) / (hi - lo) * 2.0 - 1.0
    return out


def key_rows(seed: int, stream: int, rows: int):
    """(rows, 2) int64 tensor of uint32 key words from the seed and a
    stream number."""
    import torch

    words = np.random.default_rng([int(seed), int(stream)]).integers(
        0, 2**32, size=(rows, 2), dtype=np.uint64)
    return torch.as_tensor(words.astype(np.int64))

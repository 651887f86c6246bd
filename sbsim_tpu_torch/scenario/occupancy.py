"""Batched stochastic occupancy model.

Each zone hosts N occupants that arrive/depart via per-step Bernoulli draws
whose probability follows a geometric distribution so the expected event lands
halfway through the arrival/departure window
(randomized_arrival_departure_occupancy.py:91-102). The per-occupant state
machine (AWAY/WORK, :125-146) is a boolean tensor (B, Z, N).

Port of sbsim_tpu/scenario/occupancy.py. The draws come from the port's
threefry (rng.uniform), bitwise equal to jax.random.uniform, so occupants
match the JAX package exactly for the same keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sbsim_tpu_torch import rng
from sbsim_tpu_torch.graphs import constant
from sbsim_tpu_torch.envs.config import OccupancyConfig


@dataclasses.dataclass(frozen=True)
class OccupancyParams:
    p_arrival: float  # float32-representable
    p_departure: float  # float32-representable
    earliest_arrival_hour: int
    latest_arrival_hour: int
    earliest_departure_hour: int
    occupants_per_zone: int
    kind: str


def make_occupancy_params(
    config: OccupancyConfig, time_step_sec: float
) -> OccupancyParams:
    def event_probability(start_hour: int, end_hour: int) -> float:
        # p = 1 / n_halfway (randomized_arrival_departure_occupancy.py:91-102)
        window_steps = (end_hour - start_hour) * 3600.0 / time_step_sec
        return float(np.float32(1.0 / (window_steps / 2.0)))

    return OccupancyParams(
        p_arrival=event_probability(
            config.earliest_expected_arrival_hour,
            config.latest_expected_arrival_hour,
        ),
        p_departure=event_probability(
            config.earliest_expected_departure_hour,
            config.latest_expected_departure_hour,
        ),
        earliest_arrival_hour=config.earliest_expected_arrival_hour,
        latest_arrival_hour=config.latest_expected_arrival_hour,
        earliest_departure_hour=config.earliest_expected_departure_hour,
        occupants_per_zone=config.zone_assignment,
        kind=config.kind,
    )


def initial_occupants(
    params: OccupancyParams, batch: int, n_zones: int, device=None
) -> torch.Tensor:
    """All occupants start AWAY (randomized_...occupancy.py:74)."""
    return torch.zeros(
        (batch, n_zones, params.occupants_per_zone),
        dtype=torch.bool,
        device=device,
    )


def occupancy_peek(
    working: torch.Tensor,
    key: torch.Tensor,
    local_hour: torch.Tensor,
    is_workday: torch.Tensor,
    params: OccupancyParams,
) -> torch.Tensor:
    """One peek: every occupant makes its arrival/departure draw.

    working (B, Z, N) bool; key (B, 2); local_hour (B,) int; is_workday (B,)
    bool. Parity: ZoneOccupant.peek (randomized_...occupancy.py:104-146): on
    non-workdays everyone is away; otherwise AWAY occupants may arrive while
    the local hour is within [earliest, latest] arrival, and WORK occupants
    may depart any time at/after the earliest departure hour.
    """
    u = rng.uniform(key, working.shape[1:])
    f32 = lambda p: constant(p, torch.float32, u.device)
    hour = local_hour.view(-1, 1, 1)
    in_arrival = (hour >= params.earliest_arrival_hour) & (
        hour <= params.latest_arrival_hour
    )
    can_depart = hour >= params.earliest_departure_hour
    arrives = (~working) & in_arrival & (u < f32(params.p_arrival))
    departs = working & can_depart & (u < f32(params.p_departure))
    new_working = torch.where(working, ~departs, arrives)
    return new_working & is_workday.view(-1, 1, 1)


def zone_occupancy(working: torch.Tensor) -> torch.Tensor:
    """Occupants currently at work per zone -> f32 (B, Z)."""
    return working.sum(dim=-1).to(torch.float32)

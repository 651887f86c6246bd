"""Exploration policies for replay seeding.

Port of sbsim_tpu/agents/exploration.py: `random_walk_policy` mirrors the
reference's scripted bounded random-walk collection policy
(agent_utils.py:32-117): each action dimension takes a small random step
per env step, reflected at the [-1, 1] bounds.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from sbsim_tpu_torch import rng as rng_lib


def random_walk_policy(
    n_actions: int, step_size: float = 0.1
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns walk(prev_actions, key) -> (actions, next_prev); prev_actions
    (..., n_actions) carries the walk state, key is one threefry key."""
    del n_actions  # the walk's width is prev_actions' last axis

    def walk(prev_actions: torch.Tensor, key: torch.Tensor):
        delta = rng_lib.uniform(key, prev_actions.shape, -step_size, step_size)
        raw = prev_actions + delta
        # Reflect at the bounds.
        reflected = torch.where(raw > 1.0, 2.0 - raw, raw)
        reflected = torch.where(reflected < -1.0, -2.0 - reflected, reflected)
        out = torch.clamp(reflected, -1.0, 1.0)
        return out, out

    return walk

"""Multi-building suites: heterogeneous buildings stepped together.

Port of sbsim_tpu/envs/suite.py. Different buildings have different grid
shapes, so each gets its own BuildingEnv, all on one device; a suite fans
the global env batch across the buildings and steps them one after the
other, each through its own batched FDM call (the CUDA kernel of its grid
on the card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from sbsim_tpu_torch import rng as rng_lib
from sbsim_tpu_torch.envs.building_env import BuildingEnv, EnvState, StepOutput
from sbsim_tpu_torch.envs.config import EnvConfig


class BuildingSuite:
    """A set of BuildingEnvs with a common action space, on one device
    ("cuda" unless the caller names another)."""

    def __init__(self, configs: Sequence[EnvConfig], device=None):
        self.envs: List[BuildingEnv] = [BuildingEnv(c, device=device) for c in configs]
        if len({e.n_actions for e in self.envs}) != 1:
            raise ValueError("suite buildings must share the action space")
        if len({e.obs_dim for e in self.envs}) != 1:
            raise ValueError("suite buildings must share the observation layout")

    @property
    def device(self) -> torch.device:
        return self.envs[0].device

    @property
    def n_buildings(self) -> int:
        return len(self.envs)

    @property
    def n_actions(self) -> int:
        return self.envs[0].n_actions

    @property
    def obs_dim(self) -> int:
        return self.envs[0].obs_dim

    def reset(
        self, key: torch.Tensor, envs_per_building: int
    ) -> Tuple[List[EnvState], torch.Tensor]:
        """Per-building batched states + the stacked observations
        (n_buildings * envs_per_building, obs_dim); building i's keys are
        split from fold_in(key, i)."""
        key = key.to(self.device, torch.int64)
        states, all_obs = [], []
        for i, env in enumerate(self.envs):
            keys = rng_lib.split(rng_lib.fold_in(key, i), envs_per_building)
            s, obs = env.reset(keys)
            states.append(s)
            all_obs.append(obs)
        return states, torch.cat(all_obs, dim=0)

    def step(
        self,
        states: List[EnvState],
        actions: torch.Tensor,
        use_pallas: bool = True,
    ) -> Tuple[List[EnvState], StepOutput]:
        """Steps every building; actions shaped (total_envs, n_actions),
        split evenly across buildings. The merged output concatenates the
        buildings' outputs, the reward breakdown field by field."""
        per = actions.shape[0] // self.n_buildings
        new_states, outs = [], []
        for i, env in enumerate(self.envs):
            s, out = env.step_batched(
                states[i], actions[i * per:(i + 1) * per], use_pallas=use_pallas
            )
            new_states.append(s)
            outs.append(out)
        breakdowns = [o.reward_breakdown for o in outs]
        merged = StepOutput(
            observation=torch.cat([o.observation for o in outs]),
            reward=torch.cat([o.reward for o in outs]),
            done=torch.cat([o.done for o in outs]),
            reward_breakdown=dataclasses.replace(breakdowns[0], **{
                f.name: torch.cat([torch.atleast_1d(getattr(b, f.name)) for b in breakdowns])
                for f in dataclasses.fields(breakdowns[0])
            }),
        )
        return new_states, merged

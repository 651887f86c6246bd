"""Policy export / load for deployment.

Port of sbsim_tpu/agents/policies.py. The reference exports TF-Agents
SavedModel policies (PolicySavedModelTrigger, SAC_Demo.ipynb cell 42); here
a trained actor's `state_dict` is saved with `torch.save`, beside the same
`policy_metadata.json` as the JAX package writes, and loads back into a
`policy(obs) -> normalized action` function: the actor's greedy forward as
a captured program (graphs.py, the JAX package's `@jax.jit`), fed by a
wrapper that moves host observations onto the device outside it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from sbsim_tpu_torch import graphs
from sbsim_tpu_torch.agents import networks
from sbsim_tpu_torch.agents.sac import SACLearner, SACState
from sbsim_tpu_torch.envs.building_env import resolve_device

ACTOR_FILE = "actor_state_dict.pt"
METADATA_FILE = "policy_metadata.json"


def save_policy(
    directory: str,
    learner: SACLearner,
    state: SACState,
    action_names: Sequence[str],
) -> None:
    """Writes the actor's parameters + metadata under `directory`."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    params = {k: v.detach().cpu() for k, v in state.actor_params.items()}
    torch.save(params, os.path.join(directory, ACTOR_FILE))
    metadata = {
        "obs_dim": learner.obs_dim,
        "action_dim": learner.action_dim,
        "actor_hidden": list(learner.config.actor_hidden),
        "action_names": list(action_names),
    }
    with open(os.path.join(directory, METADATA_FILE), "w") as f:
        json.dump(metadata, f, indent=2)


def load_policy(
    directory: str, device=None
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], dict]:
    """Returns (greedy_policy_fn, metadata); the actor runs on `device`
    ("cuda" unless the caller names another). The function takes host or
    device observations; `policy.program` is the captured greedy forward
    (its `eager` op by op)."""
    directory = os.path.abspath(directory)
    dev = resolve_device(device)
    with open(os.path.join(directory, METADATA_FILE)) as f:
        metadata = json.load(f)
    actor = networks.TanhGaussianActor(
        metadata["obs_dim"], metadata["action_dim"],
        hidden=tuple(metadata["actor_hidden"]),
    )
    params = torch.load(os.path.join(directory, ACTOR_FILE), map_location="cpu",
                        weights_only=True)
    actor.load_state_dict(params)
    actor.to(dev).eval()

    @torch.no_grad()
    def greedy(obs: torch.Tensor) -> torch.Tensor:
        mean, _ = actor(obs)
        return networks.deterministic_action(mean)

    program = graphs.capture(greedy)

    def policy(obs) -> torch.Tensor:
        return program(torch.as_tensor(obs, dtype=torch.float32, device=dev))

    policy.program = program
    return policy, metadata


def action_regularization_cost(previous_action: np.ndarray, action: np.ndarray) -> float:
    """L2 norm of the action delta - the smoothing penalty helper
    (environment.py:253-274)."""
    return float(
        np.linalg.norm(np.asarray(previous_action) - np.asarray(action), ord=2)
    )

"""Carries a batched EnvState across as nested dicts of numpy arrays.

The dict layout is the JAX package's EnvState field by field (as
`flax.serialization.to_state_dict` gives it), with the nested "hvac" dict of
HvacState fields and the threefry keys as uint32 (B, 2). A run of either
package can thus start from the exact state the other produced:

    tree = jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))
    torch_state = env_state_from_numpy(tree, device)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from sbsim_tpu_torch.envs.building_env import EnvState
from sbsim_tpu_torch.hvac.params import HvacState


def _to_tensor(name: str, value: Any, device) -> torch.Tensor:
    arr = np.asarray(value)
    if name == "rng":
        # uint32 keys ride in int64 (the port's hash arithmetic type).
        return torch.as_tensor(arr.astype(np.uint32).astype(np.int64), device=device)
    return torch.as_tensor(np.array(arr), device=device)


def env_state_from_numpy(tree: Dict[str, Any], device) -> EnvState:
    """EnvState on `device` from a nested dict of numpy arrays."""
    fields = {}
    for f in dataclasses.fields(EnvState):
        if f.name == "hvac":
            fields["hvac"] = HvacState(
                **{
                    h.name: _to_tensor(h.name, tree["hvac"][h.name], device)
                    for h in dataclasses.fields(HvacState)
                }
            )
        else:
            fields[f.name] = _to_tensor(f.name, tree[f.name], device)
    return EnvState(**fields)


def env_state_to_numpy(state: EnvState) -> Dict[str, Any]:
    """Nested dict of numpy arrays (keys as uint32) from an EnvState."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(EnvState):
        value = getattr(state, f.name)
        if f.name == "hvac":
            out["hvac"] = {
                h.name: getattr(value, h.name).detach().cpu().numpy()
                for h in dataclasses.fields(HvacState)
            }
        elif f.name == "rng":
            out["rng"] = value.detach().cpu().numpy().astype(np.uint32)
        else:
            out[f.name] = value.detach().cpu().numpy()
    return out

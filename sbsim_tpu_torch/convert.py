"""Carries states across packages as nested dicts of numpy arrays.

The dict layout is the JAX package's state field by field, as
`flax.serialization.to_state_dict` gives it:

  * EnvState, with the nested "hvac" dict of HvacState fields and the
    threefry keys as uint32 (B, 2);
  * SACState: flax parameter trees ({"params": {"MLP_0": {"Dense_0":
    {"kernel", "bias"}}, ...}}; a Dense kernel (in, out) is the port's
    Linear weight (out, in), a LayerNorm "scale" its weight), the target
    critic, log_alpha, and the optax Adam states (count, mu, nu) inside
    optax's chain tuples;
  * TrainState: the env states, last observations, replay ring, SACState,
    key and env-step count.

A run of either package can thus start from the exact state the other
produced:

    tree = jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))
    torch_state = env_state_from_numpy(tree, device)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from sbsim_tpu_torch.agents import networks
from sbsim_tpu_torch.agents import replay as replay_lib
from sbsim_tpu_torch.agents.sac import AdamState, SACLearner, SACState
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


# ---------------------------------------------------------------------------
# SAC parameters and optimizer state
# ---------------------------------------------------------------------------


def _flax_path(module: torch.nn.Module, name: str) -> Tuple[Tuple[str, ...], str, bool]:
    """(flax module path, flax leaf name, transpose?) of a parameter named
    as in `module.state_dict()`."""
    parts = name.split(".")
    path = ["params"]
    m = module
    i = 0
    while i < len(parts) - 1:
        if isinstance(m, networks.MLP):  # "layers", index
            path.append(f"Dense_{parts[i + 1]}")
            m = m.layers[int(parts[i + 1])]
            i += 2
        else:
            path.append(m.FLAX_NAMES[parts[i]])
            m = getattr(m, parts[i])
            i += 1
    if isinstance(m, networks.LayerNorm):
        return tuple(path), {"weight": "scale", "bias": "bias"}[parts[-1]], False
    return tuple(path), {"weight": "kernel", "bias": "bias"}[parts[-1]], parts[-1] == "weight"


def _get(tree: Dict[str, Any], path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def params_from_flax(module: torch.nn.Module, tree: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A flax parameter tree ({"params": ...}) as the module's named tensors."""
    out = {}
    for name in module.state_dict():
        path, leaf, transpose = _flax_path(module, name)
        arr = np.asarray(_get(tree, path + (leaf,)), np.float32)
        # Row-major like the module's own parameters: the matrix products
        # then take the same kernels, with the same rounding.
        out[name] = torch.as_tensor(np.ascontiguousarray(arr.T if transpose else arr),
                                    device=device)
    return out


def params_to_flax(module: torch.nn.Module, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, value in params.items():
        path, leaf, transpose = _flax_path(module, name)
        arr = value.detach().cpu().numpy()
        _put(tree, path + (leaf,), np.ascontiguousarray(arr.T) if transpose else arr)
    return tree


def _adam_node(opt_tree: Dict[str, Any], clipped: bool) -> Dict[str, Any]:
    """optax.adam's ScaleByAdamState inside chain tuples: (adam, lr) or,
    with clipping, (clip, (adam, lr))."""
    return opt_tree["1"]["0"] if clipped else opt_tree["0"]


def _adam_tree(node: Dict[str, Any], clipped: bool) -> Dict[str, Any]:
    chain = {"0": node, "1": {}}
    return {"0": {}, "1": chain} if clipped else chain


def sac_state_from_numpy(tree: Dict[str, Any], learner: SACLearner) -> SACState:
    """The port's SACState, on the learner's device, from a JAX SACState
    tree (flax.serialization.to_state_dict, leaves as numpy arrays)."""
    dev = learner.device
    clipped = learner.config.gradient_clipping is not None
    actor = lambda t: params_from_flax(learner.actor, t, dev)
    critic = lambda t: params_from_flax(learner.critic, t, dev)
    i32 = lambda a: torch.as_tensor(np.array(a, np.int32), device=dev)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)

    def adam(opt_tree, convert_params):
        node = _adam_node(opt_tree, clipped)
        return AdamState(count=i32(node["count"]), mu=convert_params(node["mu"]),
                         nu=convert_params(node["nu"]))

    alpha = tree["alpha_opt"]["0"]
    return SACState(
        actor_params=actor(tree["actor_params"]),
        critic_params=critic(tree["critic_params"]),
        target_critic_params=critic(tree["target_critic_params"]),
        log_alpha=f32(tree["log_alpha"]),
        actor_opt=adam(tree["actor_opt"], actor),
        critic_opt=adam(tree["critic_opt"], critic),
        alpha_opt=AdamState(count=i32(alpha["count"]), mu=f32(alpha["mu"]),
                            nu=f32(alpha["nu"])),
        step=i32(tree["step"]),
    )


def sac_state_to_numpy(state: SACState, learner: SACLearner) -> Dict[str, Any]:
    """A JAX SACState tree (for flax.serialization.from_state_dict) from the
    port's SACState."""
    clipped = learner.config.gradient_clipping is not None
    actor = lambda p: params_to_flax(learner.actor, p)
    critic = lambda p: params_to_flax(learner.critic, p)
    np_ = lambda t: t.detach().cpu().numpy()

    def adam(opt: AdamState, convert_params):
        node = {"count": np_(opt.count), "mu": convert_params(opt.mu),
                "nu": convert_params(opt.nu)}
        return _adam_tree(node, clipped)

    a = state.alpha_opt
    return {
        "actor_params": actor(state.actor_params),
        "critic_params": critic(state.critic_params),
        "target_critic_params": critic(state.target_critic_params),
        "log_alpha": np_(state.log_alpha),
        "actor_opt": adam(state.actor_opt, actor),
        "critic_opt": adam(state.critic_opt, critic),
        "alpha_opt": _adam_tree(
            {"count": np_(a.count), "mu": np_(a.mu), "nu": np_(a.nu)}, False),
        "step": np_(state.step),
    }


# ---------------------------------------------------------------------------
# Trainer state
# ---------------------------------------------------------------------------


def train_state_from_numpy(tree: Dict[str, Any], trainer):
    """The port's TrainState for `trainer` (an agents.train.SACTrainer) from
    a JAX TrainState tree."""
    from sbsim_tpu_torch.agents.train import TrainState

    dev = trainer.device
    t = lambda a: torch.as_tensor(np.array(a), device=dev)
    rep = tree["replay"]
    data = replay_lib.Transition(**{k: t(rep["data"][k]).to(torch.float32)
                                    for k in ("obs", "action", "reward", "discount",
                                              "next_obs")})
    ring = dict(data=data, insert_index=t(rep["insert_index"]).to(torch.int32),
                size=t(rep["size"]).to(torch.int32))
    if trainer.config.replay_layout == "per_env":
        replay = replay_lib.ShardedReplayState(per_env_capacity=data.reward.shape[1], **ring)
    else:
        replay = replay_lib.ReplayState(capacity=data.reward.shape[0], **ring)
    return TrainState(
        env_states=env_state_from_numpy(tree["env_states"], dev),
        last_obs=t(tree["last_obs"]).to(torch.float32),
        replay=replay,
        sac=sac_state_from_numpy(tree["sac"], trainer.learner),
        rng=_to_tensor("rng", tree["rng"], dev),
        env_steps=int(np.asarray(tree["env_steps"])),
    )


def train_state_to_numpy(state, trainer) -> Dict[str, Any]:
    """A JAX TrainState tree from the port's TrainState."""
    np_ = lambda x: x.detach().cpu().numpy()
    rep = state.replay
    return {
        "env_states": env_state_to_numpy(state.env_states),
        "last_obs": np_(state.last_obs),
        "replay": {
            "data": {f.name: np_(getattr(rep.data, f.name))
                     for f in dataclasses.fields(rep.data)},
            "insert_index": np_(rep.insert_index),
            "size": np_(rep.size),
        },
        "sac": sac_state_to_numpy(state.sac, trainer.learner),
        "rng": np_(state.rng).astype(np.uint32),
        "env_steps": np.int32(state.env_steps),
    }

# Frozen copy of sbsim_tpu_torch/agents/networks.py at commit c9d3945, part of the benchmark's plain reference.
"""Actor and critic networks for SAC (torch.nn).

Port of sbsim_tpu/agents/networks.py (flax.linen). Mirrors the reference's
network shapes (SAC_Demo.ipynb cell 24): actor MLP (128, 128) with a
tanh-squashed Gaussian head; critic with separate observation (128, 64) and
action (128, 64) towers concatenated into a joint (128, 64) MLP -> scalar;
twin critics evaluated in one call.

Numerics follow flax so that carried-over parameters give the same outputs:
Dense layers are `nn.Linear` (weight = the flax kernel transposed) with
glorot-uniform weights and zero biases drawn from an explicit
`torch.Generator`; `LayerNorm` is flax's (epsilon 1e-6, variance as
mean(x^2) - mean(x)^2), not `torch.nn.LayerNorm` (eps 1e-5, two-pass
variance).

The learner evaluates these modules functionally on parameter dicts
(`torch.func.functional_call`), as the JAX package applies its modules to
parameter pytrees.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from portbench.oracle.sac import rng as rng_lib
from portbench.oracle.sac.constants import constant

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0
LAYER_NORM_EPS = 1e-6


def _dense(in_dim: int, out_dim: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """flax nn.Dense(kernel_init=glorot_uniform): U(-l, l) weights with
    l = sqrt(6 / (fan_in + fan_out)), zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    with torch.no_grad():
        layer.weight.uniform_(-limit, limit, generator=generator)
        layer.bias.zero_()
    return layer


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis: y = (x - mean) *
    (rsqrt(var + 1e-6) * scale) + bias, var = max(0, mean(x^2) - mean^2)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * self.weight
        return (x - mean) * mul + self.bias


class MLP(nn.Module):
    def __init__(
        self,
        in_dim: int,
        features: Sequence[int],
        activate_last: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_dim, *features]
        self.layers = nn.ModuleList(
            _dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )
        self.activate_last = activate_last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.activate_last or i < last:
                x = torch.relu(x)
        return x


class TanhGaussianActor(nn.Module):
    """Tanh-squashed diagonal Gaussian policy; `input_norm` whitens the raw
    observation (see the JAX module for why)."""

    # flax submodule name of each attribute (convert.py maps parameters).
    FLAX_NAMES = {"norm": "LayerNorm_0", "body": "MLP_0", "mean": "Dense_0",
                  "log_std": "Dense_1"}

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (128, 128),
        input_norm: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.norm = LayerNorm(obs_dim) if input_norm else None
        self.body = MLP(obs_dim, hidden, generator=generator)
        width = hidden[-1] if hidden else obs_dim
        self.mean = _dense(width, action_dim, generator)
        self.log_std = _dense(width, action_dim, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.norm is not None:
            obs = self.norm(obs)
        x = self.body(obs)
        log_std = torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX)
        return self.mean(x), log_std


def sample_action(
    mean: torch.Tensor,
    log_std: torch.Tensor,
    key: Optional[torch.Tensor] = None,
    *,
    eps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized sample + log-prob under the tanh-squashed Gaussian.
    The N(0, 1) noise is `eps`, or drawn from the threefry `key`."""
    std = torch.exp(log_std)
    if eps is None:
        if key is None:
            raise ValueError("sample_action needs either `key` or `eps`")
        eps = rng_lib.normal(key, mean.shape)
    pre_tanh = mean + std * eps
    action = torch.tanh(pre_tanh)
    log_2pi = torch.log(constant(2.0 * math.pi, mean.dtype, mean.device))
    gauss_logp = -0.5 * (((pre_tanh - mean) / std) ** 2 + 2.0 * log_std + log_2pi)
    # log(1 - tanh(x)^2) = 2 * (log 2 - x - softplus(-2x)), numerically
    # stable; softplus as jax.nn.softplus, logaddexp(x, 0).
    log_2 = torch.log(constant(2.0, mean.dtype, mean.device))
    softplus = torch.logaddexp(-2.0 * pre_tanh, torch.zeros_like(pre_tanh))
    correction = 2.0 * (log_2 - pre_tanh - softplus)
    log_prob = torch.sum(gauss_logp - correction, dim=-1)
    return action, log_prob


def deterministic_action(mean: torch.Tensor) -> torch.Tensor:
    return torch.tanh(mean)


class Critic(nn.Module):
    """Q(s, a) with separate obs/action towers and a joint MLP."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        obs_hidden: Sequence[int] = (128, 64),
        action_hidden: Sequence[int] = (128, 64),
        joint_hidden: Sequence[int] = (128, 64),
        input_norm: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.norm = LayerNorm(obs_dim) if input_norm else None
        g = generator
        self.obs_tower = MLP(obs_dim, obs_hidden, generator=g) if obs_hidden else None
        self.action_tower = (
            MLP(action_dim, action_hidden, generator=g) if action_hidden else None
        )
        o = obs_hidden[-1] if obs_hidden else obs_dim
        a = action_hidden[-1] if action_hidden else action_dim
        self.joint = MLP(o + a, joint_hidden, generator=g)
        self.head = _dense(joint_hidden[-1] if joint_hidden else o + a, 1, g)
        # flax numbers the MLPs in the order they are built.
        towers = [n for n in ("obs_tower", "action_tower") if getattr(self, n) is not None]
        self.FLAX_NAMES = {"norm": "LayerNorm_0", "head": "Dense_0"}
        for i, n in enumerate(towers + ["joint"]):
            self.FLAX_NAMES[n] = f"MLP_{i}"

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        if self.norm is not None:
            obs = self.norm(obs)
        o = self.obs_tower(obs) if self.obs_tower is not None else obs
        a = self.action_tower(action) if self.action_tower is not None else action
        x = self.joint(torch.cat([o, a], dim=-1))
        return self.head(x).squeeze(-1)


class TwinCritic(nn.Module):
    """Two independent critics evaluated in one call."""

    FLAX_NAMES = {"q1": "Critic_0", "q2": "Critic_1"}

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        obs_hidden: Sequence[int] = (128, 64),
        action_hidden: Sequence[int] = (128, 64),
        joint_hidden: Sequence[int] = (128, 64),
        input_norm: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        args = (obs_dim, action_dim, obs_hidden, action_hidden, joint_hidden, input_norm)
        self.q1 = Critic(*args, generator=generator)
        self.q2 = Critic(*args, generator=generator)

    def forward(self, obs, action):
        return self.q1(obs, action), self.q2(obs, action)

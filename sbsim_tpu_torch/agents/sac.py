"""Soft Actor-Critic learner.

Port of sbsim_tpu/agents/sac.py (the TF-Agents SacAgent recipe of
SAC_Demo.ipynb cells 24-26): twin critics with squared TD error,
tanh-Gaussian actor, automatic temperature tuning toward target entropy
-|A|, Polyak target updates (tau = 0.005 every step), Adam 3e-4
everywhere, gamma 0.99.

Parameters and optimizer moments live in plain dicts of tensors (the
modules' `state_dict` names), and `update` is a function of the state as in
the JAX package: gradients come from `torch.autograd` on the modules
applied with `torch.func.functional_call`. Adam and global-norm clipping
are written out to follow optax's formulas, which `torch.optim.Adam` and
`clip_grad_norm_` do not (optax divides by sqrt(nu_hat) + eps and leaves a
gradient untouched when its global norm is below the limit;
`clip_grad_norm_` adds 1e-6 to the norm).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from sbsim_tpu_torch import rng as rng_lib
from sbsim_tpu_torch.agents import networks
from sbsim_tpu_torch.agents.replay import Transition
from sbsim_tpu_torch.distributed import runtime
from sbsim_tpu_torch.envs.building_env import resolve_device
from sbsim_tpu_torch.graphs import constant
from sbsim_tpu_torch.utils import profiling

Params = Dict[str, torch.Tensor]

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class SACConfig:
    actor_hidden: Tuple[int, ...] = (128, 128)
    critic_obs_hidden: Tuple[int, ...] = (128, 64)
    critic_action_hidden: Tuple[int, ...] = (128, 64)
    critic_joint_hidden: Tuple[int, ...] = (128, 64)
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    reward_scale: float = 1.0
    init_alpha: float = 1.0
    # Optional global-norm gradient clipping of the actor and critic
    # gradients (None disables).
    gradient_clipping: Optional[float] = None
    # Floor on the temperature (0 disables).
    min_alpha: float = 0.0
    # Target entropy; None -> -|A|.
    target_entropy: Optional[float] = None
    # L2 penalty on the actor's pre-tanh mean (0 disables).
    mean_reg: float = 0.0


@dataclasses.dataclass(frozen=True)
class AdamState:
    """optax.scale_by_adam's state: step count and the two moments, shaped
    like the parameters (a dict, or one tensor for the temperature)."""

    count: torch.Tensor  # i32 scalar
    mu: Union[Params, torch.Tensor]
    nu: Union[Params, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SACState:
    actor_params: Params
    critic_params: Params
    target_critic_params: Params
    log_alpha: torch.Tensor  # f32 scalar
    actor_opt: AdamState
    critic_opt: AdamState
    alpha_opt: AdamState
    step: torch.Tensor  # i32 scalar

    def replace(self, **changes) -> "SACState":
        return dataclasses.replace(self, **changes)


def adam_init(params: Union[Params, torch.Tensor]) -> AdamState:
    zeros = lambda p: (
        {k: torch.zeros_like(v) for k, v in p.items()} if isinstance(p, dict)
        else torch.zeros_like(p)
    )
    device = next(iter(params.values())).device if isinstance(params, dict) else params.device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                     mu=zeros(params), nu=zeros(params))


@torch.no_grad()
def adam_step(
    grads: Params,
    opt: AdamState,
    params: Params,
    lr: float,
    clip: Optional[float] = None,
) -> Tuple[Params, AdamState]:
    """optax.chain(clip_by_global_norm(clip), adam(lr)) then apply_updates:
    returns the new parameters and optimizer state."""
    if clip is not None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < clip
        grads = {k: torch.where(keep, g, (g / g_norm) * clip) for k, g in grads.items()}
    count = opt.count + 1
    c1 = 1.0 - constant(ADAM_B1, torch.float32, count.device) ** count.to(torch.float32)
    c2 = 1.0 - constant(ADAM_B2, torch.float32, count.device) ** count.to(torch.float32)
    mu, nu, new_params = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * opt.mu[k]
        nu[k] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * opt.nu[k]
        update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
        new_params[k] = params[k] + (-lr) * update
    return new_params, AdamState(count=count, mu=mu, nu=nu)


def _seeded_generator(key: torch.Tensor) -> torch.Generator:
    """A CPU generator seeded from a threefry key's 64 bits."""
    k0, k1 = (int(v) for v in key.tolist())
    return torch.Generator().manual_seed((k0 << 32) | k1)


class SACLearner:
    """Holds the static pieces (module templates, config); `init`, `act`,
    `act_greedy` and `update` act on SACState values."""

    def __init__(self, obs_dim: int, action_dim: int, config: SACConfig = SACConfig(),
                 device=None):
        self.config = config
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.device = resolve_device(device)
        with torch.device("meta"):
            self.actor = self._make_actor()
            self.critic = self._make_critic()
        self.target_entropy = (
            config.target_entropy
            if config.target_entropy is not None
            else -float(action_dim)
        )

    def _make_actor(self, generator=None) -> networks.TanhGaussianActor:
        return networks.TanhGaussianActor(
            self.obs_dim, self.action_dim, hidden=self.config.actor_hidden,
            generator=generator,
        )

    def _make_critic(self, generator=None) -> networks.TwinCritic:
        c = self.config
        return networks.TwinCritic(
            self.obs_dim, self.action_dim, obs_hidden=c.critic_obs_hidden,
            action_hidden=c.critic_action_hidden, joint_hidden=c.critic_joint_hidden,
            generator=generator,
        )

    def init(self, key: torch.Tensor) -> SACState:
        """Fresh parameters (glorot-uniform from generators seeded by the
        two halves of split(key)), optimizer states and log(init_alpha)."""
        k_actor, k_critic = rng_lib.split(key.to("cpu", torch.int64))
        dev = self.device
        take = lambda m: {k: v.detach().to(dev) for k, v in m.state_dict().items()}
        actor_params = take(self._make_actor(_seeded_generator(k_actor)))
        critic_params = take(self._make_critic(_seeded_generator(k_critic)))
        log_alpha = torch.log(torch.tensor(self.config.init_alpha, dtype=torch.float32,
                                           device=dev))
        return SACState(
            actor_params=actor_params,
            critic_params=critic_params,
            target_critic_params={k: v.clone() for k, v in critic_params.items()},
            log_alpha=log_alpha,
            actor_opt=adam_init(actor_params),
            critic_opt=adam_init(critic_params),
            alpha_opt=adam_init(log_alpha),
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def actor_apply(self, params: Params, obs: torch.Tensor):
        return functional_call(self.actor, params, (obs,))

    def critic_apply(self, params: Params, obs: torch.Tensor, action: torch.Tensor):
        return functional_call(self.critic, params, (obs, action))

    # ------------------------------------------------------------------
    # Acting
    # ------------------------------------------------------------------

    @torch.no_grad()
    def act(self, state: SACState, obs: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        """Stochastic policy action in [-1, 1]."""
        mean, log_std = self.actor_apply(state.actor_params, obs)
        action, _ = networks.sample_action(mean, log_std, key)
        return action

    @torch.no_grad()
    def act_greedy(self, state: SACState, obs: torch.Tensor) -> torch.Tensor:
        mean, _ = self.actor_apply(state.actor_params, obs)
        return networks.deterministic_action(mean)

    # ------------------------------------------------------------------
    # Learning
    # ------------------------------------------------------------------

    def update(
        self,
        state: SACState,
        batch: Transition,
        key: torch.Tensor,
        *,
        group=None,
        noise_block: Optional[Tuple[int, int]] = None,
    ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """One SAC gradient step on a batch of transitions: the critic, then
        the actor against the new critic, then the temperature, then the
        Polyak target update.

        On a mesh of ranks (distributed/mesh.make_shardmapped_train_step),
        `batch` is this rank's block of a global batch:
        `noise_block=(offset, total)` draws the reparameterisation noise at
        the global (total, action_dim) shape and takes rows [offset,
        offset + local batch), and `group` (the mesh's process group) is
        the counterpart of the JAX package's `axis_name`: the gradients, and
        the statistics the update reads or reports, are mean-reduced over
        it before they are used. So N ranks each updating on 1/N of the
        batch apply the update one process computes on the whole batch, up
        to the order of the sums. Traced, its parts are the spans
        `sbsim.sac.critic`, `sbsim.sac.actor`, `sbsim.sac.alpha` and
        `sbsim.sac.target`."""
        cfg = self.config
        k_next, k_actor = rng_lib.split(key)
        alpha = torch.exp(state.log_alpha)
        local_b = batch.reward.shape[0]

        def draw_eps(k):
            if noise_block is None:
                return rng_lib.normal(k, (local_b, self.action_dim))
            offset, total = noise_block
            return rng_lib.normal(k, (total, self.action_dim))[offset:offset + local_b]

        def pmean(*tensors):
            if group is None:
                return tensors
            return runtime.all_reduce_mean(tensors, group)

        # --- Critic update -------------------------------------------------
        with profiling.span("sbsim.sac.critic"):
            with torch.no_grad():
                mean_n, log_std_n = self.actor_apply(state.actor_params, batch.next_obs)
                next_action, next_logp = networks.sample_action(
                    mean_n, log_std_n, eps=draw_eps(k_next)
                )
                tq1, tq2 = self.critic_apply(
                    state.target_critic_params, batch.next_obs, next_action
                )
                target_v = torch.minimum(tq1, tq2) - alpha * next_logp
                target_q = cfg.reward_scale * batch.reward + cfg.gamma * batch.discount * target_v

            with torch.enable_grad():
                params = {k: v.detach().requires_grad_() for k, v in state.critic_params.items()}
                q1, q2 = self.critic_apply(params, batch.obs, batch.action)
                critic_loss = torch.mean((q1 - target_q) ** 2 + (q2 - target_q) ** 2)
                grads = torch.autograd.grad(critic_loss, list(params.values()))
            *grads, critic_loss, q1m, q2m = pmean(
                *grads, critic_loss.detach(), torch.mean(q1.detach()), torch.mean(q2.detach()))
            critic_params, critic_opt = adam_step(
                dict(zip(params, grads)), state.critic_opt, state.critic_params,
                cfg.critic_lr, cfg.gradient_clipping,
            )

        # --- Actor update --------------------------------------------------
        with profiling.span("sbsim.sac.actor"):
            eps_actor = draw_eps(k_actor)
            with torch.enable_grad():
                params = {k: v.detach().requires_grad_() for k, v in state.actor_params.items()}
                mean, log_std = self.actor_apply(params, batch.obs)
                action, logp = networks.sample_action(mean, log_std, eps=eps_actor)
                q1n, q2n = self.critic_apply(critic_params, batch.obs, action)
                actor_loss = torch.mean(alpha * logp - torch.minimum(q1n, q2n))
                if cfg.mean_reg > 0.0:
                    actor_loss = actor_loss + cfg.mean_reg * torch.mean(mean * mean)
                grads = torch.autograd.grad(actor_loss, list(params.values()))
            # entropy_neg feeds the alpha loss below: reduced first, so that the
            # temperature update is the same on every rank.
            *grads, actor_loss, entropy_neg = pmean(
                *grads, actor_loss.detach(), torch.mean(logp.detach()))
            actor_params, actor_opt = adam_step(
                dict(zip(params, grads)), state.actor_opt, state.actor_params,
                cfg.actor_lr, cfg.gradient_clipping,
            )

        # --- Temperature update -------------------------------------------
        with profiling.span("sbsim.sac.alpha"):
            with torch.enable_grad():
                log_alpha = state.log_alpha.detach().requires_grad_()
                alpha_loss = -torch.exp(log_alpha) * (entropy_neg + self.target_entropy)
                (alpha_grad,) = torch.autograd.grad(alpha_loss, [log_alpha])
            new_alpha, alpha_opt = adam_step(
                {"log_alpha": alpha_grad},
                AdamState(state.alpha_opt.count, {"log_alpha": state.alpha_opt.mu},
                          {"log_alpha": state.alpha_opt.nu}),
                {"log_alpha": state.log_alpha}, cfg.alpha_lr,
            )
            log_alpha = new_alpha["log_alpha"]
            alpha_opt = AdamState(alpha_opt.count, alpha_opt.mu["log_alpha"],
                                  alpha_opt.nu["log_alpha"])
            if cfg.min_alpha > 0.0:
                floor = torch.log(constant(cfg.min_alpha, torch.float32, log_alpha.device))
                log_alpha = torch.maximum(log_alpha, floor)

        # --- Target network Polyak update ---------------------------------
        with profiling.span("sbsim.sac.target"):
            with torch.no_grad():
                target = {
                    k: (1.0 - cfg.tau) * t + cfg.tau * critic_params[k]
                    for k, t in state.target_critic_params.items()
                }

        new_state = SACState(
            actor_params=actor_params,
            critic_params=critic_params,
            target_critic_params=target,
            log_alpha=log_alpha,
            actor_opt=actor_opt,
            critic_opt=critic_opt,
            alpha_opt=alpha_opt,
            step=state.step + 1,
        )
        metrics = {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha_loss": alpha_loss.detach(),
            "alpha": torch.exp(log_alpha),
            "q1_mean": q1m,
            "q2_mean": q2m,
            "entropy": -entropy_neg,
        }
        return new_state, metrics

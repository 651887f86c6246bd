"""Training loop: batched rollout + replay + SAC updates.

Port of sbsim_tpu/agents/train.py, which replaces the reference's
Actor/Learner/Reverb triangle (SAC_Demo.ipynb cells 28-48): N envs step in
lockstep on the device (`BuildingEnv.step_batched`, whose FDM solve is the
CUDA kernel K2 on the card), the transitions stream into the device replay
ring, and K SAC gradient steps run per env step.

The rng schedule is the JAX package's key for key (threefry, bitwise equal
to jax.random), so a TrainState carried over from it takes the same steps.
The two JAX-side branches become host branches: `_maybe_reset` resets only
when some env finished (it reads `done.any()`, one device sync per env
step), and the update gate reads the host-side `env_steps` count.

`ShardHooks` let the same `collect_step` / `train_step` run as each rank's
program on a mesh (distributed/mesh.py): they draw at the global shape and
take the rank's rows, and mean-reduce across ranks. Every default is the
one-process behaviour.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from sbsim_tpu_torch import rng as rng_lib
from sbsim_tpu_torch.agents import replay as replay_lib
from sbsim_tpu_torch.agents.replay import ReplayState, ShardedReplayState, Transition
from sbsim_tpu_torch.agents.sac import SACConfig, SACLearner, SACState
from sbsim_tpu_torch.envs.building_env import BuildingEnv, EnvState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_envs: int = 16
    replay_capacity: int = 50_000  # total across envs
    batch_size: int = 256
    updates_per_env_step: int = 1
    seed_steps: int = 1_000  # env steps before learning starts
    # "per_env": one sub-ring per env; "flat": a single ring.
    replay_layout: str = "per_env"
    # FDM path of the batched rollout (BuildingEnv.step_batched): "auto" is
    # the CUDA kernel K2 ("pallas_env") on the card, the plain solver on
    # the CPU.
    env_solver: str = "auto"
    sac: SACConfig = SACConfig()


# Zone count at or above which the full-scale recipe adds the temperature
# floor (the JAX package's 126-room collapse ablation, artifacts/RESULTS.md).
FULL_SCALE_ZONE_THRESHOLD = 100
FULL_SCALE_MIN_ALPHA = 0.01


def recipe_for(
    env: BuildingEnv,
    n_envs: int = 64,
    batch_size: int = 256,
    **overrides,
) -> TrainConfig:
    """The documented training recipe for a building, gated on its scale:
    the reference SAC recipe below FULL_SCALE_ZONE_THRESHOLD zones, plus
    min_alpha=0.01 at and above it. Keyword overrides replace TrainConfig
    fields; pass sac=SACConfig(...) to replace the SAC recipe entirely."""
    if "sac" not in overrides:
        sac = SACConfig()
        if env.n_zones >= FULL_SCALE_ZONE_THRESHOLD:
            sac = dataclasses.replace(sac, min_alpha=FULL_SCALE_MIN_ALPHA)
        overrides["sac"] = sac
    return TrainConfig(n_envs=n_envs, batch_size=batch_size, **overrides)


@dataclasses.dataclass(frozen=True)
class TrainState:
    env_states: EnvState  # batched (B, ...)
    last_obs: torch.Tensor  # (B, obs_dim)
    replay: Union[ShardedReplayState, ReplayState]
    sac: SACState
    rng: torch.Tensor  # (2,) threefry key
    env_steps: int  # total env steps taken

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShardHooks:
    """Localizes the trainer's stochastic draws and reductions for one rank
    of a mesh, so that `collect_step` / `train_step` run unchanged as the
    rank's program (distributed/mesh.make_shardmapped_train_step). Every
    default is the one-process behaviour; the rank's versions draw at the
    global batch shape from the replicated key and take the rank's rows,
    which keeps N ranks consistent with one process (up to the order of the
    reduced sums).

    policy: (sac_state, obs, k_act) -> actions  (in place of learner.act)
    reset_keys: k_reset -> the per-env reset keys of this rank's rows
    sample: (replay, k_sample) -> the Transition batch of this rank's rows
    reduce: metric reduction (identity, or the mean over the ranks)
    gather: this rank's Transition rows -> every rank's, in rank order (the
        flat ring's insert: the ring is replicated and holds all n_envs
        rows of each step, as the JAX package's GSPMD ring does)
    update_kwargs: extra keyword arguments of learner.update (group,
        noise_block)
    """

    policy: Optional[Callable[..., torch.Tensor]] = None
    reset_keys: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    sample: Optional[Callable[..., Transition]] = None
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    gather: Optional[Callable[[Transition], Transition]] = None
    update_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def reduce_metric(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.reduce is None else self.reduce(x)


_NO_HOOKS = ShardHooks()


def _select(mask: torch.Tensor, new, old):
    """Field by field: `new` where the (B,) mask holds, else `old`."""
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(old, **{
            f.name: _select(mask, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)
        })
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _zero_metrics(sac: SACState) -> Dict[str, torch.Tensor]:
    zero = torch.zeros((), dtype=torch.float32, device=sac.log_alpha.device)
    return {
        "critic_loss": zero, "actor_loss": zero, "alpha_loss": zero,
        "alpha": torch.exp(sac.log_alpha), "q1_mean": zero, "q2_mean": zero,
        "entropy": zero,
    }


class SACTrainer:
    def __init__(self, env: BuildingEnv, config: TrainConfig = TrainConfig()):
        self.env = env
        self.config = config
        if config.replay_layout not in ("per_env", "flat"):
            raise ValueError(f"unknown replay_layout: {config.replay_layout}")
        if config.replay_layout == "per_env" and config.batch_size % config.n_envs != 0:
            raise ValueError(
                f"batch_size={config.batch_size} must be a multiple of "
                f"n_envs={config.n_envs} under the per_env replay layout "
                "(stratified sampling draws batch_size//n_envs slots per "
                "env); otherwise the effective batch would silently differ"
            )
        self.learner = SACLearner(env.obs_dim, env.n_actions, config.sac, device=env.device)
        self._solver = config.env_solver

    @property
    def device(self) -> torch.device:
        return self.env.device

    def _step_v(self, states: EnvState, actions: torch.Tensor):
        return self.env.step_batched(states, actions, solver=self._solver)

    def with_solver(self, solver: str) -> "SACTrainer":
        """A trainer clone whose env step runs an explicit FDM solver."""
        clone = copy.copy(self)
        clone._solver = solver
        return clone

    def init(self, key: torch.Tensor) -> TrainState:
        key = key.to(self.device, torch.int64)
        k_env, k_sac, k_rng = rng_lib.split(key, 3)
        env_states, obs = self.env.reset(rng_lib.split(k_env, self.config.n_envs))
        cfg = self.config
        if cfg.replay_layout == "per_env":
            replay = replay_lib.init_sharded_replay(
                cfg.n_envs, max(1, cfg.replay_capacity // cfg.n_envs),
                self.env.obs_dim, self.env.n_actions, device=self.device,
            )
        else:
            replay = replay_lib.init_replay(
                cfg.replay_capacity, self.env.obs_dim, self.env.n_actions,
                device=self.device,
            )
        return TrainState(
            env_states=env_states,
            last_obs=obs,
            replay=replay,
            sac=self.learner.init(k_sac),
            rng=k_rng,
            env_steps=0,
        )

    # ------------------------------------------------------------------

    def _maybe_reset(
        self, env_states: EnvState, obs: torch.Tensor, done: torch.Tensor, key: torch.Tensor,
        hooks: ShardHooks = _NO_HOOKS,
    ) -> Tuple[EnvState, torch.Tensor]:
        """Resets envs that finished their episode (masked select), only
        when some env did (episodes are hundreds of steps)."""
        if not bool(done.any()):
            return env_states, obs
        if hooks.reset_keys is not None:
            keys = hooks.reset_keys(key)
        else:
            keys = rng_lib.split(key, self.config.n_envs)
        fresh_states, fresh_obs = self.env.reset(keys)
        return _select(done, fresh_states, env_states), _select(done, fresh_obs, obs)

    def collect_step(
        self,
        state: TrainState,
        action_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        hooks: ShardHooks = _NO_HOOKS,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One lockstep env transition for all envs, appended to replay."""
        rng, k_act, k_reset = rng_lib.split(state.rng, 3)
        actions = action_fn(state.last_obs, k_act)
        env_states, out = self._step_v(state.env_states, actions)
        discount = torch.where(
            out.done,
            torch.zeros((), device=self.device),
            torch.tensor(self.env.config.discount_factor, dtype=torch.float32,
                         device=self.device),
        )
        batch = Transition(
            obs=state.last_obs, action=actions, reward=out.reward,
            discount=discount, next_obs=out.observation,
        )
        if isinstance(state.replay, ShardedReplayState):
            replay = replay_lib.add_batch_sharded(state.replay, batch)
        else:
            if hooks.gather is not None:
                batch = hooks.gather(batch)
            replay = replay_lib.add_batch(state.replay, batch)
        env_states, obs = self._maybe_reset(env_states, out.observation, out.done, k_reset,
                                            hooks)
        new_state = state.replace(
            env_states=env_states,
            last_obs=obs,
            replay=replay,
            rng=rng,
            env_steps=state.env_steps + self.config.n_envs,
        )
        return new_state, {"reward_mean": hooks.reduce_metric(torch.mean(out.reward))}

    def _sample(self, replay, key: torch.Tensor, hooks: ShardHooks = _NO_HOOKS) -> Transition:
        if hooks.sample is not None:
            return hooks.sample(replay, key)
        if isinstance(replay, ShardedReplayState):
            return replay_lib.sample_sharded(replay, key, self.config.batch_size)
        return replay_lib.sample(replay, key, self.config.batch_size)

    def update(
        self, state: TrainState, hooks: ShardHooks = _NO_HOOKS
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The K SAC updates of one train step (zero metrics before
        `seed_steps` env steps), each on a fresh replay sample."""
        rng, k_updates = rng_lib.split(state.rng)
        update_keys = rng_lib.split(k_updates, self.config.updates_per_env_step)
        sac = state.sac
        metrics = _zero_metrics(sac)
        if state.env_steps >= self.config.seed_steps:
            for key in update_keys:
                k_sample, k_update = rng_lib.split(key)
                batch = self._sample(state.replay, k_sample, hooks)
                sac, metrics = self.learner.update(sac, batch, k_update, **hooks.update_kwargs)
        return state.replace(sac=sac, rng=rng), metrics

    def train_step(
        self, state: TrainState, hooks: ShardHooks = _NO_HOOKS
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One env step (policy actions) + K SAC updates. With `hooks` the
        same body is each rank's program on a mesh; the rng schedule and the
        order of the steps stay this function's."""

        def policy(obs, key):
            if hooks.policy is not None:
                return hooks.policy(state.sac, obs, key)
            return self.learner.act(state.sac, obs, key)

        state, metrics = self.collect_step(state, policy, hooks)
        state, update_metrics = self.update(state, hooks)
        metrics.update(update_metrics)
        return state, metrics

    def seed_with_actions(
        self, state: TrainState, action_table: np.ndarray, hooks: ShardHooks = _NO_HOOKS
    ) -> Callable[[TrainState], Tuple[TrainState, Dict[str, torch.Tensor]]]:
        """Returns a collect-step fn driven by a per-step action table (the
        schedule-policy replay bootstrap, SAC_Demo.ipynb cells 34-40). The
        table's action depends on each env's own step only."""
        del state
        table = torch.as_tensor(np.asarray(action_table), dtype=torch.float32,
                                device=self.device)

        def step_fn(st: TrainState):
            def policy(obs, key):
                t = st.env_states.step_idx.to(torch.int64)
                return table[torch.clamp(t, 0, table.shape[0] - 1)]

            return self.collect_step(st, policy, hooks)

        return step_fn

    # ------------------------------------------------------------------

    def evaluate(
        self, sac: SACState, key: torch.Tensor, n_steps: int, n_envs: int = 4
    ) -> torch.Tensor:
        """Mean undiscounted return of the greedy policy over n_steps."""
        env_states, obs = self.env.reset(rng_lib.split(key.to(self.device), n_envs))
        total = torch.zeros(n_envs, dtype=torch.float32, device=self.device)
        rewards = []
        for _ in range(n_steps):
            actions = self.learner.act_greedy(sac, obs)
            env_states, out = self._step_v(env_states, actions)
            obs = out.observation
            rewards.append(out.reward)
        if rewards:
            total = torch.stack(rewards).sum(dim=0)
        return torch.mean(total)

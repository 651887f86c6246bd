"""Scaling over ranks: envs data-parallel, one process per rank.

Port of sbsim_tpu/distributed/mesh.py. The JAX package shards the env
batch over a 1-D device mesh and runs one program over it (shard_map, with
`lax.pmean` across the "env" axis). Here the mesh axis is the rank of a
torch.distributed process group (distributed/runtime.py): each rank holds
a contiguous block of the env rows, steps them through the kernels on its
own device, inserts into and samples from its own per-env replay
sub-rings (or, under the flat layout, gathers every rank's transitions
into a replicated ring and samples its block of the global batch from it),
and mean-reduces the SAC gradients with the other ranks before
the replicated optimizer update. The learner networks are small MLPs, so
every rank keeps and updates a full copy; the FDM grids and replay bytes
partition. Per-env physics has no cross-env dependency, and every random
draw is made at the global shape from the replicated key, so N ranks give
one process's env fields, iteration counts and replay contents bitwise,
and its learner parameters up to the order of the gradient sums.

Deviation from the JAX package: torch has no GSPMD partitioner, so
`make_distributed_train_step` and `make_distributed_collect_step` run the
same per-rank program as `make_shardmapped_train_step`, and keep the
trainer's solver (the JAX package reroutes its Pallas solvers to XLA on a
multi-device GSPMD mesh, `_gspmd_safe_trainer`; the kernels here run per
rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sbsim_tpu_torch import rng as rng_lib
from sbsim_tpu_torch.agents import networks
from sbsim_tpu_torch.agents import replay as replay_lib
from sbsim_tpu_torch.agents.replay import ShardedReplayState
from sbsim_tpu_torch.agents.train import SACTrainer, ShardHooks, TrainState
from sbsim_tpu_torch.distributed import runtime

ENV_AXIS = "env"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the env axis: this process is rank `rank` of `size`,
    joined by `group` (None: one process, no collectives), and holds its
    rows on `device` (None: on the device the state was made on)."""

    group: Any
    rank: int
    size: int
    device: Optional[torch.device] = None


def make_mesh(devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The mesh of the initialized process group's world (runtime.initialize),
    or a one-rank mesh without a group. `devices`, one per rank in rank
    order (as the JAX package's device list), places each rank's rows."""
    if dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    device = None
    if devices is not None:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a mesh of {size} ranks")
        device = torch.device(devices[rank])
    return Mesh(group=group, rank=rank, size=size, device=device)


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """fn over every tensor of a tree of dataclasses, dicts and tensors;
    other leaves (ints) as they are."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree) if torch.is_tensor(tree) else tree


def _place(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A copy of x on the mesh's device (x's own without one)."""
    return x.to(mesh.device or x.device, copy=True)


def shard_rows(tree, mesh: Mesh):
    """This rank's contiguous block of rows of every tensor of a tree (dim 0
    split evenly over the mesh), copied onto the mesh's device."""

    def take(x):
        if x.shape[0] % mesh.size:
            raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} ranks")
        n = x.shape[0] // mesh.size
        return _place(x[mesh.rank * n:(mesh.rank + 1) * n], mesh)

    return _map(take, tree)


def _replicate(tree, mesh: Mesh):
    """A copy of every tensor of a tree on the mesh's device."""
    return _map(lambda x: _place(x, mesh), tree)


def gather_rows(tree, mesh: Mesh):
    """The inverse of shard_rows: every rank's rows of each tensor, in rank
    order (an all-gather; without a group, the tree itself)."""
    if mesh.group is None:
        return tree
    return _map(lambda x: runtime.all_gather_rows(x, mesh.group), tree)


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Env states, observations and the per-env replay sub-rings take this
    rank's rows; the ring cursors, a flat ring, the learner, the key and
    the env-step count replicate."""
    replay = state.replay
    if isinstance(replay, ShardedReplayState):
        replay = replay.replace(data=shard_rows(replay.data, mesh),
                                insert_index=_place(replay.insert_index, mesh),
                                size=_place(replay.size, mesh))
    else:
        replay = _replicate(replay, mesh)
    return state.replace(
        env_states=shard_rows(state.env_states, mesh),
        last_obs=shard_rows(state.last_obs, mesh),
        replay=replay,
        sac=_replicate(state.sac, mesh),
        rng=_place(state.rng, mesh),
    )


def gather_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole TrainState from a sharded one, on every rank (the
    counterpart of `jax.device_get` of a sharded state): the row blocks
    all-gathered, the replicated parts as they are."""
    replay = state.replay
    if isinstance(replay, ShardedReplayState):
        replay = replay.replace(data=gather_rows(replay.data, mesh))
    return state.replace(env_states=gather_rows(state.env_states, mesh),
                         last_obs=gather_rows(state.last_obs, mesh), replay=replay)


def _pmean(mesh: Mesh) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    if mesh.group is None:
        return None
    return lambda x: runtime.all_reduce_mean([x], mesh.group)[0]


def make_shardmapped_rollout(
    env,
    mesh: Mesh,
    actions_table,
    n_steps: int,
    solver: str = "auto",
):
    """The env rollout on each rank's rows: `step_batched` with the table's
    action for each env's step, n_steps times. The env step has no
    cross-env dependency, so only the mean reward is reduced.

    Returns fn: (this rank's EnvState rows, e.g. shard_rows of the batch)
    -> (its EnvState rows after n_steps, the mean reward over all ranks).
    """
    table = torch.as_tensor(np.asarray(actions_table), dtype=torch.float32, device=env.device)
    reduce = _pmean(mesh)

    def rollout(states):
        rewards = []
        for _ in range(n_steps):
            act = table[torch.clamp(states.step_idx.to(torch.int64), 0, table.shape[0] - 1)]
            states, out = env.step_batched(states, act, solver=solver)
            rewards.append(torch.mean(out.reward))
        mean = torch.mean(torch.stack(rewards))
        return states, mean if reduce is None else reduce(mean)

    return rollout


def _require_per_env(replay) -> None:
    if not isinstance(replay, ShardedReplayState):
        raise ValueError(
            "make_shardmapped_train_step requires the per_env replay layout "
            "(TrainConfig.replay_layout='per_env'): the flat ring cannot "
            "shard with the envs"
        )


def _rows(trainer: SACTrainer, mesh: Mesh) -> Tuple[int, slice]:
    """(envs per rank, this rank's rows of the global env batch)."""
    n_envs = trainer.config.n_envs
    if n_envs % mesh.size != 0:
        raise ValueError(f"n_envs={n_envs} must be a multiple of the mesh size {mesh.size}")
    n_local = n_envs // mesh.size
    return n_local, slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)


def _collect_hooks(trainer: SACTrainer, mesh: Mesh) -> ShardHooks:
    """The reset keys drawn at the global shape, this rank's rows taken; the
    reward mean reduced; under the flat layout every rank's transition rows
    gathered into the replicated ring."""
    n_envs = trainer.config.n_envs
    _, rows = _rows(trainer, mesh)
    gather = None
    if trainer.config.replay_layout == "flat":
        gather = lambda batch: batch.map(lambda x: runtime.all_gather_rows(x, mesh.group))
    return ShardHooks(reset_keys=lambda k: rng_lib.split(k, n_envs)[rows],
                      reduce=_pmean(mesh), gather=gather)


def _train_hooks(trainer: SACTrainer, mesh: Mesh) -> ShardHooks:
    """The rank's hooks of the train step: the action noise, reset keys and
    replay slots drawn at the global shape, this rank's rows taken; the
    metrics and the learner's gradients mean-reduced. The per_env layout
    draws batch_size // n_envs slots of each env's sub-ring (this rank's
    envs); the flat layout batch_size slots of the replicated ring (this
    rank's block of them)."""
    cfg = trainer.config
    _, rows = _rows(trainer, mesh)
    per_env = cfg.replay_layout == "per_env"
    if per_env and cfg.batch_size % cfg.n_envs != 0:
        raise ValueError(
            f"batch_size={cfg.batch_size} must be a multiple of n_envs={cfg.n_envs}"
        )
    if cfg.batch_size % mesh.size != 0:
        raise ValueError(
            f"batch_size={cfg.batch_size} must be a multiple of the mesh size {mesh.size}"
        )
    local_batch = cfg.batch_size // mesh.size
    block = slice(mesh.rank * local_batch, (mesh.rank + 1) * local_batch)
    act_dim = trainer.env.n_actions
    learner = trainer.learner

    @torch.no_grad()
    def policy(sac, obs, k_act):
        mean, log_std = learner.actor_apply(sac.actor_params, obs)
        eps = rng_lib.normal(k_act, (cfg.n_envs, act_dim))[rows]
        actions, _ = networks.sample_action(mean, log_std, eps=eps)
        return actions

    def sample(replay, k_sample):
        high = torch.clamp(replay.size, min=1)
        if per_env:
            slots = rng_lib.randint(k_sample, (cfg.n_envs, cfg.batch_size // cfg.n_envs), 0,
                                    high)
            return replay_lib.sample_sharded_at(replay, slots[rows])
        return replay_lib.sample_at(replay, rng_lib.randint(k_sample, (cfg.batch_size,), 0,
                                                            high)[block])

    return dataclasses.replace(
        _collect_hooks(trainer, mesh),
        policy=policy,
        sample=sample,
        update_kwargs=dict(group=mesh.group, noise_block=(block.start, cfg.batch_size)),
    )


StepFn = Callable[[TrainState], Tuple[TrainState, Dict[str, torch.Tensor]]]


def make_shardmapped_train_step(
    trainer: SACTrainer,
    mesh: Mesh,
    replay_template,
    solver: str = "auto",
) -> StepFn:
    """The multi-rank training step: each rank runs `SACTrainer.train_step`
    itself on its rows (the env step through the kernels of `solver`,
    inserts into and samples from its own sub-rings), with hooks that draw
    every random number at the global shape from the replicated key and
    mean-reduce the gradients and metrics. N ranks thus apply the update one
    process computes on the whole batch, up to the order of the sums.

    `replay_template` is the TrainState (or its replay) whose ring layout
    the step takes: the per_env layout, as the JAX package's
    `_train_state_specs` requires. n_envs must be a multiple of the mesh
    size and batch_size a multiple of n_envs. Returns fn: (this rank's
    TrainState, as shard_train_state gives it) -> (TrainState, metrics);
    the metrics are the same on every rank.
    """
    if hasattr(replay_template, "replay"):
        replay_template = replay_template.replay
    hooks = _train_hooks(trainer, mesh)
    _require_per_env(replay_template)
    trainer = trainer.with_solver(solver)

    def step(state: TrainState):
        _require_per_env(state.replay)
        return trainer.train_step(state, hooks)

    return step


def make_distributed_train_step(trainer: SACTrainer, mesh: Mesh) -> StepFn:
    """The trainer's full step on the mesh, either replay layout. torch has
    no GSPMD partitioner, so this is the per-rank program of
    make_shardmapped_train_step, with the trainer's own solver: the kernels
    run per rank, and nothing is rerouted (the JAX package's
    `_gspmd_safe_trainer` has no counterpart). The flat ring is replicated:
    each collect step gathers every rank's transitions into it, and each
    rank samples its block of the global batch. A mesh without a group runs
    the plain `train_step`."""
    if mesh.group is None:
        return trainer.train_step
    hooks = _train_hooks(trainer, mesh)
    return lambda state: trainer.train_step(state, hooks)


def make_distributed_collect_step(trainer: SACTrainer, mesh: Mesh, action_fn) -> StepFn:
    """One collect step on each rank's rows: the reset keys drawn at the
    global shape, the reward mean reduced, and under the flat layout every
    rank's transitions gathered into the replicated ring. A mesh without a
    group runs the plain collect step.

    `action_fn` is the collect step's policy, (obs, key) -> actions, or a
    per-step action table (numpy, as `seed_with_actions` takes: each env's
    action from its own step). The policy sees this rank's rows of the
    observations, so it must be per-row deterministic, as the table is, or
    draw at the global shape and take the rank's rows, as the train step's
    policy hook does; the package passes nothing else.
    """
    hooks = _collect_hooks(trainer, mesh) if mesh.group is not None else ShardHooks()
    if not callable(action_fn):
        return trainer.seed_with_actions(None, action_fn, hooks)
    return lambda state: trainer.collect_step(state, action_fn, hooks)

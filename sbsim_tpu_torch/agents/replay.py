"""On-device uniform replay buffer.

Port of sbsim_tpu/agents/replay.py: the reference's Reverb server
(SAC_Demo.ipynb cell 28: uniform sampler, FIFO remover, capacity 50k)
becomes a fixed-size ring of tensors in device memory, either one flat
ring or one sub-ring per env (the trainer's default).

Unlike the JAX package's pure functions, inserts write the ring's tensors
in place (the ring is the largest state the trainer holds, and a copy per
env step would move all of it); the returned state shares them. The cursor
and fill level are int32 scalars on the ring's device, so neither an insert
nor a sample waits for the host.
"""

from __future__ import annotations

import dataclasses

import torch

from sbsim_tpu_torch import rng as rng_lib


@dataclasses.dataclass(frozen=True)
class Transition:
    obs: torch.Tensor  # (..., obs_dim)
    action: torch.Tensor  # (..., action_dim)
    reward: torch.Tensor  # (...,)
    discount: torch.Tensor  # (...,) 0 at terminal, else the discount factor
    next_obs: torch.Tensor  # (..., obs_dim)

    def map(self, fn) -> "Transition":
        return Transition(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


def _zeros(lead, obs_dim: int, action_dim: int, device) -> Transition:
    z = lambda *shape: torch.zeros(tuple(lead) + shape, dtype=torch.float32, device=device)
    return Transition(obs=z(obs_dim), action=z(action_dim), reward=z(), discount=z(),
                      next_obs=z(obs_dim))


def _i32(value: int, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class ReplayState:
    data: Transition  # leaves shaped (capacity, ...)
    insert_index: torch.Tensor  # i32 scalar
    size: torch.Tensor  # i32 scalar
    capacity: int

    def replace(self, **changes) -> "ReplayState":
        return dataclasses.replace(self, **changes)


def init_replay(capacity: int, obs_dim: int, action_dim: int, device=None) -> ReplayState:
    return ReplayState(
        data=_zeros((capacity,), obs_dim, action_dim, device),
        insert_index=_i32(0, device),
        size=_i32(0, device),
        capacity=capacity,
    )


def add_batch(state: ReplayState, batch: Transition) -> ReplayState:
    """Inserts a batch of transitions (FIFO ring semantics)."""
    n = batch.reward.shape[0]
    idx = (state.insert_index.to(torch.int64)
           + torch.arange(n, device=state.insert_index.device)) % state.capacity
    for f in dataclasses.fields(Transition):
        getattr(state.data, f.name)[idx] = getattr(batch, f.name)
    return state.replace(
        insert_index=((state.insert_index + n) % state.capacity).to(torch.int32),
        size=torch.clamp(state.size + n, max=state.capacity).to(torch.int32),
    )


def sample(state: ReplayState, key: torch.Tensor, batch_size: int) -> Transition:
    """Uniform sampling over the filled prefix."""
    return sample_at(state, rng_lib.randint(key, (batch_size,), 0,
                                            torch.clamp(state.size, min=1)))


def sample_at(state: ReplayState, idx: torch.Tensor) -> Transition:
    """Gathers the given ring slots."""
    idx = idx.to(torch.int64)
    return state.data.map(lambda buf: buf[idx])


# ---------------------------------------------------------------------------
# Per-env layout: one sub-ring per env, env-local insert AND sample
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedReplayState:
    """Per-env sub-rings: leaves shaped (n_envs, per_env_capacity, ...).
    Envs step in lockstep, so one scalar cursor serves all sub-rings."""

    data: Transition  # leaves shaped (n_envs, per_env_capacity, ...)
    insert_index: torch.Tensor  # i32 scalar (lockstep cursor)
    size: torch.Tensor  # i32 scalar (filled slots per sub-ring)
    per_env_capacity: int

    def replace(self, **changes) -> "ShardedReplayState":
        return dataclasses.replace(self, **changes)


def init_sharded_replay(
    n_envs: int, per_env_capacity: int, obs_dim: int, action_dim: int, device=None
) -> ShardedReplayState:
    return ShardedReplayState(
        data=_zeros((n_envs, per_env_capacity), obs_dim, action_dim, device),
        insert_index=_i32(0, device),
        size=_i32(0, device),
        per_env_capacity=per_env_capacity,
    )


def add_batch_sharded(state: ShardedReplayState, batch: Transition) -> ShardedReplayState:
    """Writes each env's transition (batch leaves (n_envs, ...)) into column
    `insert_index` of its own sub-ring (FIFO)."""
    idx = state.insert_index.to(torch.int64).view(1)
    for f in dataclasses.fields(Transition):
        getattr(state.data, f.name).index_copy_(1, idx, getattr(batch, f.name).unsqueeze(1))
    cap = state.per_env_capacity
    return state.replace(
        insert_index=((state.insert_index + 1) % cap).to(torch.int32),
        size=torch.clamp(state.size + 1, max=cap).to(torch.int32),
    )


def sample_sharded(state: ShardedReplayState, key: torch.Tensor, batch_size: int) -> Transition:
    """Stratified-uniform sample: batch_size // n_envs slots from each env's
    sub-ring, flattened env-major to (batch_size, ...). n_envs must divide
    batch_size."""
    n_envs = state.data.reward.shape[0]
    if batch_size % n_envs != 0:
        raise ValueError(
            f"batch_size={batch_size} must be a multiple of "
            f"n_envs={n_envs} for the stratified per-env sample"
        )
    k = batch_size // n_envs
    slots = rng_lib.randint(key, (n_envs, k), 0, torch.clamp(state.size, min=1))
    return sample_sharded_at(state, slots)


def sample_sharded_at(state: ShardedReplayState, slots: torch.Tensor) -> Transition:
    """Gathers the given (n_envs, k) ring slots, flattened env-major to
    (n_envs * k, ...)."""
    n_envs, k = slots.shape
    slots = slots.to(torch.int64)

    def take(buf):
        idx = slots.reshape(slots.shape + (1,) * (buf.dim() - 2))
        out = torch.gather(buf, 1, idx.expand((n_envs, k) + buf.shape[2:]))
        return out.reshape((n_envs * k,) + buf.shape[2:])

    return state.data.map(take)

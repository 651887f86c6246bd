"""threefry2x32 counter-based PRNG, bitwise equal to `jax.random`.

Reproduces jax 0.9.0 with `jax_threefry_partitionable=True` (its default):
  * `PRNGKey(seed)` -> (0, seed & 0xFFFFFFFF) for 32-bit seeds;
  * `split(key, n)`: subkey i = threefry2x32(key, (0, i));
  * `bits(key, shape)`: element i = x0 ^ x1 of threefry2x32(key, (0, i)),
    i the row-major flat index;
  * `uniform(key, shape)`: f32 in [0, 1) from the top 23 bits.

Keys are int64 tensors holding uint32 values, with a trailing axis of 2 and
any leading batch shape; every function vectorises over the batch. PyTorch
on the CPU has no uint32 shifts, so all arithmetic runs in int64 masked to
32 bits (products wrap in int64 but keep exact low 32 bits).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block cipher (Salmon et al. 2011), as
    jax.random's threefry2x32 primitive computes it. All inputs are int64
    tensors of uint32 values that broadcast together."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & MASK32)
    v0 = (x0 + ks[0]) & MASK32
    v1 = (x1 + ks[1]) & MASK32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            v0 = (v0 + v1) & MASK32
            v1 = _rotl(v1, r) ^ v0
        v0 = (v0 + ks[(block + 1) % 3]) & MASK32
        v1 = (v1 + ks[(block + 2) % 3] + block + 1) & MASK32
    return v0, v1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey for a seed in the int32 range (x64 disabled)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _counters(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) keys -> (..., num, 2) subkeys."""
    k0 = key[..., 0, None]
    k1 = key[..., 1, None]
    lo = _counters(num, key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(..., 2) keys -> (..., *shape) uint32 values as int64."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 2**32:
        raise ValueError("bits() supports fewer than 2**32 elements")
    k0 = key[..., 0, None]
    k1 = key[..., 1, None]
    lo = _counters(n, key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(..., 2) keys -> (..., *shape) float32 uniforms in [0, 1)."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)

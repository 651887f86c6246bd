# Frozen copy of sbsim_tpu_torch/rng.py at commit c9d3945, part of the benchmark's plain reference.
"""threefry2x32 counter-based PRNG, bitwise equal to `jax.random`.

Reproduces jax 0.9.0 with `jax_threefry_partitionable=True` (its default):
  * `PRNGKey(seed)` -> (0, seed & 0xFFFFFFFF) for 32-bit seeds;
  * `split(key, n)`: subkey i = threefry2x32(key, (0, i));
  * `bits(key, shape)`: element i = x0 ^ x1 of threefry2x32(key, (0, i)),
    i the row-major flat index;
  * `uniform(key, shape, minval, maxval)`: f32 from the top 23 bits;
  * `normal(key, shape)` and `randint(key, shape, minval, maxval)`;
  * `fold_in(key, data)` = threefry2x32(key, (0, data)).

Keys are int64 tensors holding uint32 values, with a trailing axis of 2 and
any leading batch shape; every function vectorises over the batch. PyTorch
on the CPU has no uint32 shifts, so all arithmetic runs in int64 masked to
32 bits (products wrap in int64 but keep exact low 32 bits).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from portbench.oracle.sac.constants import constant

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


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in: (..., 2) keys -> (..., 2) keys mixed with the
    uint32 value of `data` (the key's subkey number `data` under split)."""
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(key[..., 0]),
                          torch.full_like(key[..., 0], int(data) & MASK32))
    return torch.stack([b0, b1], dim=-1)


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


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as XLA's fused multiply-add gives it.

    a * b is exact in float64; the float64 sum is rounded to odd (TwoSum
    error, then the last bit forced to 1 where the sum was inexact), so the
    final rounding to float32 is the correctly rounded fused result."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def uniform(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """(..., 2) keys -> (..., *shape) float32 uniforms in [minval, maxval).

    jax.random.uniform: floats in [1, 2) from the top 23 bits, minus one,
    then max(minval, f * (maxval - minval) + minval) with the multiply-add
    fused (as XLA compiles it)."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = constant(minval, torch.float32, key.device)
    hi = constant(maxval, torch.float32, key.device)
    return torch.maximum(lo, _fma_f32(floats, hi - lo, lo))


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function", 2010):
# polynomial coefficients for w < 5 and w >= 5, highest order first.
_ERFINV_SMALL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_LARGE = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA computes it (not torch.erfinv,
    whose float32 results differ by tens of ulps)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coeff = lambda i: torch.where(
        small,
        constant(_ERFINV_SMALL[i], torch.float32, x.device),
        constant(_ERFINV_LARGE[i], torch.float32, x.device),
    )
    p = coeff(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = coeff(i) + p * w
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(..., 2) keys -> (..., *shape) float32 standard normals:
    sqrt(2) * erfinv(u), u uniform on (nextafter(-1, 0), 1), as
    jax.random.normal (within a few float32 ulps: XLA fuses the erfinv
    polynomial's multiply-adds)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return constant(float(np.sqrt(2.0)), torch.float32, key.device) * erfinv(u)


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval,
    maxval,
) -> torch.Tensor:
    """(..., 2) keys -> (..., *shape) int32 integers in [minval, maxval),
    as jax.random.randint (jax._src.random._randint), vmapped over the
    leading key axes: 64 random bits per value from the two halves of
    split(key), reduced modulo the span with uint32 wraparound (int64
    masked to 32 bits). `minval` and `maxval` are ints or int tensors that
    broadcast to `shape`."""
    dev = key.device
    i32 = torch.iinfo(torch.int32)
    as_i64 = lambda v: (v.to(dev) if torch.is_tensor(v) else constant(v, torch.int64, dev))
    lo = as_i64(minval).to(torch.int64).clamp(i32.min, i32.max)
    hi = as_i64(maxval).to(torch.int64).clamp(i32.min, i32.max)
    sub = split(key)
    higher, lower = bits(sub[..., 0, :], shape), bits(sub[..., 1, :], shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & MASK32)
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (((higher % span) * multiplier) & MASK32) + (lower % span)
    offset = (offset & MASK32) % span
    return (lo + offset).to(torch.int32)

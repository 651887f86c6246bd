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
any leading batch shape; every function vectorises over the batch.

Each draw has two implementations, chosen by where the keys lie:
  * keys on a CUDA device launch the hand-written kernel of
    csrc/rng_kernels.cu, one launch per draw (the cipher in uint32
    registers, the draw's epilogue in the same thread), or raise;
  * keys on the CPU run the draw's plain version (`split_plain`,
    `fold_in_plain`, `bits_plain`, `uniform_plain`, `normal_plain`,
    `randint_plain`): PyTorch on the CPU has no uint32 shifts, so their
    arithmetic runs in int64 masked to 32 bits (products wrap in int64 but
    keep exact low 32 bits), some 180-580 elementwise ops per draw.
The kernel equals the plain versions bitwise. Its library is compiled with
nvcc at first use through the port's build cache (`buildcache`) and loaded
with ctypes; `launch_counts` counts its launches per draw kind.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sbsim_tpu_torch import buildcache
from sbsim_tpu_torch.graphs import constant
from sbsim_tpu_torch.utils import profiling

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "rng_kernels.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# The kernel's epilogue per draw kind (csrc/rng_kernels.cu, Kind).
_EPILOGUES = {"split": 0, "fold_in": 0, "bits": 1, "uniform": 2, "normal": 3, "randint": 4}
# Launches per draw kind; `_launch` adds one where it launches. The tracing
# registry's set-up counters `rng.launches.<kind>`, counted whether tracing
# is on or off, as device launches.
launch_counts = profiling.family("rng.launches", tuple(_EPILOGUES), launches=True)
_lib = None


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


def _shape(shape: Sequence[int]) -> Tuple[int, ...]:
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) >= 2**32:
        raise ValueError("a draw takes fewer than 2**32 values per key")
    return shape


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in: (..., 2) keys -> (..., 2) keys mixed with the
    uint32 value of `data` (the key's subkey number `data` under split)."""
    lib = _kernel(key)
    if lib is not None:
        return _launch("fold_in", key, (2,), lib, counter0=int(data) & MASK32)
    return fold_in_plain(key, data)


def fold_in_plain(key: torch.Tensor, data: int) -> torch.Tensor:
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(key[..., 0]),
                          torch.full_like(key[..., 0], int(data) & MASK32))
    return torch.stack([b0, b1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) keys -> (..., num, 2) subkeys."""
    lib = _kernel(key)
    if lib is not None:
        return _launch("split", key, _shape((num, 2)), lib)
    return split_plain(key, num)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    k0 = key[..., 0, None]
    k1 = key[..., 1, None]
    lo = _counters(num, key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(..., 2) keys -> (..., *shape) uint32 values as int64."""
    lib = _kernel(key)
    if lib is not None:
        return _launch("bits", key, _shape(shape), lib)
    return bits_plain(key, shape)


def bits_plain(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    shape = _shape(shape)
    k0 = key[..., 0, None]
    k1 = key[..., 1, None]
    lo = _counters(math.prod(shape), key.device)
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
    lib = _kernel(key)
    if lib is not None:
        return _launch("uniform", key, _shape(shape), lib, lo=minval, hi=maxval)
    return uniform_plain(key, shape, minval, maxval)


def uniform_plain(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
                  maxval: float = 1.0) -> torch.Tensor:
    return uniform_from_bits(bits_plain(key, shape), minval, maxval)


def uniform_from_bits(words: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """The uniforms that `uniform_plain` makes of threefry words (int64
    holding uint32 values)."""
    mant = (words >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = constant(minval, torch.float32, words.device)
    hi = constant(maxval, torch.float32, words.device)
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


# normal's uniforms lie on (nextafter(-1, 0), 1).
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(..., 2) keys -> (..., *shape) float32 standard normals:
    sqrt(2) * erfinv(u), u uniform on (nextafter(-1, 0), 1), as
    jax.random.normal (within a few float32 ulps: XLA fuses the erfinv
    polynomial's multiply-adds)."""
    lib = _kernel(key)
    if lib is not None:
        return _launch("normal", key, _shape(shape), lib, lo=NORMAL_LO, hi=1.0)
    return normal_plain(key, shape)


def normal_plain(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return normal_from_bits(bits_plain(key, shape))


def normal_from_bits(words: torch.Tensor) -> torch.Tensor:
    """The normals that `normal_plain` makes of threefry words."""
    u = uniform_from_bits(words, NORMAL_LO, 1.0)
    return constant(float(np.sqrt(2.0)), torch.float32, words.device) * erfinv(u)


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval,
    maxval,
) -> torch.Tensor:
    """(..., 2) keys -> (..., *shape) int32 integers in [minval, maxval),
    as jax.random.randint (jax._src.random._randint), vmapped over the
    leading key axes: 64 random bits per value from the two halves of
    split(key), reduced modulo the span with uint32 wraparound. `minval`
    and `maxval` are ints or int tensors that broadcast to `shape` (on the
    card: of one value, or of the output's shape)."""
    lib = _kernel(key)
    if lib is not None:
        return _launch("randint", key, _shape(shape), lib, bounds=(minval, maxval))
    return randint_plain(key, shape, minval, maxval)


def randint_plain(key: torch.Tensor, shape: Sequence[int], minval, maxval) -> torch.Tensor:
    """randint in int64 masked to 32 bits."""
    dev = key.device
    i32 = torch.iinfo(torch.int32)
    as_i64 = lambda v: (v.to(dev) if torch.is_tensor(v) else constant(v, torch.int64, dev))
    lo = as_i64(minval).to(torch.int64).clamp(i32.min, i32.max)
    hi = as_i64(maxval).to(torch.int64).clamp(i32.min, i32.max)
    sub = split_plain(key)
    higher, lower = bits_plain(sub[..., 0, :], shape), bits_plain(sub[..., 1, :], shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & MASK32)
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (((higher % span) * multiplier) & MASK32) + (lower % span)
    offset = (offset & MASK32) % span
    return (lo + offset).to(torch.int32)


# ---------------------------------------------------------------------------
# The kernel (csrc/rng_kernels.cu)
# ---------------------------------------------------------------------------


def build() -> str:
    """Compiles csrc/rng_kernels.cu unless its library is built already;
    returns the library's path. Raises if nvcc fails."""
    return buildcache.build(SOURCE, "rng_kernels", "nvcc", NVCC_FLAGS,
                            executable=buildcache.nvcc)[0]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the ctypes signature of the library's C function."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    bound = [ptr, i32, i64, i64]  # ptr, bytes, step, value
    lib.rng_draw_launch.argtypes = ([i32, ptr, i64, i64, i64, i64, ctypes.c_uint32, ptr,
                                     f32, f32] + bound + bound + [ptr])
    lib.rng_draw_launch.restype = i32
    return lib


def _kernel(key: torch.Tensor) -> Optional[ctypes.CDLL]:
    """The library that a draw on `key` launches: the kernel's for keys on a
    CUDA device; None for keys on the CPU, which run the plain versions."""
    global _lib
    if not key.is_cuda:
        return None
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


def reset_launch_counts() -> None:
    for kind in launch_counts:
        launch_counts[kind] = 0


def _bound(value, shape: Tuple[int, ...], device) -> list:
    """A randint bound as the kernel takes it: (pointer, bytes, step, value)."""
    if not torch.is_tensor(value):
        i32 = torch.iinfo(torch.int32)
        return [None, 8, 0, min(max(int(value), i32.min), i32.max)]
    if value.dtype not in (torch.int32, torch.int64) or value.device != device:
        raise ValueError("randint bounds on the card must be int32 or int64 tensors on the "
                         "keys' device, or ints")
    if value.numel() == 1 and value.dim() <= len(shape):  # broadcasts to `shape`
        step = 0
    elif value.shape == shape and value.is_contiguous():
        step = 1
    else:
        raise ValueError(f"a randint bound of shape {tuple(value.shape)} for an output of "
                         f"shape {shape}: the kernel takes one value or one per output")
    return [value.data_ptr(), value.element_size(), step, 0]


def _launch(kind: str, key: torch.Tensor, shape: Tuple[int, ...], lib: ctypes.CDLL,
            counter0: int = 0, lo: float = 0.0, hi: float = 1.0,
            bounds=(0, 1)) -> torch.Tensor:
    """One launch of the draw kernel in `lib`: the (..., *shape) output of
    draw `kind` for (..., 2) keys, allocated here on the keys' device and,
    on a CUDA device, computed on its current stream with no
    synchronisation. A host C++ build of the kernel source bound with
    `bind` runs the same launch on CPU keys (tests/test_torch_rng_host.py).
    Raises on keys or bounds the kernel does not take."""
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(f"keys must be int64 (..., 2); got {key.dtype} {tuple(key.shape)}")
    n_keys = math.prod(key.shape[:-1])
    try:
        flat = key.view(n_keys, 2)
    except RuntimeError as err:
        raise ValueError(f"the keys' batch axes (strides {key.stride()}) do not merge "
                         "into one") from err
    dtype = {"uniform": torch.float32, "normal": torch.float32,
             "randint": torch.int32}.get(kind, torch.int64)
    out = torch.empty(key.shape[:-1] + shape, dtype=dtype, device=key.device)
    per_key = math.prod(shape[:-1] if kind in ("split", "fold_in") else shape)
    if out.numel() == 0:
        return out
    full = key.shape[:-1] + shape
    lo_bound, hi_bound = ((_bound(b, full, key.device) for b in bounds)
                          if kind == "randint" else ([None, 8, 0, 0],) * 2)
    on_card = key.is_cuda
    with torch.cuda.device(key.device) if on_card else contextlib.nullcontext():
        stream = torch.cuda.current_stream().cuda_stream if on_card else None
        err = lib.rng_draw_launch(_EPILOGUES[kind], flat.data_ptr(), flat.stride(0),
                                  flat.stride(1), n_keys, per_key, counter0, out.data_ptr(),
                                  lo, hi, *lo_bound, *hi_bound, stream)
    if err:
        raise RuntimeError(f"rng {kind} launch failed: CUDA error {err}")
    launch_counts[kind] += 1
    return out

"""Hand-written CUDA kernels for the FDM convergence loop (Hopper, sm_90a).

Counterpart of sbsim_tpu/physics/fdm_pallas.py. Four kernels, launches of
two device bodies in csrc/fdm_kernels.cu:

  fdm_cheby  (K1) replaces _fdm_cheby_kernel_interleaved (fdm_pallas.py:630)
             and its one-env form _fdm_cheby_kernel (:279): the Chebyshev
             semi-iteration of the Jacobi map with the residual sampled
             every `check_every` sub-iterations, J(x) emitted for the final
             iterate, then the swap-convection rounds. It is the one-env
             launch of the Chebyshev body that K4 launches with E envs.
  fdm_jacobi (K2) replaces _fdm_kernel (:207): Jacobi while
             it < limit and max|dx| > threshold, then the same convection.
             It is the one-env launch of the Jacobi body under the solo
             stopping rule.
  fdm_jacobi_block (K3) and fdm_cheby_block (K4) replace the stack layout's
             _fdm_kernel_block (:416) and _fdm_cheby_kernel_block (:505):
             E envs per thread block sharing one loop, per-env freezing
             (Chebyshev sampled only at chunk ends), one omega schedule per
             block.

`route` decides, once per env and solver, which of the four wrappers a
solve launches and how: the envs per thread block, whether the plan spans
blocks, whether the swap convection runs in the kernel and whether the
statistics come from its epilogue. Its `Route` holds the solve's device
planes and runs it (`Route.solve`); `fdm_step_cuda` is a route made for
one call.

On a plan above one thread block's shared memory (run_geometry refuses one
env per block: near 24,800 cells) each wrapper launches, in place of its
kernel, a cluster body with the same semantics, one thread-block cluster
per env with the iterate pair in global memory: fdm_cheby_cluster for K1
and K4, fdm_jacobi_cluster for K2 and K3 (each with its stopping rule).
The plan's size alone picks it (spans_blocks); a plan whose cells overflow
a 32-bit index, or whose launch the card cannot hold, is refused. Its swap
rounds run in groups planned from the offsets and the grid (swap_plan):
each group in one pass through shared memory over halo tiles of a CTA's
band, a round too wide for any tile as a pass in global memory. Likewise
each Chebyshev chunk of `check_every` >= 2 sub-iterations after x1 = J(x0)
runs as one pass through shared memory over halo tiles of `check_every`
cells (chunk_plan), where such a tile fits; else the chunk streams.

Every block kernel keeps its envs' iterate and partner plane in shared memory for
the whole solve, and stages const and denom there where they fit, so a
step reads temp/const/denom once and writes the field once (the bound is
in the note at the top of the source). Both bodies share one launch
geometry (run_geometry, run_neighbours), mirrored here for the tests. Each
env's result does not depend on the other envs of the batch or of its
block (K3's equals K2's unless a residual is NaN: see
fdm_jacobi_block_plain).

The swap rounds take their decision words from the mix32 hash of the raw
per-env key, made in the kernel, or from a precomputed (B, H, W) word plane
(the threefry words), as _kernel_conv_word (fdm_pallas.py:192) does.

With a zone-statistics layout every block kernel also emits the zone and grid
sums of the final field from shared memory (the epilogue that replaces
_kernel_grid_stats, fdm_pallas.py:137, and _block_write_stats, :404), in
the fold order of physics/gridstats.py, so the sums equal the fold's
bitwise; on the cluster path the wrapper folds the output with that fold.

Beside each kernel is its plain PyTorch version (fdm_cheby_plain,
fdm_jacobi_plain, fdm_cheby_block_plain, fdm_jacobi_block_plain) on the
same inputs, with the same float32 operation sequence; built with
-fmad=false and IEEE division the kernels equal them bitwise.
`fdm_step_cuda` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

The library is compiled with nvcc at first use into `_build/` beside this
package (a content hash of the source and flags names the .so) and loaded
with ctypes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import weakref
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from sbsim_tpu_torch import buildcache
from sbsim_tpu_torch.physics import convection as convection_lib
from sbsim_tpu_torch.physics import fdm
from sbsim_tpu_torch.physics.fdm import StencilCoefficients
from sbsim_tpu_torch.physics.gridstats import ZoneStatLayout, ZoneStats
from sbsim_tpu_torch.utils import profiling

# Zone sums fill one 128-lane row of the TPU kernels' stats tile; the port
# keeps their limit (fdm_pallas.py:944-949).
MAX_STAT_ZONES = 128
SMEM_PER_BLOCK = 232448
# The cluster bodies (kClusterMax, kClusterThreads): CTAs per env at most,
# the portable cluster size, and threads per CTA at most.
CLUSTER_MAX = 8
CLUSTER_THREADS = 1024
# Cells a plane may hold: the kernels index a cell in 32 bits.
MAX_CELLS = 2**31 - 1
# The memory of the card the host build of the kernels rehearses (an H100
# 80GB), against which it refuses a launch; on the card, the card's own.
CARD_BYTES = 80 * 10**9
# Both bodies (csrc/fdm_kernels.cu): cells a thread owns per run down a
# column, envs per block with their const/denom staged, and the shared
# memory the launcher leaves for a body's static scratch (kRun, kMaxEnvs,
# kStaticSmem).
RUN = 4
MAX_ENVS = 4
STATIC_SMEM = 2048
# The shared memory a block may use for the planes of its envs.
SMEM_BUDGET = SMEM_PER_BLOCK - STATIC_SMEM
MASK32 = convection_lib.MASK32

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fdm_kernels.cu")
BUILD_DIR = buildcache.BUILD_DIR
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches per kernel; a wrapper adds one where it launches its kernel. The
# tracing registry's set-up counters `fdm.launches.<kernel>`, counted whether
# tracing is on or off, as device launches.
launch_counts = profiling.family("fdm.launches", ("fdm_cheby", "fdm_jacobi", "fdm_cheby_block",
                                                  "fdm_jacobi_block", "fdm_cheby_cluster",
                                                  "fdm_jacobi_cluster"), launches=True)
# `fdm.swap_groups`: the groups of the swap plans of the cluster launches,
# summed over them as the launches are, replays of a captured program
# included (so a plan's groups per solve is it over the launches of
# `fdm.launches.fdm_*_cluster`).
swap_counts = profiling.family("fdm", ("swap_groups",), launches=True)
# The shared memory a cluster CTA gives a tile of swap rounds or of a chunk
# pass (kTileBytes: 256 KB of L1 and shared memory less 96 KB of L1, the
# CTA's reserved 1 KB and its 48 scalars), and a chunk tile's bytes per
# region cell and per region row or column (kChunkCellBytes,
# kChunkLineBytes).
TILE_BYTES = (256 - 96 - 1) * 1024 - 4 * (32 + 2 * CLUSTER_MAX)
CHUNK_CELL_BYTES, CHUNK_LINE_BYTES = 17, 5
# nvcc's output of the build in this process (ptxas register/smem use).
build_log = ""
_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def library_path() -> str:
    return buildcache.library_path(SOURCE, "fdm_kernels", "nvcc", NVCC_FLAGS, BUILD_DIR)


def build() -> str:
    """Compiles csrc/fdm_kernels.cu unless its library is built already
    (through the port's build cache); returns the library's path and keeps
    nvcc's output in build_log. Raises if nvcc fails."""
    global build_log
    path, log = buildcache.build(SOURCE, "fdm_kernels", "nvcc", NVCC_FLAGS, BUILD_DIR,
                                 executable=buildcache.nvcc)
    if log is not None:
        build_log = log
    return path


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the ctypes signatures of the library's C functions."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # temp, const, denom, tinf, coef, ext, lead, foll, keys, words, out,
    # iters, converged; B, H, W, edge_fill
    planes = [ptr] * 13 + [i32] * 4
    conv = [ptr, i32, i32, i32]  # offsets, n_rounds, lane_bits, q
    # masks, row0, col0, zone_sums, grid_sums, n_zones, hc, wc, stream
    stats = [ptr] * 5 + [i32] * 3 + [ptr]
    jacobi = [f32, i32]  # threshold, limit
    cheby = [f32, i32, f32, f32, i32]  # ... rho2, omega0, check_every
    for name, args in (
        ("fdm_jacobi_launch", planes + jacobi),
        ("fdm_cheby_launch", planes + cheby),
        ("fdm_jacobi_block_launch", planes + [i32] + jacobi),  # + block_envs
        ("fdm_cheby_block_launch", planes + [i32] + cheby),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args + conv + stats
        fn.restype = i32
    for body in ("cheby", "jacobi"):
        getattr(lib, f"fdm_{body}_max_envs").argtypes = [i32, i32]
        getattr(lib, f"fdm_{body}_max_envs").restype = i32
        getattr(lib, f"fdm_{body}_geometry").argtypes = [i32, i32, i32, ptr]
        getattr(lib, f"fdm_{body}_geometry").restype = i32
    lib.fdm_blocks_per_sm.argtypes = [i32] * 4
    lib.fdm_blocks_per_sm.restype = i32
    # scratch, spare, extra, barriers, tiled, offsets, n_rounds, lane_bits, q,
    # stream
    cluster = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.fdm_cheby_cluster_launch.argtypes = planes + cheby + cluster
    lib.fdm_jacobi_cluster_launch.argtypes = planes + [i32] + jacobi + cluster  # + rule
    lib.fdm_cheby_cluster_launch.restype = lib.fdm_jacobi_cluster_launch.restype = i32
    lib.fdm_cluster_geometry.argtypes = [i32, i32, ptr]
    lib.fdm_cluster_geometry.restype = i32
    lib.fdm_cluster_swap_plan.argtypes = [i32, i32, ptr, i32, ptr]
    lib.fdm_cluster_swap_plan.restype = i32
    lib.fdm_cluster_chunk_plan.argtypes = [i32, i32, i32, ptr]
    lib.fdm_cluster_chunk_plan.restype = i32
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


@dataclasses.dataclass(frozen=True)
class KernelInputs:
    """The kernels' inputs: per-env (B, H, W) planes, shared (H, W) planes.

    With `edge_fill` False (a ring-exterior plan) the exterior pin is folded
    into the coefficients as the JAX package does (a* = 0, denom = 1,
    const = t_inf at exterior cells), and the stencil reads wrap around.
    """

    temp: torch.Tensor  # f32 (B, H, W)
    const: torch.Tensor  # f32 (B, H, W)
    denom: torch.Tensor  # f32 (B, H, W)
    tinf: torch.Tensor  # f32 (B,)
    a_r: torch.Tensor  # f32 (H, W)
    a_l: torch.Tensor
    a_b: torch.Tensor
    a_t: torch.Tensor
    ext: torch.Tensor  # f32 (H, W), 1.0 at exterior cells
    edge_fill: bool
    # f32 (H, W, 4): (a_r, a_l, a_b, a_t) per cell, the one 16-byte read of
    # a cell's stencil in both kernel bodies (the plain versions read a_*).
    coef: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ConvInputs:
    """The fused swap convection: static round offsets, packed
    lead/follower masks (int32 planes holding the uint32 bits), and the
    decision words: either the mix32 parameters with the raw per-env step
    keys (B, 2) int64, made into words in the kernel, or a precomputed
    (B, H, W) word plane (int32 holding the uint32 bits; the threefry
    words), which the kernel reads."""

    offsets: Tuple[Tuple[int, int], ...]
    lead: torch.Tensor  # i32 (H, W)
    foll: torch.Tensor  # i32 (H, W)
    word_params: Optional[Tuple[int, int, int, int]] = None
    keys: Optional[torch.Tensor] = None  # i64 (B, 2) uint32 values
    words: Optional[torch.Tensor] = None  # i32 (B, H, W)


class GridSums(NamedTuple):
    """Statistics of the final field: the sums whose means the env keeps."""

    zone_sums: torch.Tensor  # f32 (B, Z)
    grid_sums: torch.Tensor  # f32 (B,)


def fold_stats(x: torch.Tensor, stats: Optional[ZoneStats]) -> Optional[GridSums]:
    """The plain statistics: the gridstats fold of the final field."""
    if stats is None:
        return None
    return GridSums(stats.zone_sums(x), stats.grid_sum(x))


def packed_plane(words, device) -> torch.Tensor:
    """Packed uint32 words (numpy uint32, or an integer tensor of their
    values) as the contiguous int32 tensor with the same bits that the
    kernels read."""
    if not torch.is_tensor(words):
        bits = np.ascontiguousarray(np.asarray(words).astype(np.uint32).view(np.int32))
        return torch.as_tensor(bits, device=device)
    words = words.to(device)
    if words.dtype != torch.int32:
        words = words.to(torch.int64) & MASK32
        words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return words.contiguous()


@dataclasses.dataclass(frozen=True)
class RunGeometry:
    """Launch geometry of both bodies (K1-K4), mirroring run_geometry in
    csrc/fdm_kernels.cu: each column is cut into runs of RUN vertically
    consecutive cells, runs are numbered row block by row block, column by
    column, thread t owns runs t, t + threads, ... (`slots` at most), and
    const/denom are staged in shared memory when they fit."""

    staged: bool
    threads: int
    slots: int
    smem: int  # dynamic shared memory bytes per block
    row_blocks: int  # ceil(H / RUN)
    n_runs: int  # row_blocks * W
    step_b: int  # threads // W
    step_x: int  # threads % W


def _smem_bytes(shape: Tuple[int, int], block_envs: int, staged: bool) -> int:
    """Dynamic shared memory of a block: per env the two iterate planes
    and, staged, const and denom (plane strides rounded to 16 bytes), then
    one byte of exterior bits per run, then, not staged, the swap rounds'
    decision byte plane (staged, it reuses env 0's const plane)."""
    h, w = shape
    plane = -(-(h * w) // 4) * 4 * 4
    ext = -(-(-(-h // RUN) * w) // 16) * 16
    if staged:
        return block_envs * 4 * plane + ext
    return block_envs * 2 * plane + ext + -(-(h * w) // 16) * 16


def run_geometry(shape: Tuple[int, int], block_envs: int,
                 budget: int = SMEM_BUDGET) -> Optional[RunGeometry]:
    """The launch for `block_envs` envs per block on an (H, W) grid, or
    None where it does not fit in `budget` bytes (the card's, SMEM_BUDGET):
    staged for 1..MAX_ENVS envs where four planes each fit, else one env
    reading const/denom from global memory. Threads: at most 512 for
    staged blocks of 1-2 envs, else 1024, spread evenly over the fewest
    passes."""
    h, w = shape
    e = int(block_envs)
    if 1 <= e <= MAX_ENVS and _smem_bytes(shape, e, True) <= budget:
        staged = True
    elif e == 1 and _smem_bytes(shape, 1, False) <= budget:
        staged = False
    else:
        return None
    row_blocks = -(-h // RUN)
    n_runs = row_blocks * w
    t_max = 512 if staged and e <= 2 else 1024
    slots = -(-n_runs // t_max)
    threads = -(-(-(-n_runs // slots)) // 32) * 32
    return RunGeometry(staged, threads, slots, _smem_bytes(shape, e, staged), row_blocks,
                       n_runs, threads // w, threads % w)


# Both bodies launch with one geometry (fdm_cheby_geometry and
# fdm_jacobi_geometry return the same), so each takes the same most envs
# per block (fdm_cheby_max_envs, fdm_jacobi_max_envs).
cheby_geometry = jacobi_geometry = run_geometry


def _max_envs(shape: Tuple[int, int], budget: int = SMEM_BUDGET) -> int:
    """The most envs per block a body takes on this grid (0: none fit)."""
    e = MAX_ENVS
    while e > 1 and run_geometry(shape, e, budget) is None:
        e -= 1
    return e if run_geometry(shape, e, budget) is not None else 0


cheby_max_envs = jacobi_max_envs = _max_envs


def spans_blocks(shape: Tuple[int, int], budget: int = SMEM_BUDGET) -> bool:
    """Whether an env on this grid spans several thread blocks: not even
    one env per block fits `budget` bytes of shared memory, so every
    wrapper launches a cluster body."""
    return run_geometry(shape, 1, budget) is None


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    """Launch geometry of the cluster bodies, mirroring cluster_geometry in
    csrc/fdm_kernels.cu: `cluster` CTAs per env (at most CLUSTER_MAX, as
    many as row blocks), each owning `band_blocks` consecutive row blocks
    (the last may own fewer), the band's runs spread evenly over `slots`
    passes of `threads` threads."""

    cluster: int
    band_blocks: int
    threads: int
    slots: int
    smem: int  # dynamic shared memory bytes per CTA: warp maxima, cluster slots
    row_blocks: int
    step_b: int  # threads // W
    step_x: int  # threads % W


def cluster_geometry(shape: Tuple[int, int]) -> ClusterGeometry:
    h, w = shape
    row_blocks = -(-h // RUN)
    cluster = min(CLUSTER_MAX, row_blocks)
    band = -(-row_blocks // cluster)
    cluster = -(-row_blocks // band)
    runs = band * w
    slots = -(-runs // CLUSTER_THREADS)
    threads = -(-(-(-runs // slots)) // 32) * 32
    return ClusterGeometry(cluster, band, threads, slots, 4 * (32 + 2 * CLUSTER_MAX),
                           row_blocks, threads // w, threads % w)


class SwapGroup(NamedTuple):
    """One group of a cluster body's swap plan: rounds [r0, r1); tw > 0: in
    shared memory over tiles of th x tw cells of a CTA's band with a halo
    of hy rows and hx columns (the rounds' summed reach); tw == 0: one
    round too wide for any tile, a pass over the band in global memory."""

    r0: int
    r1: int
    hy: int
    hx: int
    th: int
    tw: int


class SwapPlan(NamedTuple):
    groups: Tuple[SwapGroup, ...]
    smem: int  # shared bytes of the largest tile region (0 without tiles)


def swap_plan(shape: Tuple[int, int], offsets: Tuple[Tuple[int, int], ...],
              lib: Optional[ctypes.CDLL] = None) -> SwapPlan:
    """The swap plan the cluster bodies run on an (H, W) grid for the
    rounds' offsets, as the library computes it at launch (swap_plan in
    csrc/fdm_kernels.cu; `lib`, a host build as in _launch, else the
    card's): from round 0, each group takes consecutive rounds while their
    summed reach (each offset its shortest way round the torus) leaves a
    tile that loads at most 4 times the band's cells; a round that admits
    none alone is a group of its own. A solve crosses one cluster barrier
    between groups."""
    lib = lib or _library()
    flat = (ctypes.c_int * max(1, 2 * len(offsets)))(*[int(v) for o in offsets for v in o])
    out = (ctypes.c_int * (2 + 6 * len(offsets)))()
    err = lib.fdm_cluster_swap_plan(int(shape[0]), int(shape[1]), flat, len(offsets), out)
    if err:
        raise ValueError(f"no swap plan for {len(offsets)} rounds on a {shape} grid: "
                         f"CUDA error {err}")
    groups = tuple(SwapGroup(*out[2 + 6 * k:8 + 6 * k]) for k in range(out[0]))
    return SwapPlan(groups, out[1])


class ChunkPlan(NamedTuple):
    """The tile of the Chebyshev cluster body's chunk passes: th x tw cells
    of a CTA's band with a halo of `halo` (check_every) rows and columns,
    its region taking `smem` bytes of shared memory."""

    halo: int
    th: int
    tw: int
    smem: int


def _best_tile(rows: int, w: int, hy: int, hx: int, cell: int, line: int, budget: int):
    """(loaded cells, th, tw) of the tile whose region (halo hy x hx,
    `cell` bytes a cell and `line` a row or column) fits `budget` bytes and
    loads fewest cells, th and tw even shares of the band's `rows` and of
    W; None where none fits (best_tile in csrc/fdm_kernels.cu)."""
    best = None
    for nr in range(1, min(rows, 256) + 1):
        h = -(-rows // nr)
        if nr > 1 and h == -(-rows // (nr - 1)):
            continue  # the same tiles
        r = h + 2 * hy
        if line * r >= budget:
            continue
        w_max = min(w, (budget - line * r) // (cell * r + line) - 2 * hx)
        if w_max < 1:
            continue
        nc = -(-w // w_max)
        load = (rows + nr * 2 * hy) * (w + nc * 2 * hx)
        if best is None or load < best[0]:
            best = (load, h, -(-w // nc))
    return best


def chunk_plan(shape: Tuple[int, int], check_every: int) -> Optional[ChunkPlan]:
    """The chunk plan the Chebyshev cluster body runs on an (H, W) grid,
    mirroring chunk_plan in csrc/fdm_kernels.cu (which
    fdm_cluster_chunk_plan exports): with check_every >= 2, the tile of
    halo check_every that loads fewest cells within a CTA's tile memory;
    None where check_every is 1 or no tile fits, and the chunks stream. A
    solve crosses one cluster barrier a chunk pass in place of one a
    sub-iteration."""
    h, w = shape
    ce = int(check_every)
    if ce < 2:
        return None
    rows = min(h, cluster_geometry(shape).band_blocks * RUN)
    best = _best_tile(rows, w, ce, ce, CHUNK_CELL_BYTES, CHUNK_LINE_BYTES, TILE_BYTES)
    if best is None:
        return None
    _, th, tw = best
    r, c = th + 2 * ce, tw + 2 * ce
    return ChunkPlan(ce, th, tw, CHUNK_CELL_BYTES * r * c + CHUNK_LINE_BYTES * (r + c))


def cluster_bytes(batch: int, shape: Tuple[int, int], check_every: int = 1) -> int:
    """Device memory a cluster launch works on: per env temp, const,
    denom, the output, the scratch and the spare plane (float32), with
    chunk passes (chunk_plan) the extra plane, tinf, key, count, flag,
    barriers and tiled sub-iterations; the shared stencil (a_r, a_l, a_b,
    a_t, the packed coef), exterior and lead/follower planes."""
    cells = shape[0] * shape[1]
    planes = 7 if chunk_plan(shape, check_every) is not None else 6
    return (batch * (cells * planes * 4 + 4 + 8 + 4 + 4 + 4 + 4)
            + cells * (4 * 4 + 16 + 4 + 2 * 4))


def run_neighbours(shape: Tuple[int, int], geo: RunGeometry, edge_fill: bool):
    """The kernels' run ownership and neighbour reads, cell by cell, as
    both bodies compute them (first run by division, then the (step_b,
    step_x) step with one carry): returns (owner thread (H*W,), slot
    (H*W,), {"r", "l", "b", "t": neighbour cell (H*W,), -1 for t_inf}).
    A cell no run covers keeps owner -1; a cell covered twice raises."""
    h, w = shape
    owner = np.full(h * w, -1, np.int64)
    slot = np.full(h * w, -1, np.int64)
    nb = {k: np.full(h * w, -2, np.int64) for k in "rlbt"}
    for t in range(geo.threads):
        r, yb, x = t, t // w, t % w
        k = 0
        while r < geo.n_runs:
            y0 = yb * RUN
            n = min(RUN, h - y0)
            c0 = y0 * w + x
            ye = y0 + n
            iu = c0 - w if y0 > 0 else (h - 1) * w + x
            i_d = c0 + n * w if ye < h else x
            dl = -1 if x > 0 else w - 1
            dr = 1 if x + 1 < w else 1 - w
            for i in range(n):
                c = c0 + i * w
                if owner[c] >= 0:
                    raise AssertionError(f"cell {c} owned twice")
                owner[c], slot[c] = t, k
                nb["l"][c] = -1 if edge_fill and x == 0 else c + dl
                nb["r"][c] = -1 if edge_fill and x + 1 == w else c + dr
                nb["t"][c] = (-1 if edge_fill and y0 == 0 else iu) if i == 0 else c - w
                nb["b"][c] = (-1 if edge_fill and ye == h else i_d) if i == n - 1 else c + w
            r += geo.threads
            yb += geo.step_b
            x += geo.step_x
            if x >= w:
                x -= w
                yb += 1
            k += 1
    return owner, slot, nb


def kernel_inputs(
    temp: torch.Tensor,
    input_q: torch.Tensor,
    t_inf: torch.Tensor,
    h_conv: torch.Tensor,
    coeffs: StencilCoefficients,
) -> KernelInputs:
    """Per-step const/denom planes and the stencil planes, with the same
    float32 arithmetic as fdm_step_pallas (:877-895)."""
    const, denom = fdm.step_planes(temp, input_q, t_inf, h_conv, coeffs)
    edge_fill = not coeffs.ring_exterior
    if not edge_fill:
        ext_b = coeffs.exterior_mask
        denom = torch.where(ext_b, 1.0, denom)
        const = torch.where(ext_b, t_inf.view(-1, 1, 1), const)
    a_r, a_l, a_b, a_t, coef, ext = _stencil_planes(coeffs)
    return KernelInputs(
        temp=temp.to(torch.float32).contiguous(),
        const=const.contiguous(),
        denom=denom.contiguous(),
        tinf=t_inf.to(torch.float32).contiguous(),
        a_r=a_r, a_l=a_l, a_b=a_b, a_t=a_t, ext=ext,
        edge_fill=edge_fill,
        coef=coef,
    )


def packed_coef(a_r, a_l, a_b, a_t) -> torch.Tensor:
    """The (H, W, 4) stencil plane of KernelInputs.coef."""
    return torch.stack((a_r, a_l, a_b, a_t), dim=-1).contiguous()


# Keyed weakly by the coefficients: the planes live exactly as long as the
# env's coefficients do, since a captured program (graphs.py) reads them by
# address at every replay; a bounded cache would free them under it.
_PLANES: "weakref.WeakKeyDictionary[StencilCoefficients, Tuple[torch.Tensor, ...]]" = (
    weakref.WeakKeyDictionary())


def _stencil_planes(coeffs: StencilCoefficients) -> Tuple[torch.Tensor, ...]:
    """The kernels' stencil planes, made once per env's coefficients
    rather than every step: a_r, a_l, a_b, a_t (with a ring exterior's pin
    folded in, a* = 0 at exterior cells), their packed coef plane, and the
    exterior as float32."""
    planes = _PLANES.get(coeffs)
    if planes is None:
        ext_b = coeffs.exterior_mask
        a = (coeffs.a_r, coeffs.a_l, coeffs.a_b, coeffs.a_t)
        if coeffs.ring_exterior:
            a = tuple(torch.where(ext_b, 0.0, x) for x in a)
        a = tuple(x.contiguous() for x in a)
        planes = _PLANES[coeffs] = a + (packed_coef(*a), ext_b.to(torch.float32).contiguous())
    return planes


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' arithmetic, op for op)
# ---------------------------------------------------------------------------


def _shift(x: torch.Tensor, dim: int, shift: int, fill: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i - shift] along `dim`, vacated slots = fill (B,)."""
    rolled = torch.roll(x, shift, dim)
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device)
    mask = idx < shift if shift > 0 else idx >= n + shift
    mask = mask.view(-1, 1) if dim == x.ndim - 2 else mask
    return torch.where(mask, fill.view(-1, 1, 1), rolled)


def jacobi_update(x: torch.Tensor, inp: KernelInputs) -> torch.Tensor:
    """One Jacobi update (fdm_pallas._jacobi_update): the four neighbor
    products summed left to right, plus const, then / denom."""
    if inp.edge_fill:
        f = inp.tinf
        xr, xl = _shift(x, 2, -1, f), _shift(x, 2, 1, f)
        xb, xt = _shift(x, 1, -1, f), _shift(x, 1, 1, f)
    else:
        xr, xl = torch.roll(x, -1, 2), torch.roll(x, 1, 2)
        xb, xt = torch.roll(x, -1, 1), torch.roll(x, 1, 1)
    num = inp.a_r * xr + inp.a_l * xl + inp.a_b * xb + inp.a_t * xt + inp.const
    out = num / inp.denom
    if inp.edge_fill:
        out = torch.where(inp.ext > 0, inp.tinf.view(-1, 1, 1), out)
    return out


def _max_abs(d: torch.Tensor) -> torch.Tensor:
    return d.abs().amax(dim=(-2, -1))


def convect(x: torch.Tensor, conv: Optional[ConvInputs]) -> torch.Tensor:
    """The swap rounds of the kernels' epilogue, with the word plane when
    there is one, else the mix32 words of the keys."""
    if conv is None:
        return x
    mask = lambda a: a.to(torch.int64) & MASK32
    if conv.words is not None:
        word = mask(conv.words)
    else:
        word = convection_lib.decision_word_from_key(
            conv.keys, conv.word_params, tuple(x.shape[-2:])
        )
    return convection_lib.apply_swaps_with_word(
        x, conv.offsets, mask(conv.lead), mask(conv.foll), word
    )


def fdm_jacobi_plain(
    inp: KernelInputs,
    *,
    threshold: float,
    iteration_limit: int,
    conv: Optional[ConvInputs] = None,
    stats: Optional[ZoneStats] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of K2: per env, Jacobi while it < limit and
    max|dx| > threshold (frozen envs keep their field), then convection.
    Returns (field, n_iter int32 (B,), converged bool (B,)), and with
    `stats` also the GridSums of the field."""
    thr = torch.tensor(threshold, dtype=torch.float32, device=inp.temp.device)
    x = inp.temp
    batch = x.shape[0]
    delta = torch.full((batch,), threshold + 1.0, dtype=torch.float32, device=x.device)
    iters = torch.zeros(batch, dtype=torch.int32, device=x.device)
    for it in range(iteration_limit):
        active = delta > thr
        if not bool(active.any()):
            break
        x_new = jacobi_update(x, inp)
        d = _max_abs(x_new - x)
        x = torch.where(active.view(-1, 1, 1), x_new, x)
        delta = torch.where(active, d, delta)
        iters = torch.where(active, it + 1, iters)
    x = convect(x, conv)
    return _result(x, iters, delta <= thr, fold_stats(x, stats))


def _result(x, iters, converged, sums: Optional[GridSums]):
    """(field, iters, converged), with the sums appended when there are."""
    return (x, iters, converged) if sums is None else (x, iters, converged, sums)


def chebyshev_omegas(spectral_radius: float, n: int) -> Tuple[float, list]:
    """(omega0, [omega_1 .. omega_n]) as float32 values: omega0 in Python
    double then rounded (fdm_pallas.py:698), the recurrence
    omega <- 1 / (1 - rho^2 omega / 4) in float32 (:707-709)."""
    rho2 = float(spectral_radius) ** 2
    omega0 = np.float32(1.0 / (1.0 - rho2 / 2.0))
    rho2_f = np.float32(rho2)
    out, omega = [], omega0
    one, four = np.float32(1.0), np.float32(4.0)
    for _ in range(n):
        omega = one / (one - rho2_f * omega / four)
        out.append(omega)
    return omega0, out


def fdm_cheby_plain(
    inp: KernelInputs,
    *,
    threshold: float,
    iteration_limit: int,
    spectral_radius: float,
    check_every: int = 1,
    conv: Optional[ConvInputs] = None,
    stats: Optional[ZoneStats] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of K1, the freeze semantics of
    _fdm_cheby_kernel_interleaved: the residual is sampled at the last
    sub-iteration of each chunk of `check_every`, an env freezes at chunk
    boundaries, and J(x) of the final iterate is emitted, then convection.
    That is fdm_cheby_block_plain with one env per group. Returns (field,
    n_iter int32 (B,), converged bool (B,)), and with `stats` also the
    GridSums of the field."""
    return fdm_cheby_block_plain(
        inp, threshold=threshold, iteration_limit=iteration_limit,
        spectral_radius=spectral_radius, block_envs=1, check_every=check_every,
        conv=conv, stats=stats,
    )


def _pad_block(inp: KernelInputs, block_envs: int) -> Tuple[KernelInputs, int]:
    """The batch padded to a multiple of E by repeating its last env
    (fdm_pallas.py:861-875), and the number of groups of E."""
    b = inp.temp.shape[0]
    pad = (-b) % block_envs
    if pad:
        rep = lambda t: torch.cat([t, t[-1:].expand((pad,) + t.shape[1:])])
        inp = dataclasses.replace(
            inp, temp=rep(inp.temp), const=rep(inp.const), denom=rep(inp.denom),
            tinf=rep(inp.tinf),
        )
    return inp, (b + pad) // block_envs


def _group_running(active: torch.Tensor, groups: int) -> torch.Tensor:
    """Per env: whether its group of E envs still loops (any env active)."""
    running = active.view(groups, -1).any(dim=1, keepdim=True)
    return running.expand(groups, active.numel() // groups).reshape(-1)


def fdm_jacobi_block_plain(
    inp: KernelInputs,
    *,
    threshold: float,
    iteration_limit: int,
    block_envs: int,
    conv: Optional[ConvInputs] = None,
    stats: Optional[ZoneStats] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of K3, the semantics of _fdm_kernel_block
    (fdm_pallas.py:416): the batch cut into groups of E (the last padded by
    repeating the last env), each group looping while it < limit and any
    of its envs is active; an env freezes by select once its residual meets
    the threshold, and its count is the iteration that did. Then
    convection and the statistics per env. Returns as fdm_jacobi_plain.
    Each env's result equals fdm_jacobi_plain's for it whatever E, unless
    a residual is NaN: the solo loop (and K2) then stops that env, the
    block loop (and K3) runs it to the limit, as the JAX kernels do."""
    b = inp.temp.shape[0]
    pin, groups = _pad_block(inp, max(1, int(block_envs)))
    dev = pin.temp.device
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    x = pin.temp
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    iters = torch.zeros(x.shape[0], dtype=torch.int32, device=dev)
    for it in range(iteration_limit):
        active = ~done & _group_running(~done, groups)
        if not bool(active.any()):
            break
        x_new = jacobi_update(x, pin)
        delta = _max_abs(x_new - x)
        x = torch.where(active.view(-1, 1, 1), x_new, x)
        iters = torch.where(active, it + 1, iters)
        done = done | (active & (delta <= thr))
    x = convect(x[:b], conv)
    return _result(x, iters[:b], done[:b], fold_stats(x, stats))


def fdm_cheby_block_plain(
    inp: KernelInputs,
    *,
    threshold: float,
    iteration_limit: int,
    spectral_radius: float,
    block_envs: int,
    check_every: int = 1,
    conv: Optional[ConvInputs] = None,
    stats: Optional[ZoneStats] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of K4, the semantics of _fdm_cheby_kernel_block
    (fdm_pallas.py:505): groups of E as in fdm_jacobi_block_plain; omega is
    one schedule per group, advanced every sub-iteration; an env's freeze
    state is fixed for a whole chunk of `check_every` sub-iterations and
    sampled at its last one, and its count is the sub-iteration at the end
    of its last active chunk. Then J(x) of the final iterate, convection
    and the statistics per env. Returns as fdm_cheby_plain; each env's
    result equals fdm_cheby_plain's for it whatever E."""
    check_every = max(1, int(check_every))
    b = inp.temp.shape[0]
    pin, groups = _pad_block(inp, max(1, int(block_envs)))
    dev = pin.temp.device
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    ext = pin.ext > 0
    tinf3 = pin.tinf.view(-1, 1, 1)
    x_prev = pin.temp
    x = jacobi_update(x_prev, pin)
    done = _max_abs(x - x_prev) <= thr
    iters = torch.ones(x.shape[0], dtype=torch.int32, device=dev)
    it = 1
    _, omegas = chebyshev_omegas(spectral_radius, max(0, iteration_limit - 1) + check_every)
    while it < iteration_limit and not bool(done.all()):
        active = ~done & _group_running(~done, groups)
        active3 = active.view(-1, 1, 1)
        for _ in range(check_every):
            w = torch.tensor(omegas[it - 1], device=dev)
            jx = jacobi_update(x, pin)
            delta = _max_abs(jx - x)
            x_next = w * (jx - x_prev) + x_prev
            x_next = torch.where(ext, tinf3, x_next)
            x_prev = torch.where(active3, x, x_prev)
            x = torch.where(active3, x_next, x)
            it += 1
        iters = torch.where(active, it, iters)
        done = done | (active & (delta <= thr))
    x = convect(jacobi_update(x, pin)[:b], conv)
    return _result(x, iters[:b], done[:b], fold_stats(x, stats))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(
    inp: KernelInputs, conv: Optional[ConvInputs], stats: Optional[ZoneStats] = None,
    lib: Optional[ctypes.CDLL] = None,
) -> Tuple[int, int, int]:
    b, h, w = inp.temp.shape
    per_env = (inp.temp, inp.const, inp.denom)
    shared = (inp.a_r, inp.a_l, inp.a_b, inp.a_t, inp.ext)
    for t in per_env + shared + (inp.tinf, inp.coef):
        if t.is_cuda == (lib is not None) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous float32 CUDA tensors "
                             "(CPU tensors for a host build of the kernels)")
        if t.device != inp.temp.device:
            raise ValueError("kernel inputs must lie on one device")
    if any(t.shape != (b, h, w) for t in per_env) or inp.tinf.shape != (b,):
        raise ValueError("per-env inputs must be (B, H, W) and tinf (B,)")
    if any(t.shape != (h, w) for t in shared) or inp.coef.shape != (h, w, 4):
        raise ValueError("shared stencil planes must be (H, W) and coef (H, W, 4)")
    if conv is not None:
        if len(conv.offsets) > 32:
            raise ValueError("at most 32 convection rounds")
        words = conv.words is not None
        if not words and (conv.keys is None or conv.word_params is None):
            raise ValueError("convection needs a word plane, or keys and word_params")
        for t, shape, dtype in (
            (conv.lead, (h, w), torch.int32),
            (conv.foll, (h, w), torch.int32),
            (conv.words, (b, h, w), torch.int32) if words else
            (conv.keys, (b, 2), torch.int64),
        ):
            if t.shape != shape or t.dtype != dtype or t.device != inp.temp.device:
                raise ValueError(
                    "lead/foll must be int32 (H, W), words int32 (B, H, W) and "
                    "keys int64 (B, 2), on the kernel's device"
                )
            if not t.is_contiguous():
                raise ValueError("lead/foll/words/keys must be contiguous")
    if stats is not None:
        z, hc, wc = stats.masks.shape
        if z > MAX_STAT_ZONES:
            raise ValueError(f"kernel statistics take at most {MAX_STAT_ZONES} zones; got {z}")
        rows, cols = stats.layout.row0, stats.layout.col0
        if not (1 <= hc and 1 <= wc and min(rows) >= 0 and min(cols) >= 0
                and max(rows) + hc <= h and max(cols) + wc <= w):
            raise ValueError("zone windows must lie inside the grid")
        for t, shape, dtype in (
            (stats.masks, (z, hc, wc), torch.float32),
            (stats.row0, (z,), torch.int32),
            (stats.col0, (z,), torch.int32),
        ):
            if t.shape != shape or t.dtype != dtype or t.device != inp.temp.device:
                raise ValueError(
                    "stat masks must be float32 (Z, hc, wc) and row0/col0 "
                    "int32 (Z,), on the kernel's device"
                )
            if not t.is_contiguous():
                raise ValueError("stat masks and origins must be contiguous")
    return b, h, w


def _launch_args(inp: KernelInputs, conv: Optional[ConvInputs], stats, out, iters,
                 conv_flag, sums: Optional[GridSums], stream):
    b, h, w = inp.temp.shape
    if conv is not None:
        offsets = (ctypes.c_int * (2 * len(conv.offsets)))(
            *[v for o in conv.offsets for v in o]
        )
        n_rounds = len(conv.offsets)
        if conv.words is not None:
            lane_bits, q = 8, 0  # unused: the kernel reads the words
            ptrs = (conv.lead.data_ptr(), conv.foll.data_ptr(), None,
                    conv.words.data_ptr())
        else:
            _, _, lane_bits, q = conv.word_params
            ptrs = (conv.lead.data_ptr(), conv.foll.data_ptr(), conv.keys.data_ptr(),
                    None)
    else:
        offsets, n_rounds, lane_bits, q = None, 0, 8, 0
        ptrs = (None,) * 4
    planes = [
        inp.temp.data_ptr(), inp.const.data_ptr(), inp.denom.data_ptr(),
        inp.tinf.data_ptr(), inp.coef.data_ptr(), inp.ext.data_ptr(),
        *ptrs, out.data_ptr(), iters.data_ptr(), conv_flag.data_ptr(),
        b, h, w, int(inp.edge_fill),
    ]
    if stats is not None:
        z, hc, wc = stats.masks.shape
        stat_args = [stats.masks.data_ptr(), stats.row0.data_ptr(), stats.col0.data_ptr(),
                     sums.zone_sums.data_ptr(), sums.grid_sums.data_ptr(), z, hc, wc]
    else:
        stat_args = [None] * 5 + [0, 0, 0]
    return planes, [offsets, n_rounds, lane_bits, q, *stat_args, stream]


def _outputs(inp: KernelInputs, stats: Optional[ZoneStats]):
    b = inp.temp.shape[0]
    dev = inp.temp.device
    sums = None
    if stats is not None:
        sums = GridSums(
            torch.empty(b, stats.masks.shape[0], dtype=torch.float32, device=dev),
            torch.empty(b, dtype=torch.float32, device=dev),
        )
    return (
        torch.empty_like(inp.temp),
        torch.empty(b, dtype=torch.int32, device=dev),
        torch.empty(b, dtype=torch.int32, device=dev),
        sums,
    )


def blocks_per_sm(name: str, shape: Tuple[int, int], block_envs: int = 1,
                  device=None) -> int:
    """Thread blocks of kernel `name` resident per SM on an (H, W) grid
    (K3/K4 with `block_envs` envs per block) on `device` (the current CUDA
    device by default), from the CUDA occupancy calculator."""
    h, w = shape
    e = block_envs if name.endswith("_block") else 0
    with torch.cuda.device(device):
        return _library().fdm_blocks_per_sm(int(name.startswith("fdm_cheby")), e, h, w)


def _launch(name: str, inp: KernelInputs, conv, stats, solver_args, block_envs=None,
            lib: Optional[ctypes.CDLL] = None, budget: int = SMEM_BUDGET,
            barriers: Optional[torch.Tensor] = None,
            tiled_sweeps: Optional[torch.Tensor] = None):
    """Checks the inputs, allocates the outputs and launches kernel `name`
    (K3/K4 with `block_envs` envs per thread block); raises on a refused
    launch. `solver_args` follow the planes (and E) in the C signature.
    The launch, its stream and the shared-memory setting of the kernel are
    made on the inputs' device, whichever device is current. `lib`, a host
    C++ build of the kernel source bound with `bind`, runs the same launch
    on CPU tensors (tests/test_torch_kernel_host.py). Where one env does not
    fit `budget` bytes of a block's shared memory (the card's by default),
    the cluster body of the kernel's semantics runs instead
    (_launch_cluster), and `barriers` and `tiled_sweeps`, (B,) int32
    tensors, receive each env's cluster barriers and the sub-iterations it
    ran in chunk passes (a block kernel leaves them as they are)."""
    b, h, w = _check_inputs(inp, conv, stats, lib)
    for what, t in (("barriers", barriers), ("tiled_sweeps", tiled_sweeps)):
        if t is not None and (t.shape != (b,) or t.dtype != torch.int32
                              or t.device != inp.temp.device or not t.is_contiguous()):
            raise ValueError(
                f"{what} must be a contiguous int32 (B,) tensor on the kernel's device")
    spans = spans_blocks((h, w), budget)
    if block_envs is not None:
        fit = 1 if spans else (
            cheby_max_envs if name == "fdm_cheby_block" else jacobi_max_envs)((h, w), budget)
        if not 1 <= block_envs <= fit:
            raise ValueError(
                f"block_envs={block_envs} outside 1..{fit} for {name} on a {h}x{w} grid")
    if spans:
        return _launch_cluster(name, inp, conv, stats, solver_args, lib, barriers, tiled_sweeps)
    on_card = lib is None
    with torch.cuda.device(inp.temp.device) if on_card else contextlib.nullcontext():
        stream = torch.cuda.current_stream().cuda_stream if on_card else None
        lib = lib or _library()
        out, iters, flag, sums = _outputs(inp, stats)
        planes, tail = _launch_args(inp, conv, stats, out, iters, flag, sums, stream)
        head = [] if block_envs is None else [int(block_envs)]
        err = getattr(lib, f"{name}_launch")(*planes, *head, *solver_args, *tail)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return _result(out, iters, flag > 0, sums)


def _check_capacity(inp: KernelInputs, on_card: bool, check_every: int) -> None:
    """Refuses a cluster launch whose cells overflow the kernels' 32-bit
    cell index, or which the card cannot hold (cluster_bytes against the
    card's memory; the host build rehearses CARD_BYTES)."""
    b, h, w = inp.temp.shape
    if h * w > MAX_CELLS:
        raise ValueError(
            f"grid {h}x{w}: {h * w} cells, {4 * h * w} B a float32 plane, overflow the "
            f"kernels' 32-bit cell index (at most {MAX_CELLS} cells)")
    need = cluster_bytes(b, (h, w), check_every)
    have = (torch.cuda.get_device_properties(inp.temp.device).total_memory if on_card
            else CARD_BYTES)
    if need > have:
        raise ValueError(
            f"{b} envs on a {h}x{w} grid need {need} B of device memory for the solve's "
            f"planes, more than the card's {have} B")


def _launch_cluster(name: str, inp: KernelInputs, conv, stats, solver_args, lib, barriers,
                    tiled_sweeps):
    """The cluster body of kernel `name`'s semantics (K1/K4:
    fdm_cheby_cluster, with chunk passes where chunk_plan has a tile; K2/K3:
    fdm_jacobi_cluster with the kernel's stopping rule), one cluster per
    env; the statistics by the gridstats fold of the output. Returns as
    _launch."""
    on_card = lib is None
    cheby = name.startswith("fdm_cheby")
    check_every = int(solver_args[-1]) if cheby else 1  # the last of _cheby_args
    _check_capacity(inp, on_card, check_every)
    passes = chunk_plan(inp.temp.shape[1:], check_every) is not None
    kernel = "fdm_cheby_cluster" if cheby else "fdm_jacobi_cluster"
    head = [] if cheby else [0 if name == "fdm_jacobi" else 1]  # the stopping rule
    b = inp.temp.shape[0]
    dev = inp.temp.device
    with torch.cuda.device(dev) if on_card else contextlib.nullcontext():
        stream = torch.cuda.current_stream().cuda_stream if on_card else None
        lib = lib or _library()
        out, iters, flag, _ = _outputs(inp, None)
        scratch = torch.empty_like(inp.temp)
        spare = torch.empty_like(inp.temp) if conv is not None or passes else None
        extra = torch.empty_like(inp.temp) if passes else None
        counts = [t if t is not None else torch.empty(b, dtype=torch.int32, device=dev)
                  for t in (barriers, tiled_sweeps)]
        planes, tail = _launch_args(inp, conv, None, out, iters, flag, None, stream)
        offsets, n_rounds, lane_bits, q = tail[:4]
        ptr = lambda t: None if t is None else t.data_ptr()
        err = getattr(lib, f"{kernel}_launch")(
            *planes, *head, *solver_args, ptr(scratch), ptr(spare), ptr(extra),
            *(ptr(t) for t in counts), offsets, n_rounds, lane_bits, q, stream)
    if err:
        raise RuntimeError(f"{kernel} launch for {name} failed: CUDA error {err}")
    launch_counts[kernel] += 1
    if conv is not None:
        swap_counts["swap_groups"] += len(swap_plan(inp.temp.shape[1:], conv.offsets, lib).groups)
    return _result(out, iters, flag > 0, fold_stats(out, stats))


def _cheby_args(threshold, iteration_limit, spectral_radius, check_every):
    rho2 = float(spectral_radius) ** 2
    omega0, _ = chebyshev_omegas(spectral_radius, 0)
    return [float(threshold), int(iteration_limit), float(np.float32(rho2)),
            float(omega0), max(1, int(check_every))]


def fdm_jacobi_cuda(
    inp: KernelInputs,
    *,
    threshold: float,
    iteration_limit: int,
    conv: Optional[ConvInputs] = None,
    stats: Optional[ZoneStats] = None,
    barriers: Optional[torch.Tensor] = None,
    tiled_sweeps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Launches K2 (fdm_jacobi_body with one env per block, the solo
    stopping rule), or on a plan that spans blocks its cluster body
    (`barriers`, `tiled_sweeps`: see _launch). Same results as
    fdm_jacobi_plain."""
    return _launch("fdm_jacobi", inp, conv, stats, [float(threshold), int(iteration_limit)],
                   barriers=barriers, tiled_sweeps=tiled_sweeps)


def fdm_cheby_cuda(
    inp: KernelInputs,
    *,
    threshold: float,
    iteration_limit: int,
    spectral_radius: float,
    check_every: int = 1,
    conv: Optional[ConvInputs] = None,
    stats: Optional[ZoneStats] = None,
    barriers: Optional[torch.Tensor] = None,
    tiled_sweeps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Launches K1 (fdm_cheby_body with one env per block), or on a plan
    that spans blocks its cluster body (`barriers`, `tiled_sweeps`: see
    _launch). Same results as fdm_cheby_plain."""
    return _launch("fdm_cheby", inp, conv, stats, _cheby_args(
        threshold, iteration_limit, spectral_radius, check_every), barriers=barriers,
        tiled_sweeps=tiled_sweeps)


def fdm_jacobi_block_cuda(
    inp: KernelInputs,
    *,
    threshold: float,
    iteration_limit: int,
    block_envs: int,
    conv: Optional[ConvInputs] = None,
    stats: Optional[ZoneStats] = None,
    barriers: Optional[torch.Tensor] = None,
    tiled_sweeps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Launches K3 (fdm_jacobi_body, the block stopping rule) with
    `block_envs` envs per thread block (1 .. jacobi_max_envs; 1 on a plan
    that spans blocks, where its cluster body runs). Same results as
    fdm_jacobi_block_plain."""
    return _launch("fdm_jacobi_block", inp, conv, stats,
                   [float(threshold), int(iteration_limit)], block_envs, barriers=barriers,
                   tiled_sweeps=tiled_sweeps)


def fdm_cheby_block_cuda(
    inp: KernelInputs,
    *,
    threshold: float,
    iteration_limit: int,
    spectral_radius: float,
    block_envs: int,
    check_every: int = 1,
    conv: Optional[ConvInputs] = None,
    stats: Optional[ZoneStats] = None,
    barriers: Optional[torch.Tensor] = None,
    tiled_sweeps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Launches K4 (fdm_cheby_body) with `block_envs` envs per thread block
    (1 .. cheby_max_envs; 1 on a plan that spans blocks, where its cluster
    body runs). Same results as fdm_cheby_block_plain."""
    return _launch("fdm_cheby_block", inp, conv, stats, _cheby_args(
        threshold, iteration_limit, spectral_radius, check_every), block_envs,
        barriers=barriers, tiled_sweeps=tiled_sweeps)


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


class Solved(NamedTuple):
    """A route's solve: the field, iteration counts and converged flags, the
    kernel's statistics where the route takes them from it, and on a
    cluster plan on the card each env's counts (else None): a (2, B) int32
    tensor of its cluster barriers (row 0) and the sub-iterations it ran in
    chunk passes (row 1)."""

    field: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    sums: Optional[GridSums]
    counts: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class Route:
    """An FDM solve's path through the kernels, made by `route`: the wrapper
    `kernel` (fdm_cheby, fdm_jacobi, fdm_cheby_block or fdm_jacobi_block,
    so `fdm.launches.*` keep their names), the envs per thread block a
    block wrapper takes, whether the plan spans thread blocks (the wrappers
    then launch their cluster bodies), whether the swap rounds run in the
    kernel and whether the statistics come from its epilogue. Its device
    planes (stencil, lead/follower masks, zone statistics) are read by
    address by a captured program: it lives as long as its env."""

    kernel: str
    block_envs: int
    cluster: bool
    fuse_conv: bool
    kernel_stats: bool
    coeffs: StencilCoefficients
    solver_args: Dict[str, Union[int, float]]  # the wrappers' solver keywords, E aside
    # The fused rounds' static inputs; the step keys or the word plane come
    # per solve, the plane from `words_of` (threefry; None: mix32 words).
    conv: Optional[ConvInputs]
    words_of: Optional[convection_lib.ConvectionBuckets]
    stats: Optional[ZoneStats]

    @property
    def rule(self) -> str:
        """The stopping rule: "chebyshev", or Jacobi's "solo" (K2: a NaN
        residual stops its env) or "block" (K3: it runs to the limit)."""
        if self.kernel.startswith("fdm_cheby"):
            return "chebyshev"
        return "block" if self.kernel.endswith("_block") else "solo"

    @property
    def chunk(self) -> Optional[ChunkPlan]:
        """The chunk plan of a Chebyshev solve on a plan that spans blocks
        (its chunks as passes through shared memory: chunk_plan), else
        None (the chunks stream, or no cluster body runs)."""
        if not self.cluster or self.rule != "chebyshev":
            return None
        return chunk_plan(tuple(self.coeffs.a_r.shape), self.solver_args["check_every"])

    def conv_inputs(self, step_keys: Optional[torch.Tensor]) -> Optional[ConvInputs]:
        """The fused convection of a solve from the (B, 2) step keys."""
        if self.conv is None:
            return None
        device = self.conv.lead.device
        if self.words_of is None:
            return dataclasses.replace(
                self.conv, keys=step_keys.to(device, torch.int64).contiguous())
        word = convection_lib.swap_decision_word(self.words_of, step_keys,
                                                 tuple(self.conv.lead.shape))
        return dataclasses.replace(self.conv, words=packed_plane(word, device))

    def run(self, inp: KernelInputs, conv: Optional[ConvInputs] = None,
            stats: Optional[ZoneStats] = None,
            counts: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """The wrapper's result on kernel inputs: its kernel for CUDA tensors
        (`counts`, a (2, B) int32 tensor, receives a cluster body's barriers
        and tiled sub-iterations: see Solved), its plain version for CPU
        tensors, each looked up when called (so a stand-in set on this
        module runs)."""
        if stats is not None and stats.masks.shape[0] > MAX_STAT_ZONES:
            raise ValueError(f"kernel statistics take at most {MAX_STAT_ZONES} zones; "
                             f"got {stats.masks.shape[0]}")
        kw = dict(self.solver_args, conv=conv, stats=stats)
        if self.kernel.endswith("_block"):
            kw.update(block_envs=self.block_envs)
        if inp.temp.device.type == "cpu":
            return globals()[f"{self.kernel}_plain"](inp, **kw)
        if counts is not None:
            kw.update(barriers=counts[0], tiled_sweeps=counts[1])
        return globals()[f"{self.kernel}_cuda"](inp, **kw)

    def solve(self, temp: torch.Tensor, input_q: torch.Tensor, t_inf: torch.Tensor,
              h_conv: torch.Tensor, step_keys: Optional[torch.Tensor] = None) -> Solved:
        """One batched FDM step ((B, H, W) temp and input_q, (B,) t_inf and
        h_conv) with the route's convection and statistics."""
        counts = None
        if self.cluster and temp.is_cuda:
            counts = torch.empty(2, temp.shape[0], dtype=torch.int32, device=temp.device)
        conv = self.conv_inputs(step_keys)
        inp = kernel_inputs(temp, input_q, t_inf, h_conv, self.coeffs)
        out = self.run(inp, conv, self.stats if self.kernel_stats else None, counts)
        return Solved(*out[:3], out[3] if self.kernel_stats else None, counts)


def route(
    coeffs: StencilCoefficients, *, method: str, threshold: float, iteration_limit: int,
    spectral_radius: float = 0.0, check_every: int = 1, block_mode: str = "stack",
    block_envs: int = 1, convection: Optional[convection_lib.ConvectionBuckets] = None,
    conv_lead: Optional[torch.Tensor] = None, conv_foll: Optional[torch.Tensor] = None,
    stats: Optional[ZoneStats] = None, max_stat_zones: int = MAX_STAT_ZONES,
) -> Route:
    """The route of an FDM solve on the grid of `coeffs` (its stencil): the
    one place the kernel choice is made.

    method "jacobi" runs K2, "chebyshev" K1; block_mode "stack" with
    block_envs > 1 runs K3/K4 at one env per thread block, both bodies'
    fastest E on the main paths' inputs (12 zones B=2048, H100, PERF.md:
    two blocks per SM of 448 threads; K4 at E = 2 3-5% slower, E = 3-4
    25-30%). On a plan that spans thread blocks (spans_blocks) each wrapper
    launches its cluster body, the Chebyshev one with chunk passes where
    chunk_plan has a tile (`Route.chunk`). An enabled `convection` of method "swap"
    runs in the kernel (`conv_lead`/`conv_foll`: its masks' packed_plane
    on the device), its words from the step keys (mix32) or a threefry
    word plane; "argsort" runs after the solve. `stats` come from the
    kernel's epilogue where it holds the final field (convection fused or
    off), the zones fit `max_stat_zones` and MAX_STAT_ZONES, the kernel is
    not the interleaved K1 (the JAX package's rule, building_env.py:421-447)
    nor a cluster body; else the caller folds the field."""
    if block_mode not in ("stack", "interleave"):
        raise ValueError(f"unknown block_mode: {block_mode!r}")
    if method not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown method: {method!r}")
    cluster = spans_blocks(tuple(coeffs.a_r.shape))
    cheby = method == "chebyshev"
    kernel = ("fdm_cheby" if cheby else "fdm_jacobi") + (
        "_block" if block_mode == "stack" and block_envs > 1 else "")
    args = dict(threshold=threshold, iteration_limit=iteration_limit)
    if cheby:
        args.update(spectral_radius=spectral_radius, check_every=check_every)
    enabled = convection is not None and convection.enabled
    fuse_conv = enabled and convection.method == "swap"
    conv = None
    if fuse_conv and convection.offsets:
        conv = ConvInputs(
            offsets=tuple(tuple(int(v) for v in o) for o in convection.offsets),
            lead=conv_lead, foll=conv_foll,
            word_params=convection_lib.decision_word_params(convection))
    interleaved = cheby and block_envs > 1 and block_mode == "interleave"
    kernel_stats = (stats is not None and not interleaved and not cluster
                    and (fuse_conv or not enabled)
                    and stats.masks.shape[0] <= min(MAX_STAT_ZONES, max_stat_zones))
    # A block wrapper takes one env per thread block (above).
    return Route(kernel, 1, cluster, fuse_conv, kernel_stats, coeffs, args, conv,
                 convection if conv is not None and conv.word_params is None else None, stats)


def fdm_step_cuda(
    temp: torch.Tensor,  # (B, H, W)
    input_q: torch.Tensor,  # (B, H, W)
    t_inf: torch.Tensor,  # (B,)
    h_conv: torch.Tensor,  # (B,)
    coeffs: StencilCoefficients,
    *,
    convergence_threshold: float,
    iteration_limit: int,
    block_envs: int = 1,
    method: str = "jacobi",
    spectral_radius: float = 0.0,
    conv_offsets: Tuple[Tuple[int, int], ...] = (),
    conv_lead: Optional[torch.Tensor] = None,  # (H, W) packed lead masks
    conv_foll: Optional[torch.Tensor] = None,  # (H, W) packed follower masks
    conv_word: Optional[torch.Tensor] = None,  # (B, H, W) precomputed uint32 words
    conv_keys: Optional[torch.Tensor] = None,  # (B, 2) raw per-env step keys
    conv_word_params=None,  # convection.decision_word_params output
    stat_layout: Union[ZoneStatLayout, ZoneStats, None] = None,
    check_every: int = 1,
    block_mode: str = "stack",
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The batched FDM step of fdm_step_pallas, with its signature: the
    route of its arguments (`route`), run on them.

    Returns (new_temp, iterations, converged), or with `stat_layout` (a
    gridstats.ZoneStatLayout, or its ZoneStats already on the device)
    (new_temp, iterations, converged, GridSums): the zone and grid sums of
    the final field, computed in the kernel's epilogue (the plain version's
    fold on CPU tensors, the fold of the output after a cluster body).
    `converged` is the residual criterion itself, so with check_every > 1
    the count may exceed the limit by up to check_every - 1 while
    converged. With `conv_offsets` the swap rounds run in the kernel on the
    solved field, their decision words read from `conv_word` when given
    (the threefry words), else made from `conv_keys` with
    `conv_word_params` (mix32). `counts`, a (2, B) int32 tensor, receives
    each env's cluster barriers and tiled sub-iterations (only a cluster
    body writes it: see Solved).
    fdm_step_pallas's unused `conv_params` argument is left out.
    """
    stats = stat_layout
    if isinstance(stat_layout, ZoneStatLayout):
        stats = ZoneStats(stat_layout, temp.device)
    conv = None
    if conv_offsets:
        conv = ConvInputs(
            offsets=tuple(tuple(int(v) for v in o) for o in conv_offsets),
            lead=packed_plane(conv_lead, temp.device),
            foll=packed_plane(conv_foll, temp.device),
        )
        if conv_word is not None:
            conv = dataclasses.replace(conv, words=packed_plane(conv_word, temp.device))
        elif conv_word_params is not None and conv_keys is not None:
            conv = dataclasses.replace(
                conv, word_params=tuple(conv_word_params),
                keys=conv_keys.to(temp.device, torch.int64).contiguous())
        else:
            raise ValueError("conv_offsets need conv_word, or conv_keys with "
                             "conv_word_params")
    path = route(coeffs, method=method, threshold=convergence_threshold,
                 iteration_limit=iteration_limit, spectral_radius=spectral_radius,
                 check_every=check_every, block_mode=block_mode, block_envs=block_envs)
    inp = kernel_inputs(temp, input_q, t_inf, h_conv, coeffs)
    return path.run(inp, conv, stats, counts)

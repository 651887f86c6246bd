"""The benchmark's fixed arithmetic: the card's peaks, the operations and
bytes an FDM solve needs, the matrix products of a SAC update, and the
reduction of a torch.profiler window to kernel sums, busy time and idle
gaps. Later changes to the program cannot move these numbers.

`peaks`, `fdm_bound_ms` and `kernel_sums` are frozen copies of
chip_smoke.py's `peaks`, `bound_ms` and the sums of `device_ms` /
`profile_steps` at commit c9d3945, with the shapes passed as plain numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# (bytes/s, float32 FLOP/s outside the tensor cores) of each H100 part,
# NVIDIA's data sheet, at the full power limit (chip_smoke.py _PEAKS).
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12), "SXM": (3.35e12, 67e12)}


def peaks(name: str) -> Tuple[str, Tuple[float, float]]:
    """The part named in a device name, and its (bytes/s, FLOP/s); the
    SXM part ("NVIDIA H100 80GB HBM3") where none is named."""
    for key, value in PEAKS.items():
        if key in name:
            return key, value
    return "SXM", PEAKS["SXM"]


@dataclasses.dataclass(frozen=True)
class SolveShape:
    """What one batched FDM solve reads and does, from the configuration:
    B envs on an (H, W) grid, the swap convection's rounds and, with mix32
    words made in the kernel, the hash rounds per word (`word_rounds`;
    0 with a word plane read instead), and the statistics masks (Z, hc,
    wc) where the solve emits zone sums."""

    batch: int
    height: int
    width: int
    method: str  # "chebyshev" or "jacobi"
    conv_rounds: int = 0
    word_rounds: int = 0
    word_plane: bool = False
    stats: Optional[Tuple[int, int, int]] = None


def fdm_work(shape: SolveShape, total_iters: float) -> Tuple[float, float, float]:
    """(bytes, float32 operations, int32 operations) one solve needs, its
    envs' iterations summing to `total_iters`.

    Bytes: each input plane read once and the output written once (temp,
    const, denom in, field out, per env), the shared stencil planes and
    lead/follower words, per env t_inf, key, iteration count and flag.
    Float32: per Jacobi update 4 mul, 4 add, 1 div; per residual sample
    sub, abs, max; per Chebyshev recombination sub, mul, add; Chebyshev
    adds J(x0) with its residual and the emitted J(x_f) per env. Int32: the
    mix32 word, two fmix32 rounds (6 ops each) and 2 xors per plane, and
    per round a lane extract, compare and the two-partner select (7 ops);
    a word plane instead is read, 4 B per cell per env. Statistics: per env
    Z * hc * wc mask multiplies and about as many adds, H * W adds for the
    grid sum; the masks and window origins read once, B * (Z + 1) sums
    written."""
    b, cells = shape.batch, shape.height * shape.width
    nbytes = 4.0 * cells * b * 4
    nbytes += cells * 4 * 5 + cells * 4 * 2
    nbytes += b * (4 + 16 + 8)
    stat_ops = 0.0
    if shape.stats is not None:
        z, hc, wc = shape.stats
        nbytes += z * hc * wc * 4 + z * 8 + b * (z + 1) * 4
        stat_ops = b * (2.0 * z * hc * wc + cells)
    if shape.method == "chebyshev":
        f_ops = cells * (15.0 * total_iters + (12.0 + 9.0) * b)
    else:
        f_ops = cells * 12.0 * total_iters
    f_ops += stat_ops
    i_ops = 0.0
    if shape.conv_rounds:
        i_ops = cells * b * 7.0 * shape.conv_rounds
        if shape.word_plane:
            nbytes += cells * b * 4
        else:
            i_ops += cells * b * 14.0 * shape.word_rounds
    return nbytes, f_ops, i_ops


def fdm_bound_ms(shape: SolveShape, total_iters: float, bw: float,
                 flops: float) -> Tuple[float, str]:
    """Least time for one solve: its bytes at `bw`, or its operations at
    the float32 peak (int32 at half of it), whichever is larger, and which
    of the two bounds it."""
    nbytes, f_ops, i_ops = fdm_work(shape, total_iters)
    t_bytes = nbytes / bw * 1e3
    t_ops = (f_ops / flops + i_ops / (flops / 2)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# SAC update
# ---------------------------------------------------------------------------


def mlp_flops(layers: Sequence[Tuple[int, int]], rows: int) -> float:
    """Multiply-add operations (2 per product) of one forward pass of dense
    layers (in, out) over `rows` rows."""
    return sum(2.0 * rows * i * o for i, o in layers)


def sac_update_flops(actor: Sequence[Tuple[int, int]], critic: Sequence[Tuple[int, int]],
                     batch: int) -> float:
    """Matrix-product operations of one SAC update on `batch` rows: `actor`
    and `critic` are the dense layers (in, out) of the actor and of ONE
    critic of the twin. A backward pass costs twice its forward (the
    gradients of inputs and weights); a pass that needs only the input's
    gradient costs once.

    Critic step: the actor on next_obs and both target critics (forward),
    both critics forward and backward. Actor step: the actor forward and
    backward, both (new) critics forward and their input gradients.
    """
    a, c = mlp_flops(actor, batch), mlp_flops(critic, batch)
    critic_step = a + 2 * c + 2 * c * 3
    actor_step = a * 3 + 2 * c * 2
    return critic_step + actor_step


# ---------------------------------------------------------------------------
# Profiler windows
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    """One torch.profiler window reduced: device kernels (name, start us,
    end us), host labels (name, start us, end us) of the benchmark's own
    record_function ranges, and the window's wall span in us."""

    kernels: List[Tuple[str, float, float]]
    labels: List[Tuple[str, float, float]]
    start_us: float
    end_us: float

    @property
    def wall_us(self) -> float:
        return self.end_us - self.start_us


def window_from_profile(prof, label_prefix: str, start_us: float, end_us: float) -> Window:
    """The device operations (kernels, copies, sets) and the benchmark's
    labelled host ranges (names starting with `label_prefix`) of a finished
    torch.profiler.profile."""
    import torch

    kernels, labels = [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.name.startswith(label_prefix):
            # A labelled range shows on the device too (its annotation):
            # only its host side is kept.
            if e.device_type != torch.autograd.DeviceType.CUDA:
                labels.append((e.name, start, end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, start, end))
    return Window(kernels, labels, start_us, end_us)


def kernel_sums(kernels: Iterable[Tuple[str, float, float]]) -> Dict[str, Tuple[int, float]]:
    """Launches and device us by kernel name (device_ms / profile_steps)."""
    by_name: Dict[str, Tuple[int, float]] = {}
    for name, start, end in kernels:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + (end - start))
    return by_name


def busy_intervals(kernels: Iterable[Tuple[str, float, float]], lo: float,
                   hi: float) -> List[Tuple[float, float]]:
    """The union of kernel intervals clipped to [lo, hi], sorted, merged."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in kernels if e > lo and s < hi)
    merged: List[Tuple[float, float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def busy_us(window: Window) -> float:
    """Microseconds of the window in which some kernel ran."""
    return sum(e - s for s, e in busy_intervals(window.kernels, window.start_us,
                                                window.end_us))


def idle_gaps(window: Window, top: int = 10) -> List[Tuple[str, float]]:
    """The `top` longest gaps between busy intervals, in seconds, each named
    by the benchmark's innermost host label that spans the gap's middle
    ("host" where none does)."""
    busy = busy_intervals(window.kernels, window.start_us, window.end_us)
    edges = [window.start_us] + [x for s, e in busy for x in (s, e)] + [window.end_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        spanning = [(ls, name) for name, ls, le in window.labels if ls <= mid <= le]
        name = max(spanning)[1] if spanning else "host"
        out.append((name, (e - s) / 1e6))
    return out


def top_ops(window: Window, top: int = 10, width: int = 160) -> List[Tuple[str, float]]:
    """The `top` kernels by device time in the window, in seconds (names cut
    to `width` characters)."""
    sums = kernel_sums(window.kernels)
    ranked = sorted(sums.items(), key=lambda kv: -kv[1][1])[:top]
    return [(name[:width], t / 1e6) for name, (_, t) in ranked]

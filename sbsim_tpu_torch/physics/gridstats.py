"""Deterministic zone/grid statistics of the temperature field.

Zone average temperatures (building.py:863-871 get_zone_average_temps) and
the whole-grid mean (the AHU recirculation temperature, simulator.py:408)
feed the control phase, the observation vector, and the reward.

Port of sbsim_tpu/physics/gridstats.py. The sums use the same FIXED
halve-with-leftover fold over static slices (pure float32 adds), applied to
per-zone bounding-box windows and to the whole grid, so each env's sums are
independent of its batch and equal, addition for addition, to the JAX
package's. All zones of all envs fold at once: the windows are gathered
into one (B, Z, hc, wc) tensor and folded over its last two axes, which
performs exactly the per-zone addition sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sbsim_tpu_torch.core.geometry import BuildingGeometry


@dataclasses.dataclass(frozen=True)
class ZoneStatLayout:
    """Static per-zone windows + masks for the windowed fold (host numpy)."""

    masks: np.ndarray  # f32 (Z, hc, wc): 1.0 on the zone's cells in its window
    sizes: np.ndarray  # f32 (Z,) zone cell counts
    row0: Tuple[int, ...]
    col0: Tuple[int, ...]
    window: Tuple[int, int]
    grid_n: float


def make_zone_stat_layout(geom: BuildingGeometry) -> ZoneStatLayout:
    """Bounding-box windows (one common shape, clamped in bounds) and
    in-window masks for every zone."""
    zone_ids = np.asarray(geom.zone_ids)
    h, w = zone_ids.shape
    boxes = []
    for z in range(geom.n_zones):
        rr, cc = np.nonzero(zone_ids == z)
        boxes.append((rr.min(), rr.max() + 1, cc.min(), cc.max() + 1))
    hc = max(r1 - r0 for r0, r1, _, _ in boxes)
    wc = max(c1 - c0 for _, _, c0, c1 in boxes)
    row0, col0, masks = [], [], []
    for z, (r0, r1, c0, c1) in enumerate(boxes):
        r = min(r0, h - hc)
        c = min(c0, w - wc)
        row0.append(int(r))
        col0.append(int(c))
        masks.append((zone_ids[r : r + hc, c : c + wc] == z).astype(np.float32))
    return ZoneStatLayout(
        masks=np.stack(masks),
        sizes=np.asarray(geom.zone_sizes, np.float32),
        row0=tuple(row0),
        col0=tuple(col0),
        window=(int(hc), int(wc)),
        grid_n=float(h * w),
    )


def _fold_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Deterministic halving sum along `axis` (static slices, pure adds).

    Odd leftovers accumulate separately and are added last, so the
    sequence of float32 additions is a fixed function of the axis length
    alone (sbsim_tpu/physics/gridstats.py:86-107, in the same order).
    """
    n = x.shape[axis]
    acc = None
    while n > 1:
        if n % 2 == 1:
            last = x.narrow(axis, n - 1, 1)
            acc = last if acc is None else acc + last
            n -= 1
        half = n // 2
        x = x.narrow(axis, 0, half) + x.narrow(axis, half, half)
        n = half
    if acc is not None:
        x = x + acc
    return x


def fold_sum_2d(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last two axes -> (..., 1, 1), deterministic order
    (columns folded first, then rows)."""
    return _fold_axis(_fold_axis(x, x.ndim - 1), x.ndim - 2)


class ZoneStats:
    """The layout's windows and masks as tensors on one device."""

    def __init__(self, layout: ZoneStatLayout, device):
        hc, wc = layout.window
        rows = np.asarray(layout.row0)[:, None] + np.arange(hc)[None, :]
        cols = np.asarray(layout.col0)[:, None] + np.arange(wc)[None, :]
        self.layout = layout
        self.rows = torch.as_tensor(rows[:, :, None], device=device)
        self.cols = torch.as_tensor(cols[:, None, :], device=device)
        self.masks = torch.as_tensor(layout.masks, device=device).contiguous()
        self.sizes = torch.as_tensor(layout.sizes, device=device)
        # Window origins as the kernels' statistics epilogue reads them.
        self.row0 = torch.tensor(layout.row0, dtype=torch.int32, device=device)
        self.col0 = torch.tensor(layout.col0, dtype=torch.int32, device=device)

    def zone_sums(self, temp: torch.Tensor) -> torch.Tensor:
        """(B, H, W) fields -> (B, Z) per-zone sums."""
        win = temp[:, self.rows, self.cols] * self.masks  # (B, Z, hc, wc)
        return fold_sum_2d(win)[..., 0, 0]

    def zone_means(self, temp: torch.Tensor) -> torch.Tensor:
        return self.zone_sums(temp) / self.sizes

    def grid_sum(self, temp: torch.Tensor) -> torch.Tensor:
        """(B, H, W) fields -> (B,) whole-grid sums."""
        return fold_sum_2d(temp)[..., 0, 0]

    def grid_mean(self, temp: torch.Tensor) -> torch.Tensor:
        """(B, H, W) fields -> (B,) whole-grid means."""
        return self.grid_sum(temp) / self.layout.grid_n

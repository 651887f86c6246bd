"""The building's grid, worked out from the configuration file's floor plan
(sbsim's FloorPlanBasedBuilding semantics, building.py:608-893 of
google/sbsim): outside air, the exterior-wall shell grown two cells inward,
interior walls, 4-connected rooms numbered in raster order, evenly spaced
diffusers, and the stencil's open faces and half-width boundary cells.
Float64 NumPy, built once per run."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
from scipy import ndimage

INTERIOR, WALL, OUTSIDE = 0.0, 1.0, 2.0
# Cells of wall within this distance of the exterior shell are exterior wall.
EXTERIOR_WALL_DEPTH = 2
DIFFUSER_SPACING = 10
_CROSS = ndimage.generate_binary_structure(2, 1)


def office_plan(n_rooms_x: int, n_rooms_y: int, room_cvs: int, air_margin: int = 3) -> np.ndarray:
    """A raster office of n_rooms_x by n_rooms_y square rooms of room_cvs
    cells, one-cell walls between them, inside a margin of outside air:
    the plan the benchmark hands to both sides."""
    inner_h = n_rooms_x * room_cvs + n_rooms_x + 1
    inner_w = n_rooms_y * room_cvs + n_rooms_y + 1
    plan = np.full((inner_h + 2 * air_margin, inner_w + 2 * air_margin), OUTSIDE)
    plan[air_margin:air_margin + inner_h, air_margin:air_margin + inner_w] = WALL
    for rx in range(n_rooms_x):
        for ry in range(n_rooms_y):
            x = air_margin + 1 + rx * (room_cvs + 1)
            y = air_margin + 1 + ry * (room_cvs + 1)
            plan[x:x + room_cvs, y:y + room_cvs] = INTERIOR
    return plan


def _padded(plan: np.ndarray) -> np.ndarray:
    """A rim of outside air wherever a wall touches the frame."""
    top, left = np.any(plan[0] == WALL), np.any(plan[:, 0] == WALL)
    bottom, right = np.any(plan[-1] == WALL), np.any(plan[:, -1] == WALL)
    return np.pad(plan, ((int(top), int(bottom)), (int(left), int(right))),
                  constant_values=OUTSIDE)


def _even(start: int, end: int) -> List[int]:
    span = end - start
    if span == 0:
        return [start]
    n = max(1, int(np.round(span / DIFFUSER_SPACING)))
    return [int(math.ceil(i)) for i in np.arange(start, end, span / (n + 1))[1:]]


def _diffusers(labels: np.ndarray, n_rooms: int, walls0: np.ndarray, buffer: int) -> np.ndarray:
    """Per-cell share of its room's supply air: evenly spaced cells of each
    rectangular room (the first axis kept `buffer` cells from the walls
    where the room is wide enough), none on an interior wall."""
    out = np.zeros(labels.shape)
    for k in range(1, n_rooms + 1):
        cells = np.argwhere(labels == k)
        xs, ys = cells[:, 0], cells[:, 1]
        if len(cells) / (max(int(np.ptp(xs)), 1) * max(int(np.ptp(ys)), 1)) <= 0.1:
            raise ValueError("the reference places diffusers in rectangular rooms only")
        x0, x1, y0, y1 = int(xs.min()), int(xs.max()), int(ys.min()), int(ys.max())
        if x1 - x0 > 2 * buffer:
            x0, x1 = x0 + buffer, x1 - buffer
        px, py = set(_even(x0, x1)), set(_even(y0, y1))
        chosen = [(x, y) for x, y in cells if x in px and y in py and not walls0[x, y]]
        if not chosen:
            raise ValueError(f"room {k} has no diffuser")
        for x, y in chosen:
            out[x, y] = 1.0 / len(chosen)
    return out


@dataclasses.dataclass
class Grid:
    """The grid as the solve reads it (float64 NumPy), in the orientation
    the configuration file states."""

    conductivity: np.ndarray
    heat_capacity: np.ndarray
    density: np.ndarray
    faces: Dict[str, np.ndarray]  # k_* (conductivity or 0 on an open face), h_* (1 open)
    u: np.ndarray
    v: np.ndarray
    fixed: np.ndarray  # bool: cells held at the ambient temperature
    diffusers: np.ndarray
    zone_ids: np.ndarray  # int: the zone of a room cell, n_zones elsewhere
    n_zones: int
    cv_m: float
    floor_height_m: float
    initial_temp: float

    @property
    def shape(self):
        return self.zone_ids.shape


def build(spec: Dict) -> Grid:
    """The grid of the configuration file `spec`."""
    b = spec["building"]
    plan = _padded(office_plan(**spec["floor_plan"]))
    outside = plan == OUTSIDE
    shell = ndimage.binary_dilation(outside, _CROSS) & ~outside
    walls0 = (plan == WALL) & ~shell
    near = np.round(ndimage.distance_transform_edt(~shell), 2) <= EXTERIOR_WALL_DEPTH
    ext_walls = near & (shell | walls0)
    int_walls = walls0 & ~ext_walls
    labels, n_rooms = ndimage.label(plan == INTERIOR, _CROSS)
    diffusers = _diffusers(labels, n_rooms, walls0, b["buffer_from_walls"])

    def material(prop):
        out = np.full(plan.shape, float(b["inside_air"][prop]))
        out[ext_walls] = b["exterior_wall"][prop]
        out[int_walls] = b["inside_wall"][prop]
        return out

    arrays = {"conductivity": material("conductivity"),
              "heat_capacity": material("heat_capacity"),
              "density": material("density"),
              "present": ~outside, "diffusers": diffusers,
              "zone_ids": np.where(labels > 0, labels - 1, n_rooms)}
    grid = tuple(spec["sizes"]["grid"])
    if plan.shape != grid:
        if plan.shape[::-1] != grid:
            raise ValueError(f"the plan is {plan.shape}, the file states {grid}")
        arrays = {k: np.ascontiguousarray(v.T) for k, v in arrays.items()}
    present = arrays["present"]
    pad = np.pad(present, 1)
    nbr = {"left": pad[1:-1, :-2], "right": pad[1:-1, 2:],
           "top": pad[:-2, 1:-1], "bottom": pad[2:, 1:-1]}
    count = np.where(present, sum(m.astype(int) for m in nbr.values()), 0)
    boundary = present & (count >= 2) & (count <= 3)
    faces = {}
    for side, there in nbr.items():
        open_ = boundary & ~there
        faces["k_" + side] = np.where(open_, 0.0, arrays["conductivity"])
        faces["h_" + side] = open_.astype(np.float64)
    cv = b["cv_size_cm"] / 100.0
    u = np.where(boundary & ~(nbr["left"] & nbr["right"]), 0.5 * cv, cv)
    v = np.where(boundary & ~(nbr["top"] & nbr["bottom"]), 0.5 * cv, cv)
    return Grid(conductivity=arrays["conductivity"], heat_capacity=arrays["heat_capacity"],
                density=arrays["density"], faces=faces, u=u, v=v,
                fixed=~present | (count <= 1), diffusers=arrays["diffusers"],
                zone_ids=arrays["zone_ids"], n_zones=int(n_rooms), cv_m=cv,
                floor_height_m=b["floor_height_cm"] / 100.0,
                initial_temp=float(b["initial_temp"]))

"""Host-side floor-plan raster processing (numpy and C++ ops, no OpenCV).

Copy of sbsim_tpu/core/floorplan.py. Labeling, dilation and the distance
transform run through the port's host C++ ops (sbsim_tpu_torch/native), as
the JAX package's do through its own.

Turns a raster floor plan (0 = interior space, 1 = wall, 2 = outside air) and a
zone map into the static per-CV masks the simulator needs: room labels,
exterior-wall shell, interior walls, thermal-diffuser placement.

This is one-time preprocessing that runs on the host; the outputs become
device-resident arrays inside BuildingGeometry.

Behavioral parity with the reference pipeline
(smart_control/simulator/building_utils.py:144-509 and
thermal_diffuser_utils.py:36-262), with union-find labeling, cross dilation
and the exact Euclidean distance transform in place of OpenCV.
Connected-component labels are assigned in raster-scan order of first
encounter, matching cv2.connectedComponentsWithStats numbering.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sbsim_tpu_torch import constants, native

Coord = Tuple[int, int]
RoomDict = Dict[str, List[Coord]]


def read_floor_plan(filepath: str) -> np.ndarray:
    """Loads a floor plan from a .csv or .npy file.

    Parity: building_utils.read_floor_plan_from_filepath (:74-110).
    """
    suffix = pathlib.Path(filepath).suffix
    with open(filepath, "rb") as fp:
        if suffix == ".csv":
            plan = np.loadtxt(fp, delimiter=",")
        elif suffix == ".npy":
            plan = np.load(fp, allow_pickle=True)
        else:
            raise ValueError("Floor plan must be .csv or .npy")
    return np.asarray(plan)


def guarantee_air_padding(floor_plan: np.ndarray) -> np.ndarray:
    """Pads with a rim of outside air wherever walls touch the frame edge.

    Parity: building_utils.guarantee_air_padding_in_frame (:144-219).
    """
    if 1 in floor_plan.shape or 0 in floor_plan.shape:
        raise ValueError("floor plan is a 1 dimensional array")
    plan = floor_plan
    ext = constants.EXTERIOR_SPACE_VALUE
    wall = constants.WALL_VALUE
    if np.any(plan[0, :] == wall):
        plan = np.concatenate([np.full((1, plan.shape[1]), ext), plan], axis=0)
    if np.any(plan[:, 0] == wall):
        plan = np.concatenate([np.full((plan.shape[0], 1), ext), plan], axis=1)
    if np.any(plan[-1, :] == wall):
        plan = np.concatenate([plan, np.full((1, plan.shape[1]), ext)], axis=0)
    if np.any(plan[:, -1] == wall):
        plan = np.concatenate([plan, np.full((plan.shape[0], 1), ext)], axis=1)
    return plan


def label_connected_rooms(zone_map: np.ndarray) -> np.ndarray:
    """Labels 4-connected components of interior space in the zone map.

    Returns an int array where:
      -1 marks outside air,
       0 marks walls (and any other non-space CV),
       1..n mark rooms, numbered in raster-scan order of first encounter.

    Parity: building_utils.process_and_run_connected_components (:417-434);
    union-find labeling with 4-connectivity reproduces
    cv2.connectedComponentsWithStats(connectivity=4) numbering.
    """
    is_space = zone_map == constants.INTERIOR_SPACE_VALUE
    out = native.connected_components_4(is_space).astype(np.int64)
    out[zone_map == constants.EXTERIOR_SPACE_VALUE] = -1
    return out


def label_exterior_wall_shell(exterior_space: np.ndarray) -> np.ndarray:
    """Returns a bool mask of the one-CV shell of wall touching outside air.

    Parity: building_utils._label_exterior_wall_shell (:322-356).
    """
    near = native.binary_dilation_cross(exterior_space, iterations=1)
    return near & ~exterior_space


def enlarge_component(mask: np.ndarray, distance: float) -> np.ndarray:
    """Returns mask of CVs within `distance` (L2) of the given component.

    Parity: building_utils.enlarge_component (:485-509). The reference uses
    cv2.distanceTransform(DIST_L2, maskSize=3) (3x3 chamfer approximation);
    for the small distances used here (EXPAND_EXTERIOR_WALLS_BY_CV_AMOUNT=2)
    the exact Euclidean transform selects the same set of CVs.
    """
    distances = np.round(
        native.distance_transform_edt(~mask.astype(bool)), decimals=2
    )
    return distances <= distance


def expand_exterior_walls(
    exterior_wall_shell: np.ndarray,
    interior_walls: np.ndarray,
    amount: int = constants.EXPAND_EXTERIOR_WALLS_BY_CV_AMOUNT,
) -> Tuple[np.ndarray, np.ndarray]:
    """Grows the exterior-wall shell inward, reclassifying interior walls.

    A wall CV within `amount` of the shell becomes exterior wall; remaining
    interior-wall CVs keep their label.

    Parity: building.enlarge_exterior_walls (building.py:183-229): the
    enlarged region is intersected with (interior | exterior) walls, so only
    actual wall CVs are reclassified.

    Args:
      exterior_wall_shell: bool mask of the 1-CV exterior shell.
      interior_walls: bool mask of interior-wall CVs.
      amount: how many CVs inward to grow.

    Returns:
      (exterior_walls, interior_walls) bool masks after expansion.
    """
    grown = enlarge_component(exterior_wall_shell, amount)
    any_wall = exterior_wall_shell | interior_walls
    exterior = grown & any_wall
    interior = interior_walls & ~exterior
    return exterior, interior


@dataclasses.dataclass
class ProcessedFloorPlan:
    """Static masks derived from a raster floor plan + zone map."""

    floor_plan: np.ndarray  # padded raster plan (H, W)
    exterior_space: np.ndarray  # bool (H, W): outside air
    exterior_walls: np.ndarray  # bool (H, W): expanded exterior walls
    interior_walls: np.ndarray  # bool (H, W): remaining interior walls
    # Pre-expansion interior walls (wall CVs minus the 1-CV exterior shell);
    # the diffuser filter uses these (building.py:751-757).
    interior_walls_initial: np.ndarray  # bool (H, W)
    room_labels: np.ndarray  # int (H, W): -1 outside, 0 wall, 1..n rooms
    room_dict: RoomDict  # room_k -> list of (i, j)

    @property
    def n_rooms(self) -> int:
        return int(self.room_labels.max())

    def room_names(self) -> List[str]:
        return [f"{constants.ROOM_PREFIX}_{k}" for k in range(1, self.n_rooms + 1)]


def process_floor_plan(
    floor_plan: np.ndarray, zone_map: Optional[np.ndarray] = None
) -> ProcessedFloorPlan:
    """Runs the full preprocessing pipeline.

    Parity: building_utils.construct_building_data_types (:437-483) followed
    by building.enlarge_exterior_walls (building.py:183-229).
    """
    if zone_map is None:
        zone_map = floor_plan
    plan = guarantee_air_padding(floor_plan)
    zmap = guarantee_air_padding(zone_map)
    if plan.shape != zmap.shape:
        raise ValueError(
            f"floor plan {plan.shape} and zone map {zmap.shape} differ in shape"
        )

    exterior_space = plan == constants.EXTERIOR_SPACE_VALUE
    shell = label_exterior_wall_shell(exterior_space)
    interior_walls_initial = (plan == constants.WALL_VALUE) & ~shell
    exterior_walls, interior_walls = expand_exterior_walls(
        shell, interior_walls_initial
    )

    room_labels = label_connected_rooms(zmap)
    room_dict: RoomDict = {}
    for k in range(1, int(room_labels.max()) + 1):
        coords = np.argwhere(room_labels == k)
        room_dict[f"{constants.ROOM_PREFIX}_{k}"] = [tuple(c) for c in coords]

    return ProcessedFloorPlan(
        floor_plan=plan,
        exterior_space=exterior_space,
        exterior_walls=exterior_walls,
        interior_walls=interior_walls,
        interior_walls_initial=interior_walls_initial,
        room_labels=room_labels,
        room_dict=room_dict,
    )


# ---------------------------------------------------------------------------
# Thermal diffuser placement
# ---------------------------------------------------------------------------


def _evenly_spaced_inds(start: int, end: int, spacing: int) -> List[int]:
    """Parity: thermal_diffuser_utils._evenly_spaced_inds_from_domain (:36-69)."""
    ind_len = end - start
    if ind_len == 0:
        return [start]
    n_diffusers = max(1, int(np.round(ind_len / spacing)))
    placement = np.arange(start, end, ind_len / (n_diffusers + 1))[1:]
    return [int(math.ceil(i)) for i in placement]


def _is_rectangular(coords: Sequence[Coord], threshold: float) -> bool:
    """Parity: thermal_diffuser_utils._rectangularity_test (:72-109)."""
    arr = np.asarray(coords)
    xs, ys = arr[:, 0], arr[:, 1]
    vol = max(int(xs.max() - xs.min()), 1) * max(int(ys.max() - ys.min()), 1)
    return len(arr) / vol > threshold


def _random_diffuser_inds(
    coords: Sequence[Coord], spacing: int, seed: int = 23
) -> np.ndarray:
    """Parity: thermal_diffuser_utils._determine_random_inds_... (:112-139)."""
    rng = np.random.default_rng(seed)
    num = int(max(1, np.round(len(coords) / (spacing * spacing))))
    return rng.choice(np.asarray(coords), num, replace=False)


def _even_diffuser_inds(
    coords: Sequence[Coord], spacing: int, buffer_from_walls: int
) -> np.ndarray:
    """Parity: thermal_diffuser_utils._determine_equal_spacing_... (:142-190)."""
    arr = np.asarray(coords)
    xs, ys = arr[:, 0], arr[:, 1]
    start_x, end_x = int(xs.min()), int(xs.max())
    start_y, end_y = int(ys.min()), int(ys.max())
    if end_x - start_x > 2 * buffer_from_walls:
        start_x += buffer_from_walls
        end_x -= buffer_from_walls
    px = set(_evenly_spaced_inds(start_x, end_x, spacing))
    py = set(_evenly_spaced_inds(start_y, end_y, spacing))
    inds = [c for c in coords if c[0] in px and c[1] in py]
    return np.asarray(inds)


def place_room_diffusers(
    coords: Sequence[Coord],
    spacing: int = 10,
    interior_walls: Optional[np.ndarray] = None,
    buffer_from_walls: int = 2,
) -> np.ndarray:
    """Chooses diffuser CVs for one room.

    Parity: thermal_diffuser_utils.diffuser_allocation_switch (:193-262):
    evenly spaced for rectangular-enough rooms, random fallback otherwise,
    then drop any index that lands on an interior wall.
    """
    if _is_rectangular(coords, threshold=0.1):
        inds = _even_diffuser_inds(coords, spacing, buffer_from_walls)
    else:
        inds = _random_diffuser_inds(coords, spacing)
    if len(inds) == 0:
        inds = _random_diffuser_inds(coords, spacing)
    if interior_walls is not None:
        inds = np.asarray(
            [ind for ind in inds if not interior_walls[ind[0], ind[1]]]
        )
    return inds


def assign_thermal_diffusers(
    shape: Tuple[int, int],
    room_dict: RoomDict,
    interior_walls: Optional[np.ndarray] = None,
    diffuser_spacing: int = 10,
    buffer_from_walls: int = 5,
) -> np.ndarray:
    """Returns (H, W) array of per-CV heat fractions; each room sums to 1.

    Parity: building._assign_thermal_diffusers (building.py:299-353).
    """
    diffusers = np.zeros(shape, dtype=np.float64)
    for name, coords in room_dict.items():
        if not name.startswith(constants.ROOM_PREFIX):
            continue
        inds = place_room_diffusers(
            coords,
            spacing=diffuser_spacing,
            interior_walls=interior_walls,
            buffer_from_walls=buffer_from_walls,
        )
        for ind in inds:
            diffusers[tuple(ind)] = 1.0 / float(len(inds))
    return diffusers

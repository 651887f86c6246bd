"""BuildingGeometry: static stencil arrays for one building (host numpy).

Everything here is computed once on the host with numpy; the environment
copies the arrays it needs to its device as tensors. Port of
sbsim_tpu/core/geometry.py with the flax pytree replaced by a frozen
dataclass; the arithmetic is unchanged, so every array is equal.

The finite-difference discretization follows the reference's "Equation 22"
vectorized form (smart_control/simulator/tf_simulator.py:283-456): each CV has
oriented per-face conductivities (zeroed across faces that border outside
air), per-face convection masks, and half-width cell dimensions on boundary
faces. CVs with <=1 in-building neighbors are "exterior" and pinned to the
ambient temperature (tf_simulator.py:491-498).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from sbsim_tpu_torch.core import floorplan as floorplan_lib


@dataclasses.dataclass(frozen=True)
class MaterialProperties:
    """Physical constants of one material (building.py:35-42)."""

    conductivity: float  # W/m/K
    heat_capacity: float  # J/kg/K
    density: float  # kg/m3


@dataclasses.dataclass(frozen=True)
class BuildingGeometry:
    """Static arrays describing one building discretization.

    All (H, W) float arrays are float32 (the FDM runs in f32, matching
    tf_simulator.py:611-619). Axis 0 is "vertical" (i), axis 1 "horizontal"
    (j), as in the reference.
    """

    # Material property grids.
    conductivity: Any  # f32 (H, W)
    heat_capacity: Any  # f32 (H, W)
    density: Any  # f32 (H, W)

    # Oriented face conductivities: zero across faces adjacent to outside air
    # (tf_simulator.get_oriented_conductivity_tensors :401-456). Note the
    # reference pairs k_left with the *right*-neighbor temperature (x[i][j+1])
    # and k_right with the left neighbor; we preserve that pairing exactly in
    # the solver (tf_simulator.py:719-722).
    k_left: Any  # f32 (H, W)
    k_right: Any
    k_top: Any
    k_bottom: Any

    # Per-face convection masks (1.0 on faces exposed to outside air;
    # tf_simulator.get_oriented_convection_coefficient_tensors :332-398).
    h_left: Any  # f32 (H, W)
    h_right: Any
    h_top: Any
    h_bottom: Any

    # CV dimensions in meters: u horizontal, v vertical; boundary faces are
    # half width (tf_simulator.get_cv_dimension_tensors :283-329).
    u: Any  # f32 (H, W)
    v: Any  # f32 (H, W)

    # CVs pinned to ambient air (0-1 in-building neighbors).
    exterior_mask: Any  # bool (H, W)

    # Heat-injection fractions per CV; each zone's fractions sum to 1.
    diffusers: Any  # f32 (H, W)

    # Zone membership: int32 in [0, n_zones) for zone air CVs, n_zones
    # elsewhere (walls / outside).
    zone_ids: Any  # i32 (H, W)
    zone_sizes: Any  # f32 (n_zones,) number of CVs per zone

    # Initial / reset temperature field.
    reset_temps: Any  # f32 (H, W)

    # --- static metadata ---
    n_zones: int
    cv_size_m: float
    floor_height_m: float
    zone_names: Tuple[str, ...]
    zone_ext_ids: Tuple[str, ...]
    shape: Tuple[int, int]

    @property
    def n_cvs(self) -> int:
        return self.shape[0] * self.shape[1]


def _neighbor_present_masks(present: np.ndarray) -> Dict[str, np.ndarray]:
    """For each direction, whether the neighbor CV exists (in-bounds and
    part of the building, i.e. not outside air).

    "left" means the (i, j-1) neighbor, "top" the (i-1, j) neighbor, matching
    tf_simulator's edge orientations (classify_cv :233-243).
    """
    h, w = present.shape
    pad = np.zeros((h + 2, w + 2), dtype=bool)
    pad[1:-1, 1:-1] = present
    return {
        "left": pad[1:-1, :-2],
        "right": pad[1:-1, 2:],
        "top": pad[:-2, 1:-1],
        "bottom": pad[2:, 1:-1],
    }


def build_geometry(
    *,
    conductivity: np.ndarray,
    heat_capacity: np.ndarray,
    density: np.ndarray,
    present: np.ndarray,
    diffusers: np.ndarray,
    zone_ids: np.ndarray,
    zone_names: Sequence[str],
    zone_ext_ids: Sequence[str],
    cv_size_m: float,
    floor_height_m: float,
    initial_temp: float,
    reset_temps: Optional[np.ndarray] = None,
) -> BuildingGeometry:
    """Assembles a BuildingGeometry from raw property grids.

    Args:
      present: bool (H, W); False marks outside-air CVs that are not part of
        the building (FloorPlanBasedBuilding excludes them from neighbor
        lists, building.py:794-813). For the legacy rectangular building all
        CVs are present.
      zone_ids: int (H, W), [0, n_zones) for zone air CVs, n_zones elsewhere.
    """
    conductivity = np.asarray(conductivity, dtype=np.float64)
    shape = conductivity.shape
    nbr = _neighbor_present_masks(present)
    n_neighbors = sum(m.astype(np.int32) for m in nbr.values())
    n_neighbors = np.where(present, n_neighbors, 0)

    exterior_mask = ~present | (n_neighbors <= 1)
    boundary = present & (n_neighbors >= 2) & (n_neighbors <= 3)

    # A face is "open" (borders outside air / frame edge) when its neighbor is
    # absent. Only boundary CVs get convection and zeroed conduction there.
    def face(name: str) -> Tuple[np.ndarray, np.ndarray]:
        missing = ~nbr[name]
        k = np.where(boundary & missing, 0.0, conductivity)
        hmask = np.where(boundary & missing, 1.0, 0.0)
        return k.astype(np.float32), hmask.astype(np.float32)

    k_left, h_left = face("left")
    k_right, h_right = face("right")
    k_top, h_top = face("top")
    k_bottom, h_bottom = face("bottom")

    # Half-width cells on boundary faces: u halves when a horizontal face is
    # open, v when a vertical face is open (tf_simulator.py:57-86, 304-321).
    horiz_open = boundary & (~nbr["left"] | ~nbr["right"])
    vert_open = boundary & (~nbr["top"] | ~nbr["bottom"])
    u = np.where(horiz_open, 0.5 * cv_size_m, cv_size_m).astype(np.float32)
    v = np.where(vert_open, 0.5 * cv_size_m, cv_size_m).astype(np.float32)

    if reset_temps is None:
        reset = np.full(shape, initial_temp, dtype=np.float32)
    else:
        reset = np.asarray(reset_temps, dtype=np.float32)

    n_zones = len(zone_names)
    zone_ids = np.asarray(zone_ids, dtype=np.int32)
    zone_sizes = np.bincount(
        zone_ids[zone_ids < n_zones].ravel(), minlength=n_zones
    ).astype(np.float32)

    return BuildingGeometry(
        conductivity=conductivity.astype(np.float32),
        heat_capacity=np.asarray(heat_capacity, dtype=np.float32),
        density=np.asarray(density, dtype=np.float32),
        k_left=k_left,
        k_right=k_right,
        k_top=k_top,
        k_bottom=k_bottom,
        h_left=h_left,
        h_right=h_right,
        h_top=h_top,
        h_bottom=h_bottom,
        u=u,
        v=v,
        exterior_mask=exterior_mask,
        diffusers=np.asarray(diffusers, dtype=np.float32),
        zone_ids=zone_ids,
        zone_sizes=zone_sizes,
        reset_temps=reset,
        n_zones=n_zones,
        cv_size_m=float(cv_size_m),
        floor_height_m=float(floor_height_m),
        zone_names=tuple(zone_names),
        zone_ext_ids=tuple(zone_ext_ids),
        shape=tuple(shape),
    )


def transpose_geometry(geom: BuildingGeometry) -> BuildingGeometry:
    """The same building with the grid axes swapped (layout lever).

    layout="auto" applies it where padded_grid_cost shrinks (the 124x189
    full-scale grid becomes 189x124). Physics is
    orientation-symmetric, so the transpose just permutes the oriented
    face tensors: the new left neighbor (i, j-1) is the old top neighbor
    of the transposed coordinate, u/v swap, zone labels are UNCHANGED
    (labeling happened on the original orientation). Trajectories are
    statistically identical but not bitwise (the 4-term stencil sum
    rounds in a different order).
    """

    def T(a):
        return np.ascontiguousarray(np.asarray(a).T)

    return BuildingGeometry(
        conductivity=T(geom.conductivity),
        heat_capacity=T(geom.heat_capacity),
        density=T(geom.density),
        k_left=T(geom.k_top),
        k_right=T(geom.k_bottom),
        k_top=T(geom.k_left),
        k_bottom=T(geom.k_right),
        h_left=T(geom.h_top),
        h_right=T(geom.h_bottom),
        h_top=T(geom.h_left),
        h_bottom=T(geom.h_right),
        u=T(geom.v),
        v=T(geom.u),
        exterior_mask=T(geom.exterior_mask),
        diffusers=T(geom.diffusers),
        zone_ids=T(geom.zone_ids),
        zone_sizes=np.asarray(geom.zone_sizes),
        reset_temps=T(geom.reset_temps),
        n_zones=geom.n_zones,
        cv_size_m=geom.cv_size_m,
        floor_height_m=geom.floor_height_m,
        zone_names=geom.zone_names,
        zone_ext_ids=geom.zone_ext_ids,
        shape=(geom.shape[1], geom.shape[0]),
    )


def padded_grid_cost(shape: Tuple[int, int]) -> int:
    """Positions of the (8, 128)-padded f32 tiling of this grid.

    This models the TPU's vector tiling, not the GPU. It is kept so that
    layout="auto" transposes exactly the grids the JAX package transposes,
    which keeps the two packages' configurations comparable."""
    h, w = shape
    return ((h + 7) // 8 * 8) * ((w + 127) // 128 * 128)


def layout_transposed(layout: str, shape: Tuple[int, int]) -> bool:
    """Whether BuildingConfig.layout runs a grid of the plan's `shape`
    transposed: "transposed" always, "ref" never, "auto" where the
    transpose's padded cost is strictly smaller (ties keep the reference
    orientation), exactly where the JAX package transposes."""
    if layout == "auto":
        return padded_grid_cost((shape[1], shape[0])) < padded_grid_cost(shape)
    if layout in ("ref", "transposed"):
        return layout == "transposed"
    raise ValueError(f"unknown building layout: {layout!r}")


# ---------------------------------------------------------------------------
# Floor-plan based construction (FloorPlanBasedBuilding, building.py:608-893)
# ---------------------------------------------------------------------------


def geometry_from_floor_plan(
    floor_plan: np.ndarray,
    *,
    cv_size_cm: float,
    floor_height_cm: float,
    initial_temp: float,
    inside_air: MaterialProperties,
    inside_wall: MaterialProperties,
    exterior_wall: MaterialProperties,
    zone_map: Optional[np.ndarray] = None,
    buffer_from_walls: int = 3,
    reset_temps: Optional[np.ndarray] = None,
) -> BuildingGeometry:
    """Builds geometry from a raster floor plan.

    Mirrors FloorPlanBasedBuilding.__init__ (building.py:634-766): process the
    plan, expand exterior walls, assign per-CV material properties by wall
    masks, place diffusers, compute neighbor-aware stencil tensors.
    """
    processed = floorplan_lib.process_floor_plan(floor_plan, zone_map)

    def assign(prop: str) -> np.ndarray:
        # building.py:727-749: interior walls, then exterior walls, then air
        # for both interior and exterior space.
        out = np.full(
            processed.floor_plan.shape, getattr(inside_air, prop), np.float64
        )
        out[processed.exterior_walls] = getattr(exterior_wall, prop)
        out[processed.interior_walls] = getattr(inside_wall, prop)
        return out

    diffusers = floorplan_lib.assign_thermal_diffusers(
        processed.floor_plan.shape,
        processed.room_dict,
        # The reference filters diffuser positions against the
        # *pre-expansion* interior walls (building.py:751-757).
        interior_walls=processed.interior_walls_initial,
        buffer_from_walls=buffer_from_walls,
    )

    room_names = processed.room_names()
    zone_ids = np.where(
        processed.room_labels > 0, processed.room_labels - 1, len(room_names)
    )
    # zone_id wire format: "zone_id_<k>" (conversion_utils
    # .floor_plan_based_zone_identifier_to_id, conversion_utils.py:75-77).
    zone_ext_ids = [
        "zone_id_" + name.replace("room_", "") for name in room_names
    ]

    return build_geometry(
        conductivity=assign("conductivity"),
        heat_capacity=assign("heat_capacity"),
        density=assign("density"),
        present=~processed.exterior_space,
        diffusers=diffusers,
        zone_ids=zone_ids,
        zone_names=room_names,
        zone_ext_ids=zone_ext_ids,
        cv_size_m=cv_size_cm / 100.0,
        floor_height_m=floor_height_cm / 100.0,
        initial_temp=initial_temp,
        reset_temps=reset_temps,
    )


# ---------------------------------------------------------------------------
# Legacy rectangular construction (Building, building.py:394-605)
# ---------------------------------------------------------------------------


def rectangular_grids(
    room_shape: Tuple[int, int], building_shape: Tuple[int, int]
) -> Tuple[int, int]:
    nrows = (room_shape[0] + 1) * building_shape[0] + 3
    ncols = (room_shape[1] + 1) * building_shape[1] + 3
    return nrows, ncols


def rectangular_zone_bounds(
    zone: Tuple[int, int], room_shape: Tuple[int, int]
) -> Tuple[int, int, int, int]:
    """(min_x, max_x, min_y, max_y) air-CV bounds of a zone (building.py:159)."""
    zx, zy = zone
    x_min = zx * (room_shape[0] + 1) + 2
    y_min = zy * (room_shape[1] + 1) + 2
    return (x_min, x_min + room_shape[0] - 1, y_min, y_min + room_shape[1] - 1)


def geometry_rectangular(
    *,
    cv_size_cm: float,
    floor_height_cm: float,
    room_shape: Tuple[int, int],
    building_shape: Tuple[int, int],
    initial_temp: float,
    inside_air: MaterialProperties,
    inside_wall: MaterialProperties,
    building_exterior: MaterialProperties,
) -> BuildingGeometry:
    """W x H grid of identical rectangular rooms plus a 2-layer outer shell.

    Mirrors Building.__init__ (building.py:418-504): outer two layers are
    exterior material, rooms are separated by 1-CV interior walls, 4 diffusers
    per room (generate_thermal_diffusers, building.py:102-156). All CVs are
    part of the building (no outside-air CVs), so the literal grid border
    forms the corner/edge boundary CVs.
    """
    nrows, ncols = rectangular_grids(room_shape, building_shape)
    shape = (nrows, ncols)

    def assign(prop: str) -> np.ndarray:
        out = np.full(shape, getattr(inside_air, prop), dtype=np.float64)
        # Interior walls between rooms (building.py:77-99).
        for x in range(room_shape[0] + 2, nrows - 2, room_shape[0] + 1):
            out[x, 2 : ncols - 2] = getattr(inside_wall, prop)
        for y in range(room_shape[1] + 2, ncols - 2, room_shape[1] + 1):
            out[2 : nrows - 2, y] = getattr(inside_wall, prop)
        # Outer 2 layers (building.py:63-74).
        out[:, [0, 1, -2, -1]] = getattr(building_exterior, prop)
        out[[0, 1, -2, -1], :] = getattr(building_exterior, prop)
        return out

    # 4 diffusers per room, evenly placed (building.py:102-156).
    diffusers = np.zeros(shape, dtype=np.float64)
    d1x = (room_shape[0] - 2) // 3
    d2x = room_shape[0] - d1x - 1
    d1y = (room_shape[1] - 2) // 3
    d2y = room_shape[1] - d1y - 1
    for rx in range(2, nrows - 3, room_shape[0] + 1):
        for ry in range(2, ncols - 3, room_shape[1] + 1):
            for dx in (d1x, d2x):
                for dy in (d1y, d2y):
                    diffusers[rx + dx, ry + dy] = 0.25

    zone_ids = np.full(shape, building_shape[0] * building_shape[1], np.int64)
    zone_names: List[str] = []
    zone_ext_ids: List[str] = []
    z = 0
    for zx in range(building_shape[0]):
        for zy in range(building_shape[1]):
            x0, x1, y0, y1 = rectangular_zone_bounds((zx, zy), room_shape)
            zone_ids[x0 : x1 + 1, y0 : y1 + 1] = z
            zone_names.append(f"({zx}, {zy})")
            # conversion_utils.zone_coordinates_to_id (conversion_utils.py:72)
            zone_ext_ids.append(f"zone_id_({zx}, {zy})")
            z += 1

    return build_geometry(
        conductivity=assign("conductivity"),
        heat_capacity=assign("heat_capacity"),
        density=assign("density"),
        present=np.ones(shape, dtype=bool),
        diffusers=diffusers,
        zone_ids=zone_ids,
        zone_names=zone_names,
        zone_ext_ids=zone_ext_ids,
        cv_size_m=cv_size_cm / 100.0,
        floor_height_m=floor_height_cm / 100.0,
        initial_temp=initial_temp,
    )


def make_synthetic_office_plan(
    n_rooms_x: int = 3,
    n_rooms_y: int = 4,
    room_cvs: int = 12,
    air_margin: int = 3,
) -> np.ndarray:
    """Generates a simple office-like raster floor plan for tests/benchmarks.

    The released sb1 floor-plan blobs are absent from the reference snapshot
    (configs/resources/sb1/.MISSING_LARGE_BLOBS), so calibrated-scale runs use
    synthetic plans with comparable CV counts.
    """
    inner_h = n_rooms_x * room_cvs + (n_rooms_x + 1)
    inner_w = n_rooms_y * room_cvs + (n_rooms_y + 1)
    h = inner_h + 2 * air_margin
    w = inner_w + 2 * air_margin
    plan = np.full((h, w), 2.0)
    r0, c0 = air_margin, air_margin
    plan[r0 : r0 + inner_h, c0 : c0 + inner_w] = 1.0
    for rx in range(n_rooms_x):
        for ry in range(n_rooms_y):
            x = r0 + 1 + rx * (room_cvs + 1)
            y = c0 + 1 + ry * (room_cvs + 1)
            plan[x : x + room_cvs, y : y + room_cvs] = 0.0
    return plan

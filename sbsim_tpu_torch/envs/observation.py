"""Observation vector assembly over an env batch.

Builds the flat float32 observation in the reference's field order
(environment.py:709-813): devices sorted by device id, measurements sorted
alphabetically within a device, histogram-reduced measurements contributing
per-bin count features instead of per-device features, followed by the
auxiliary time/comfort/occupancy features (environment.py:555-573, 916-956).

Port of sbsim_tpu/envs/observation.py: the layout is built on the host with
the same field order and constants; assembly takes (B,) scalars and (B, Z)
per-VAV values and returns (B, obs_dim).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

AHU_DEVICE_ID = "air_handler"
BOILER_DEVICE_ID = "boiler"

# Sorted measurement names (environment.py:547-552 sorts device ids then
# measurement names).
AHU_MEASUREMENTS = (
    "cooling_request_count",
    "differential_pressure_setpoint",
    "discharge_fan_speed_percentage_command",
    "outside_air_flowrate_sensor",
    "outside_air_temperature_sensor",  # present when weather is attached
    "supply_air_cooling_temperature_setpoint",
    "supply_air_flowrate_sensor",
    "supply_air_heating_temperature_setpoint",
    "supply_fan_speed_percentage_command",
)
BOILER_MEASUREMENTS = (
    "heating_request_count",
    "supply_water_setpoint",
    "supply_water_temperature_sensor",
)
VAV_MEASUREMENTS = (
    "supply_air_damper_percentage_command",
    "supply_air_flowrate_setpoint",
    "zone_air_temperature_sensor",
)


@dataclasses.dataclass(frozen=True)
class ObsLayout:
    """Static observation layout + normalization constants (host numpy)."""

    scalar_means: np.ndarray  # f32 (S,)
    scalar_stds: np.ndarray  # f32 (S,)
    scalar_zero: np.ndarray  # bool (S,) zero-variance fields pinned to 0
    vav_means: np.ndarray  # f32 (3,)
    vav_stds: np.ndarray  # f32 (3,)
    vav_zero: np.ndarray  # bool (3,)
    vav_device_order: np.ndarray  # i64 (Z,) zones sorted by device id string
    hist_bins: np.ndarray  # f32 (3, max_bins) padded bin edges
    hist_n_bins: np.ndarray  # i32 (3,) actual edge counts
    field_names: Tuple[str, ...]
    use_histogram: Tuple[bool, bool, bool]
    normalize_histogram: bool
    ahu_has_outside_temp: bool
    num_hod_features: int
    num_dow_features: int

    @property
    def n_fields(self) -> int:
        return len(self.field_names)


def _norm_constants(
    names: Sequence[str], table: Mapping[str, Tuple[float, float]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-field (mean, std, zero_mask): unknown fields pass through
    unchanged, zero-variance fields collapse to 0
    (observation_normalizer.py:60-91)."""
    means, stds, zero = [], [], []
    for name in names:
        if name in table:
            mean, var = table[name]
            if var > 0:
                means.append(mean)
                stds.append(float(np.sqrt(var)))
                zero.append(False)
            else:
                means.append(0.0)
                stds.append(1.0)
                zero.append(True)
        else:
            means.append(0.0)
            stds.append(1.0)
            zero.append(False)
    return (
        np.asarray(means, np.float32),
        np.asarray(stds, np.float32),
        np.asarray(zero),
    )


def build_obs_layout(
    zone_names: Sequence[str],
    observation_normalization: Mapping[str, Tuple[float, float]],
    histogram_parameters: Mapping[str, Sequence[float]],
    *,
    ahu_has_outside_temp: bool = True,
    normalize_histogram: bool = True,
    num_hod_features: int = 1,
    num_dow_features: int = 1,
) -> ObsLayout:
    """Builds the static observation layout for one building config."""
    ahu_fields = tuple(
        m
        for m in AHU_MEASUREMENTS
        if ahu_has_outside_temp or m != "outside_air_temperature_sensor"
    )
    scalar_names = [f"{AHU_DEVICE_ID}_{m}" for m in ahu_fields] + [
        f"{BOILER_DEVICE_ID}_{m}" for m in BOILER_MEASUREMENTS
    ]
    scalar_means, scalar_stds, scalar_zero = _norm_constants(
        list(ahu_fields) + list(BOILER_MEASUREMENTS), observation_normalization
    )
    vav_means, vav_stds, vav_zero = _norm_constants(
        VAV_MEASUREMENTS, observation_normalization
    )

    # Devices iterate sorted by id; VAV ids are "vav_<zone_name>", giving a
    # lexicographic order over zones (environment.py:740, 789).
    device_ids = [f"vav_{name}" for name in zone_names]
    vav_device_order = np.argsort(np.asarray(device_ids, dtype=object))

    use_histogram = tuple(m in histogram_parameters for m in VAV_MEASUREMENTS)
    max_bins = max(
        [len(histogram_parameters.get(m, ())) for m in VAV_MEASUREMENTS] + [1]
    )
    hist_bins = np.zeros((3, max_bins), np.float32)
    hist_n = np.zeros((3,), np.int32)
    for i, m in enumerate(VAV_MEASUREMENTS):
        edges = histogram_parameters.get(m, ())
        hist_bins[i, : len(edges)] = edges
        hist_n[i] = len(edges)

    # Field ordering (environment.py:731-781): histogram blocks in
    # measurement order, then passthrough VAV fields per device in
    # sorted-device order, then the auxiliary features.
    field_names: List[str] = list(scalar_names)
    for i, m in enumerate(VAV_MEASUREMENTS):
        if use_histogram[i]:
            for edge in histogram_parameters[m]:
                field_names.append(f"{m}_h_%.2f" % edge)
    for z in vav_device_order:
        for i, m in enumerate(VAV_MEASUREMENTS):
            if not use_histogram[i]:
                field_names.append(f"{device_ids[z]}_{m}")
    for prefix, n in (
        ("hod_cos", num_hod_features),
        ("hod_sin", num_hod_features),
        ("dow_cos", num_dow_features),
        ("dow_sin", num_dow_features),
    ):
        field_names += [f"{prefix}_%03d" % i for i in range(n)]
    field_names += ["comfort_mode_now", "comfort_mode_soon", "num_occupants"]

    return ObsLayout(
        scalar_means=scalar_means,
        scalar_stds=scalar_stds,
        scalar_zero=scalar_zero,
        vav_means=vav_means,
        vav_stds=vav_stds,
        vav_zero=vav_zero,
        vav_device_order=vav_device_order.astype(np.int64),
        hist_bins=hist_bins,
        hist_n_bins=hist_n,
        field_names=tuple(field_names),
        use_histogram=use_histogram,
        normalize_histogram=normalize_histogram,
        ahu_has_outside_temp=ahu_has_outside_temp,
        num_hod_features=num_hod_features,
        num_dow_features=num_dow_features,
    )


def layout_on(layout: ObsLayout, device) -> ObsLayout:
    """The layout with the arrays that `assemble_observation` reads as data
    on `device`, made once per env so that a step (and a captured one,
    graphs.py) makes no tensor from host data; the fields that steer the
    assembly (vav_zero, hist_n_bins, use_histogram) stay on the host."""
    t = lambda a: torch.as_tensor(a, device=device)
    return dataclasses.replace(
        layout,
        scalar_means=t(layout.scalar_means),
        scalar_stds=t(layout.scalar_stds),
        scalar_zero=t(layout.scalar_zero),
        vav_means=t(layout.vav_means),
        vav_stds=t(layout.vav_stds),
        vav_device_order=t(layout.vav_device_order),
        hist_bins=t(layout.hist_bins),
    )


def _clipped_histogram(values: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """(B, Z) values -> (B, n_edges) counts per bin with min/max clipping.

    Parity: histogram_reducer.get_clipped_histogram (:136-148): values land
    in bin i when edges[i] <= v < edges[i+1], the last bin holding only
    v == max(edges) after clipping.
    """
    e = torch.as_tensor(edges, device=values.device)
    v = torch.clamp(values, min=e[0], max=e[-1])
    # bin index = number of edges[1:] that are <= v.
    idx = (v[..., None] >= e[1:]).sum(dim=-1)
    bins = torch.arange(len(edges), device=values.device)
    return (idx[..., None] == bins).sum(dim=-2).to(torch.float32)


def _expand_time_features(
    rad: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) angles -> (B, n) phase-shifted cos/sin pairs
    (regression_building_utils.py:97-126)."""
    shift = torch.arange(n, dtype=torch.float32, device=rad.device) / n
    phase = rad[:, None] + shift * (2.0 * math.pi)
    return torch.cos(phase), torch.sin(phase)


def assemble_observation(
    layout: ObsLayout,
    *,
    ahu_values: Dict[str, torch.Tensor],  # measurement -> (B,)
    boiler_values: Dict[str, torch.Tensor],  # measurement -> (B,)
    vav_values: Dict[str, torch.Tensor],  # measurement -> (B, Z)
    hod_rad: torch.Tensor,  # (B,)
    dow_rad: torch.Tensor,
    comfort_now: torch.Tensor,
    comfort_soon: torch.Tensor,
    num_occupants: torch.Tensor,
) -> torch.Tensor:
    """Builds the normalized flat observations, (B, obs_dim) float32. The
    layout's data arrays may be host numpy or device tensors (`layout_on`)."""
    ahu_fields = [
        m
        for m in AHU_MEASUREMENTS
        if layout.ahu_has_outside_temp or m != "outside_air_temperature_sensor"
    ]
    batch = hod_rad.shape[0]
    dev = hod_rad.device
    as_batch = lambda x: torch.as_tensor(x, device=dev).to(torch.float32).expand(batch)
    scalars = torch.stack(
        [as_batch(ahu_values[m]) for m in ahu_fields]
        + [as_batch(boiler_values[m]) for m in BOILER_MEASUREMENTS],
        dim=-1,
    )
    t = lambda a: torch.as_tensor(a, device=dev)
    scalars_n = torch.where(
        t(layout.scalar_zero),
        0.0,
        (scalars - t(layout.scalar_means)) / t(layout.scalar_stds),
    )

    pieces = [scalars_n]
    per_device = []
    for i, m in enumerate(VAV_MEASUREMENTS):
        v = vav_values[m].to(torch.float32).expand(batch, -1)
        mean = t(layout.vav_means[i])
        std = t(layout.vav_stds[i])
        normed = torch.zeros_like(v) if layout.vav_zero[i] else (v - mean) / std
        # Histogram blocks come first (measurement order), then passthrough
        # VAV features per device in sorted-device order.
        if layout.use_histogram[i]:
            n_edges = int(layout.hist_n_bins[i])
            counts = _clipped_histogram(normed, layout.hist_bins[i, :n_edges])
            if layout.normalize_histogram:
                counts = counts / counts.sum(dim=-1, keepdim=True)
            pieces.append(counts)
        else:
            per_device.append(normed)
    if per_device:
        stacked = torch.stack(per_device, dim=-1)  # (B, Z, n_passthrough)
        order = t(layout.vav_device_order)
        pieces.append(stacked[:, order].reshape(batch, -1))

    hod_cos, hod_sin = _expand_time_features(hod_rad, layout.num_hod_features)
    dow_cos, dow_sin = _expand_time_features(dow_rad, layout.num_dow_features)
    flags = torch.stack(
        [
            comfort_now.to(torch.float32),
            comfort_soon.to(torch.float32),
            num_occupants.to(torch.float32),
        ],
        dim=-1,
    )
    pieces += [hod_cos, hod_sin, dow_cos, dow_sin, flags]
    return torch.cat(pieces, dim=-1).to(torch.float32)

"""Matplotlib plotting helpers for episodes and training runs.

The analytical-plot layer (reference plot_utils.py:1-537): building heatmap,
zone-temperature timelines against the comfort schedule, reward/energy
timelines, learning curves from JSONL metrics. Port of
sbsim_tpu/io/plots.py: the data (`schedule_plot_data`,
`EpisodeDashboard.update`) is numpy, `datetime` and `Frame`; matplotlib is
imported only by the functions that draw.
"""

from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional, Sequence

import numpy as np

from sbsim_tpu_torch.utils.frame import Frame


def _timestamp(stamp) -> datetime.datetime:
    """An ISO timestamp (or a datetime) as an aware datetime in its own
    offset; a naive one is taken as UTC."""
    ts = stamp if isinstance(stamp, datetime.datetime) else datetime.datetime.fromisoformat(
        str(stamp))
    return ts if ts.tzinfo is not None else ts.replace(tzinfo=datetime.timezone.utc)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_building_heatmap(
    temps: np.ndarray,
    wall_mask: Optional[np.ndarray] = None,
    vmin: float = 280.0,
    vmax: float = 300.0,
    ax=None,
):
    """Temperature field heatmap with walls overlaid in black."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(np.asarray(temps), cmap="rainbow", vmin=vmin, vmax=vmax)
    if wall_mask is not None:
        overlay = np.zeros(np.asarray(wall_mask).shape + (4,))
        overlay[np.asarray(wall_mask) != 0] = (0, 0, 0, 1)
        ax.imshow(overlay)
    ax.figure.colorbar(im, ax=ax, label="K")
    ax.set_xticks([])
    ax.set_yticks([])
    return ax


def plot_zone_timeline(
    zone_temps: np.ndarray,  # (T, Z)
    heating_setpoints: Optional[np.ndarray] = None,  # (T,)
    cooling_setpoints: Optional[np.ndarray] = None,
    zone_names: Optional[Sequence[str]] = None,
    step_minutes: float = 5.0,
    ax=None,
):
    """Zone temperature trajectories against the setpoint band."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 4))
    t = np.arange(zone_temps.shape[0]) * step_minutes / 60.0
    for z in range(zone_temps.shape[1]):
        label = zone_names[z] if zone_names else f"zone {z}"
        ax.plot(t, zone_temps[:, z], lw=0.8, label=label)
    if heating_setpoints is not None and cooling_setpoints is not None:
        ax.fill_between(
            t,
            heating_setpoints,
            cooling_setpoints,
            color="green",
            alpha=0.12,
            label="setpoint band",
        )
    ax.set_xlabel("hours")
    ax.set_ylabel("K")
    if zone_temps.shape[1] <= 8:
        ax.legend(fontsize=8)
    return ax


def plot_reward_components(
    breakdowns: Mapping[str, np.ndarray],  # name -> (T,)
    step_minutes: float = 5.0,
    ax=None,
):
    """Per-step reward/energy component timelines."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 4))
    for name, series in breakdowns.items():
        t = np.arange(len(series)) * step_minutes / 60.0
        ax.plot(t, series, lw=0.8, label=name)
    ax.set_xlabel("hours")
    ax.legend(fontsize=8)
    return ax


def schedule_plot_data(
    tables,
    start_timestamp: str,
    step_sec: float = 300.0,
):
    """Comfort/eco setpoint windows of an episode as a Frame.

    The TPU-native equivalent of SetpointSchedule.get_plot_data
    (reference setpoint_schedule.py:130-217): instead of re-walking the
    tz-aware calendar, the windows are read off the precomputed step tables
    (scenario/tables.py) that drive the simulation itself, so the plotted
    schedule is by construction the schedule the env executed. Columns
    match the reference: comfort_mode, start_time, end_time,
    heating_setpoint, cooling_setpoint (comfort_mode as 1.0 / 0.0).
    """
    comfort = np.asarray(tables.comfort, bool)
    heat = np.asarray(tables.heating_setpoint, np.float64)
    cool = np.asarray(tables.cooling_setpoint, np.float64)
    base = _timestamp(start_timestamp)
    dt = datetime.timedelta(seconds=float(step_sec))
    # Contiguous runs of the comfort flag.
    edges = np.flatnonzero(np.diff(comfort.astype(np.int8))) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [len(comfort)]])
    return Frame.from_columns(
        {
            "comfort_mode": comfort[starts],
            "start_time": [base + int(s) * dt for s in starts],
            "end_time": [base + int(e) * dt for e in ends],
            "heating_setpoint": heat[starts],
            "cooling_setpoint": cool[starts],
        }
    )


def plot_schedule_windows(windows, ax=None, celsius: bool = True):
    """Draws the day/night setpoint rectangles of `schedule_plot_data`
    (the reference's translucent comfort-band rectangles,
    plot_utils.py:291-312)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 3))
    off = 273.0 if celsius else 0.0
    import matplotlib.dates as mdates

    for comfort, start, end, heat, cool in zip(
        windows["comfort_mode"], windows["start_time"], windows["end_time"],
        windows["heating_setpoint"], windows["cooling_setpoint"],
    ):
        left = mdates.date2num(start)
        width = mdates.date2num(end) - left
        ax.add_patch(
            plt.Rectangle(
                (left, heat - off),
                width,
                cool - heat,
                fill=True,
                edgecolor=None,
                alpha=0.3,
                facecolor="white" if comfort else "lightgray",
            )
        )
    ax.xaxis_date()
    return ax


class EpisodeDashboard:
    """Live-updating composite episode figure (zone-temp timeline over the
    setpoint schedule + energy-rate timeline + building heatmap).

    The analogue of the reference's init_metrics/update_metrics/plot_update
    loop (plot_utils.py:441-537 feeding plot_combined_results:402-438):
    `update` accumulates one step of scalars, `render` draws the composite
    and optionally writes `thermal_step_<local time>.png` into `writedir`.
    """

    def __init__(
        self,
        zone_names,
        start_timestamp: str,
        step_sec: float = 300.0,
        schedule_windows=None,
        writedir: Optional[str] = None,
    ):
        self.zone_names = list(zone_names)
        self._base = _timestamp(start_timestamp)
        self._dt = datetime.timedelta(seconds=float(step_sec))
        self._windows = schedule_windows
        self._writedir = writedir
        self.timestamps = []
        self.ambient_temps = []
        self.zone_temps = []  # list of (Z,) arrays
        self.energy_rates = {
            "boiler_thermal_energy_rate": [],
            "boiler_electrical_energy_rate": [],
            "air_handler_fan_energy_rate": [],
            "air_handler_thermal_energy_rate": [],
        }

    def update(
        self,
        step_idx: int,
        ambient_temp: float,
        zone_temps,
        boiler_thermal: float = 0.0,
        boiler_electrical: float = 0.0,
        ahu_fan: float = 0.0,
        ahu_thermal: float = 0.0,
    ) -> None:
        """Accumulates one env step (reference update_metrics)."""
        self.timestamps.append(self._base + int(step_idx) * self._dt)
        self.ambient_temps.append(float(ambient_temp))
        self.zone_temps.append(np.asarray(zone_temps, np.float64))
        self.energy_rates["boiler_thermal_energy_rate"].append(
            float(boiler_thermal)
        )
        self.energy_rates["boiler_electrical_energy_rate"].append(
            float(boiler_electrical)
        )
        self.energy_rates["air_handler_fan_energy_rate"].append(
            float(ahu_fan)
        )
        self.energy_rates["air_handler_thermal_energy_rate"].append(
            float(ahu_thermal)
        )

    def render(
        self,
        temp_field: np.ndarray,
        wall_mask: Optional[np.ndarray] = None,
        vmin: float = 280.0,
        vmax: float = 300.0,
    ):
        """Draws the 3-panel composite (reference plot_combined_results:
        temp timeline / energy timeline / building thermal view, height
        ratios 1:1:2.3) and writes the per-step PNG when `writedir` is
        set. Returns the figure."""
        plt = _plt()
        fig, (ax1, ax2, ax3) = plt.subplots(
            nrows=3,
            ncols=1,
            gridspec_kw={"height_ratios": [1, 1, 2.3]},
            figsize=(14, 14),
        )
        # Panel 1: schedule rectangles + zone temps + ambient (C).
        if self._windows is not None:
            plot_schedule_windows(self._windows, ax=ax1)
        zt = np.stack(self.zone_temps) if self.zone_temps else np.zeros((0, 0))
        for z in range(zt.shape[1] if zt.size else 0):
            ax1.plot(self.timestamps, zt[:, z] - 273.0, color="gold", lw=0.8)
        ax1.plot(
            self.timestamps,
            np.asarray(self.ambient_temps) - 273.0,
            color="blue",
            lw=2.0,
            label="ambient",
        )
        ax1.set_facecolor("black")
        ax1.set_ylabel("Temp [C]")
        ax1.grid(color="gray", lw=0.5)
        # Panel 2: energy rates in kW (boiler lime, AHU magenta; thermal
        # solid, electrical/fan dashed - the reference's line styling).
        styles = {
            "boiler_thermal_energy_rate": ("lime", "-"),
            "boiler_electrical_energy_rate": ("lime", "--"),
            "air_handler_fan_energy_rate": ("magenta", "--"),
            "air_handler_thermal_energy_rate": ("magenta", "-"),
        }
        for name, series in self.energy_rates.items():
            color, ls = styles[name]
            ax2.plot(
                self.timestamps,
                np.asarray(series) / 1000.0,
                color=color,
                linestyle=ls,
                lw=1.5,
                label=name,
            )
        ax2.set_facecolor("black")
        ax2.set_ylabel("Energy Rate [kW]")
        ax2.grid(color="gray", lw=0.5)
        ax2.legend(fontsize=7, loc="upper right")
        # Panel 3: thermal view with local time + ambient annotation
        # (plot_utils.py:279-288).
        plot_building_heatmap(
            temp_field, wall_mask=wall_mask, vmin=vmin, vmax=vmax, ax=ax3
        )
        if self.timestamps:
            ax3.text(
                0.01,
                1.0,
                "Local time %s, Ambient temp %3.1f C"
                % (
                    self.timestamps[-1].strftime("%Y-%m-%d %H:%M"),
                    self.ambient_temps[-1] - 273.0,
                ),
                transform=ax3.transAxes,
                ha="left",
                va="top",
            )
        if self._writedir and self.timestamps:
            os.makedirs(self._writedir, exist_ok=True)
            name = "thermal_step_%s.png" % self.timestamps[-1].strftime(
                "%Y-%m-%d_%H-%M-%S"
            )
            fig.savefig(os.path.join(self._writedir, name))
        return fig


def plot_learning_curve(metrics_jsonl_path: str, key: str = "reward_mean", ax=None):
    """Learning curve from a JSONL metrics stream (io/metrics.py)."""
    from sbsim_tpu_torch.io.metrics import load_metrics

    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    columns = load_metrics(metrics_jsonl_path)
    ax.plot(columns["step"], columns[key])
    ax.set_xlabel("train step")
    ax.set_ylabel(key)
    return ax

"""What every cell's run shares: finding a cell's configuration, traffic mix
and per-layer metrics by name, the card check, the guard against JAX, the
profiler window, and the one result line.

The registry is data: `BENCHMARK.json` names each cell's configuration
(`portbench/configs/<name>.json`) and traffic mix
(`portbench/traffic/<name>.json`); a mix's `kind` names its general
generator (`portbench/drivers/<kind>.py`); each per-layer metric is a
reader of its own (`portbench/metrics/<name>.py`, `read(trace)` returning
a number or None). Adding a cell, a mix or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Modules whose presence in the process after the window refuses the run:
# JAX and the JAX package, compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "sbsim_tpu")
# Host labels of the benchmark's own ranges in a profiler window.
LABEL = "portbench."


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(kind: str, name: str) -> Dict[str, Any]:
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def config_spec(name: str) -> Dict[str, Any]:
    return _load_json("configs", name)


def traffic_spec(name: str) -> Dict[str, Any]:
    return _load_json("traffic", name)


def driver(kind: str):
    """The general generator of a traffic kind."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """`read` of portbench/metrics/<name>.py (a name may hold dots, so the
    file is loaded by path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with what it names."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: Tuple[Dict[str, Any], ...]
    per_layer: Tuple[Dict[str, Any], ...]


def cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench or benchmark()
    (w,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def applies(m):
        return name in m.get("workloads", [name])

    e2e = tuple(m for m in bench["end_to_end"] if applies(m))
    reported = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"]
                  if m["moves"] in reported and applies(m))
    return Cell(name, int(w["chips"]), config_spec(w["config"]), traffic_spec(w["traffic"]),
                e2e, layer)


# ---------------------------------------------------------------------------
# Configuration: one JSON file, run by the program and worked out again by
# the reference
# ---------------------------------------------------------------------------


def episode_steps(spec: Dict[str, Any]) -> int:
    return int(spec["num_days_in_episode"] * 24 * 3600 / spec["time_step_sec"])


def env_config(spec: Dict[str, Any]):
    """The program's EnvConfig of a configuration file: its preset over the
    benchmark's floor plan, with the layout set after the preset where the
    file names one."""
    from sbsim_tpu_torch.envs import presets

    from portbench import inputs

    prog = spec["program"]
    if prog["preset"] != "sb1_config":
        raise ValueError(f"unknown preset {prog['preset']!r}")
    cfg = presets.sb1_config(num_days_in_episode=spec["num_days_in_episode"],
                             floor_plan=inputs.floor_plan(spec))
    if prog.get("layout"):
        cfg = dataclasses.replace(
            cfg, building=dataclasses.replace(cfg.building, layout=prog["layout"]))
    return cfg


def _listed(v):
    return list(v) if isinstance(v, tuple) else v


def stated_by_program(spec: Dict[str, Any], cfg) -> Dict[str, Any]:
    """What the program's EnvConfig says of each value the file states."""
    b = cfg.building
    mat = lambda m: {"conductivity": m.conductivity, "heat_capacity": m.heat_capacity,
                     "density": m.density}
    pick = lambda obj, keys: {k: _listed(getattr(obj, k)) for k in keys}
    norms = cfg.action_normalizers
    return {
        "building": {"cv_size_cm": b.cv_size_cm, "floor_height_cm": b.floor_height_cm,
                     "initial_temp": b.initial_temp, "buffer_from_walls": b.buffer_from_walls,
                     "inside_air": mat(b.inside_air), "inside_wall": mat(b.inside_wall),
                     "exterior_wall": mat(b.building_exterior)},
        "hvac": pick(cfg.hvac, spec["hvac"]),
        "weather_kind": cfg.weather.kind,
        "convection_coefficient": cfg.weather.convection_coefficient,
        "schedule": pick(cfg.schedule, spec["schedule"]),
        "occupancy": pick(cfg.occupancy, spec["occupancy"]),
        "convection": {"p": cfg.convection.p, "distance": cfg.convection.distance,
                       "rounds": cfg.convection.rounds, "rng": cfg.convection.rng},
        "reward": pick(cfg.reward, spec["reward"]),
        "start_timestamp": cfg.start_timestamp, "time_step_sec": cfg.time_step_sec,
        "solver": {"convergence_threshold": cfg.convergence_threshold,
                   "iteration_limit": cfg.iteration_limit},
        "discount_factor": cfg.discount_factor,
        "observation": {
            "ahu_observes_outside_air": cfg.hvac.ahu_observes_outside_air,
            "normalization": {k: list(cfg.observation_normalization[k])
                              for k in spec["observation"]["normalization"]},
            "histograms": {k: list(v) for k, v in cfg.histogram_parameters.items()
                           if k in spec["observation"]["histograms"]},
            "hod_features": cfg.num_hod_features, "dow_features": cfg.num_dow_features,
            "occupancy_normalization_constant": cfg.occupancy_normalization_constant},
        "actions": [{"device": d, "field": f,
                     "native": [norms[f].min_native_value, norms[f].max_native_value]}
                    for d, f in cfg.action_tuples],
    }


def stated_by_file(spec: Dict[str, Any]) -> Dict[str, Any]:
    conv = spec["convection"]
    out = {k: spec[k] for k in ("building", "hvac", "schedule", "occupancy", "reward",
                                "start_timestamp", "time_step_sec", "solver",
                                "discount_factor", "observation", "actions")}
    out.update(weather_kind=spec["weather"]["kind"],
               convection_coefficient=spec["weather"]["convection_coefficient"],
               convection={k: conv[k] for k in ("p", "distance", "rounds", "rng")})
    return out


def check_env(spec: Dict[str, Any], env) -> None:
    """Raises unless the program's env runs the configuration the file
    states: its sizes and every value the reference reads."""
    got = {"grid": list(env.geom.shape), "zones": env.n_zones,
           "episode_steps": env.steps_per_episode}
    if got != spec["sizes"]:
        raise ValueError(f"configuration {spec['name']} states {spec['sizes']}, the env has {got}")
    program, stated = stated_by_program(spec, env.config), stated_by_file(spec)
    differ = sorted(k for k in stated if program[k] != stated[k])
    if differ:
        raise ValueError(f"the program's configuration departs from {spec['name']}.json in "
                         f"{differ}")


def oracle_building(spec: Dict[str, Any], device):
    """The reference's building of a configuration file on `device`."""
    from portbench.oracle import building, clock
    from portbench.oracle import step as ostep

    return ostep.Building(spec, building.build(spec),
                          clock.build(spec, episode_steps(spec) + 2), device)


def spectral_radius(spec: Dict[str, Any], b) -> float:
    """The Jacobi map's spectral radius on the reference's grid, for the
    configuration's Chebyshev solve."""
    from portbench.oracle import physics

    return physics.spectral_radius(b.stencil, spec["weather"]["convection_coefficient"])


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the window's work, its end-to-end values,
    the per-layer trace (with --trace 1), the comparisons (name, value,
    limit), the device's peak memory, and, traced, the busy and window
    seconds and the breakdown."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    comparisons: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    trace: Optional[Dict[str, Any]] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict[str, List]] = None


def profiled_window(prof, p0: float, p1: float):
    """A profiled window of calls labelled with LABEL: from the first
    label's start over the host clock's span of the calls and their
    synchronisation, widened to the last device operation's end; None
    where the profiler recorded no device operation."""
    from portbench import yardstick

    w = yardstick.window_from_profile(prof, LABEL, 0.0, 0.0)
    if not w.kernels or not w.labels:
        return None
    w.start_us = min(s for _, s, _ in w.labels)
    w.end_us = max(max(e for _, _, e in w.kernels + w.labels), w.start_us + (p1 - p0) * 1e6)
    return w


class CallSampler:
    """CUDA events around every `every`-th call of a window, for the spread
    of one call's device time (printed to standard error, not a metric)."""

    def __init__(self, cuda: bool, every: int = 64):
        self.cuda, self.every, self.n, self.pairs = cuda, every, 0, []

    def __enter__(self):
        self.pair = None
        if self.cuda and self.n % self.every == 0:
            import torch

            self.pair = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            self.pair[0].record()
        return self

    def __exit__(self, *exc):
        if self.pair is not None:
            self.pair[1].record()
            self.pairs.append(self.pair)
        self.n += 1

    def report(self) -> str:
        """After a synchronise: the sampled calls' device ms."""
        ms = sorted(a.elapsed_time(b) for a, b in self.pairs)
        if not ms:
            return "no sampled calls"
        return (f"device ms per call over {len(ms)} sampled calls: median "
                f"{ms[len(ms) // 2]:.4f}, min {ms[0]:.4f}, max {ms[-1]:.4f}")


def passed(comparisons: Sequence[Tuple[str, float, float]]) -> bool:
    """Every number within its limit (a NaN fails)."""
    return all(value <= limit for _, value, limit in comparisons)


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """The loaded modules (or `modules`) whose top-level name, the part
    before the first dot compared whole, is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def result_line(c: Cell, outcome: Outcome, trace: bool, device_name: str) -> Dict[str, Any]:
    """The contract's JSON object: end-to-end metrics untraced, per-layer
    traced (a reader that finds nothing is left out); the comparisons last."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        for m in c.per_layer:
            value = metric_reader(m["name"])(outcome.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": c.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line: Dict[str, Any] = {
        "correct": passed(outcome.comparisons),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device,
    }
    if trace:
        device.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
        if outcome.breakdown is not None:
            line["breakdown"] = outcome.breakdown
    line["compared"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in outcome.comparisons}
    return line


def print_comparisons(comparisons: Sequence[Tuple[str, float, float]]) -> None:
    for name, value, limit in comparisons:
        verdict = "ok" if value <= limit else "FAILED"
        print(f"compared {name}: {value!r} limit {limit!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()

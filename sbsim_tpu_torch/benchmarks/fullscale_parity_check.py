"""Full-scale (126-room) device-against-host drift over a simulated day; port
of benchmarks/fullscale_parity_check.py.

288 per-env steps (`BuildingEnv.captured_step`, the JAX script's
`jax.jit(env.step)`: a captured program through the CUDA kernel K2 on the
card, the plain version on the CPU) on the deterministic contract
(convection p=0, step-function occupancy, replay weather, setpoints 340 /
285 K) beside the port's ExactHostSimulator, each step held by
exact_host.ParityTracker (max |dT| under its 5e-2 K budget, thermostat
modes equal) with no threshold crossing allowed (`finish(allow_crossings=False)`): the jitted JAX
package's day kept its modes identical throughout. The day runs to its
end either way; the JSON records each step's drift and mode agreement and
where the tracker failed, and the script then exits non-zero.
`--transposed` runs layout="auto" (the 189 x 124 grid the full-scale
bench uses).

Usage:
  python -m sbsim_tpu_torch.benchmarks.fullscale_parity_check [--transposed] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from sbsim_tpu_torch import rng
from sbsim_tpu_torch.benchmarks import card_line
from sbsim_tpu_torch.core.geometry import make_synthetic_office_plan
from sbsim_tpu_torch.envs import exact_host, presets
from sbsim_tpu_torch.envs.building_env import BuildingEnv

PLAN = (9, 14, 12)  # rooms x, rooms y, CVs per room side: 126 zones
STEPS = 288  # a simulated day
LOG_EVERY = 48
SETPOINTS = {
    "supply_water_setpoint": 340.0,
    "supply_air_heating_temperature_setpoint": 285.0,
}
# K: the JAX package's largest drift over the same day, in both layouts
# (artifacts/FULLSCALE_PARITY_r05.json, FULLSCALE_PARITY_r05_transposed.json).
JAX_MAX_DRIFT_K = 0.002197265625


def parity_config(layout: str = "ref", plan=PLAN):
    """sb1_config(num_days_in_episode=1, convection_p=0) on the plan (rooms
    x, rooms y, CVs per side), with step-function occupancy."""
    floor_plan = make_synthetic_office_plan(plan[0], plan[1], room_cvs=plan[2])
    cfg = presets.sb1_config(num_days_in_episode=1, floor_plan=floor_plan, convection_p=0.0,
                             layout=layout)
    return dataclasses.replace(cfg, occupancy=dataclasses.replace(cfg.occupancy,
                                                                  kind="step_function"))


@dataclasses.dataclass
class ParityDay:
    """What parity_day saw: each step's max |dT| and whether the thermostat
    modes were identical; the ParityTracker's report, and the ParityError
    that ended its hold on the day (None: it held every step, no threshold
    crossing) with the step it was raised at; the device state and the
    host at the day's end."""

    drifts: List[float]
    modes_equal: List[bool]
    report: exact_host.ParityReport
    state: Any = None
    host: Any = None
    error: Optional[str] = None
    error_step: Optional[int] = None

    @property
    def held(self) -> bool:
        return self.error is None


def parity_day(env, steps: int = STEPS, log=print) -> ParityDay:
    """`steps` per-env steps of `env` from PRNGKey(0) beside its
    ExactHostSimulator. Each step is held by a ParityTracker (max |dT|
    under its budget, modes equal, a threshold crossing opening a recovery
    window) until it raises; `finish(allow_crossings=False)` then refuses
    any crossing. The day runs to its end either way, and every step's
    drift and mode agreement is recorded."""
    host = exact_host.ExactHostSimulator(env)
    state, _ = env.reset(rng.PRNGKey(0, device=env.device)[None])
    action = torch.as_tensor(env.default_action(SETPOINTS), device=env.device)[None]
    tracker = exact_host.ParityTracker()
    day = ParityDay(drifts=[], modes_equal=[], report=tracker.report, host=host)
    for i in range(steps):
        state, _ = env.captured_step(state, action)
        host.step(SETPOINTS)
        temp = state.temp[0].cpu().numpy()
        modes = state.hvac.thermostat_mode[0].tolist()
        day.drifts.append(float(np.max(np.abs(temp.astype(np.float64) - host.temp))))
        day.modes_equal.append(modes == host.mode)
        if day.held:
            try:
                tracker.check(i, temp, modes, state.hvac.zone_air_temp[0].tolist(), host)
            except exact_host.ParityError as err:
                day.error, day.error_step = str(err), i
        if (i + 1) % LOG_EVERY == 0:
            log(f"step {i + 1}: drift {day.drifts[-1]:.2e} K (max so far {max(day.drifts):.2e})"
                f"{'' if day.held else f'; the tracker failed at step {day.error_step}'}")
    if day.held:
        try:
            tracker.finish(allow_crossings=False)
        except exact_host.ParityError as err:
            day.error, day.error_step = str(err), steps - 1
    day.state = state
    return day


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--transposed", action="store_true",
                   help='layout="auto": the transposed 189 x 124 grid')
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (K2's plain version); without it on the card")
    p.add_argument("--out", default=None,
                   help="default artifacts/FULLSCALE_PARITY_torch[_transposed].json")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    layout = "auto" if args.transposed else "ref"
    env = BuildingEnv(parity_config(layout), device="cpu" if args.cpu else None)
    if env.geom.n_zones != 126:
        raise RuntimeError(f"the plan has {env.geom.n_zones} zones, not 126")
    out = {
        "plan": "9x14 rooms, 12 CVs/side (126 zones)",
        "layout": layout,
        "grid": list(env.geom.shape),
        "steps": STEPS,
        "card": card_line(env.device),
    }
    day = parity_day(env, log=lambda m: print(m, flush=True))
    drifts = day.drifts
    out.update({
        "max_drift_K": max(drifts),
        "final_drift_K": drifts[-1],
        "drift_every_48": [round(d, 6) for d in drifts[LOG_EVERY - 1::LOG_EVERY]],
        "thermostat_modes_identical": all(day.modes_equal),
        "under_convergence_threshold": bool(max(drifts) < 0.1),
        "twelve_zone_budget_for_reference": exact_host.DRIFT_BUDGET,
        "jax_max_drift_K": JAX_MAX_DRIFT_K,
        "held": day.held,
        "threshold_crossings": [[st, list(z), m] for st, z, m in day.report.crossings],
        "parity_error": day.error,
        "parity_error_step": day.error_step,
        "steps_with_modes_differing": day.modes_equal.count(False),
    })
    path = args.out or ("artifacts/FULLSCALE_PARITY_torch_transposed.json"
                        if args.transposed else "artifacts/FULLSCALE_PARITY_torch.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "drift_every_48"}), flush=True)
    print(f"max drift {out['max_drift_K']:.6e} K (the JAX package's day: {JAX_MAX_DRIFT_K:.6e} "
          f"K); wrote {path}", flush=True)
    if not day.held:
        print(f"FAILED: the port left the exact host at step {day.error_step}: {day.error}",
              flush=True)
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()

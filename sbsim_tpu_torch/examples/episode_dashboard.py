"""Render the composite episode dashboard for a simulated day; port of
examples/episode_dashboard.py.

The script form of the reference notebook's live plotting loop
(plot_utils.init_metrics/update_metrics/plot_update, plot_utils.py:441-537):
run the schedule policy for one day on the calibrated building, accumulate
per-step metrics, and write the 3-panel composite (zone-temp timeline over
the setpoint schedule / energy rates / thermal view) every N steps plus at
the end. The env runs on the GPU, each step the env's captured per-env
step (`BuildingEnv.captured_step`, the JAX script's `jax.jit(env.step)`;
its FDM solve the CUDA kernel `fdm_jacobi`); --cpu runs it on the CPU
with the kernel's plain version.
Drawing needs matplotlib; without it, pass --render-every 0 to accumulate
the metrics only.

Usage:
  python -m sbsim_tpu_torch.examples.episode_dashboard --out DIR [--steps 288]
  python -m sbsim_tpu_torch.examples.episode_dashboard --cpu --render-every 0
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any, Callable, Optional, Sequence


@dataclasses.dataclass
class DashboardRun:
    """What a run leaves behind: its env, the dashboard's accumulators, the
    schedule windows and the number of steps run."""

    env: Any
    dashboard: Any
    windows: Any
    steps: int


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sbsim_dashboard"))
    parser.add_argument("--steps", type=int, default=288)
    parser.add_argument("--render-every", type=int, default=72,
                        help="draw every N steps and at the end (needs matplotlib); "
                        "0 draws nothing")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernel's plain version); "
                        "without it the run needs a CUDA device")
    return parser.parse_args(argv)


def main(
    argv: Optional[Sequence[str]] = None,
    on_step: Optional[Callable[[int, Any], None]] = None,
) -> DashboardRun:
    """Runs the day; `on_step(t, state)` sees each step's env state."""
    args = parse_args(argv)
    if args.render_every < 0:
        raise ValueError(f"--render-every must be 0 or more; got {args.render_every}")
    if args.render_every:
        try:
            import matplotlib  # noqa: F401
        except ImportError as err:
            raise ImportError(
                "drawing the dashboard needs matplotlib; pass --render-every 0 "
                "to accumulate the metrics only") from err

    import numpy as np
    import torch

    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.envs import presets
    from sbsim_tpu_torch.envs.building_env import BuildingEnv
    from sbsim_tpu_torch.hvac import devices as hvac_ops
    from sbsim_tpu_torch.io import plots
    from sbsim_tpu_torch.scenario import tables as tables_lib

    cfg = presets.sb1_config(num_days_in_episode=1)
    env = BuildingEnv(cfg, device="cpu" if args.cpu else None)
    dev = env.device
    table = torch.as_tensor(schedule_policy.build_schedule_actions(env), device=dev)
    tables = tables_lib.build_episode_tables(cfg)

    windows = plots.schedule_plot_data(tables, cfg.start_timestamp, cfg.time_step_sec)
    dash = plots.EpisodeDashboard(
        zone_names=env.geom.zone_names,
        start_timestamp=cfg.start_timestamp,
        step_sec=cfg.time_step_sec,
        schedule_windows=windows,
        writedir=args.out,
    )

    os.makedirs(args.out, exist_ok=True)
    state, _ = env.reset(rng.PRNGKey(0, device=dev)[None])
    wall = np.asarray(env.geom.zone_ids) >= env.geom.n_zones
    params = env.hvac_params
    steps = min(args.steps, env.steps_per_episode)
    for t in range(steps):
        act = table[min(t, table.shape[0] - 1)][None]
        state, _ = env.captured_step(state, act)
        hvac = state.hvac
        ambient = float(tables.ambient_temp[min(t + 1, tables.n_steps - 1)])
        amb = torch.tensor([ambient], dtype=torch.float32, device=dev)
        # One host copy per step: the zone means, then the four energy rates.
        host = torch.cat([
            state.zone_means[0],
            hvac_ops.boiler_thermal_energy_rate(hvac, amb, params),
            hvac_ops.boiler_pump_power(hvac, params),
            hvac_ops.ahu_blower_power(hvac, params),
            hvac_ops.ahu_thermal_energy_rate(hvac, state.grid_mean, amb, params),
        ]).cpu().numpy()
        zone_temps, rates = host[:-4], host[-4:]
        dash.update(
            t + 1,
            ambient_temp=ambient,
            zone_temps=zone_temps,
            boiler_thermal=float(rates[0]),
            boiler_electrical=float(rates[1]),
            ahu_fan=float(rates[2]),
            ahu_thermal=float(rates[3]),
        )
        if on_step is not None:
            on_step(t, state)
        if args.render_every and ((t + 1) % args.render_every == 0 or t + 1 == args.steps):
            fig = dash.render(state.temp[0].cpu().numpy(), wall_mask=wall)
            import matplotlib.pyplot as plt

            plt.close(fig)
            print(f"step {t+1}: rendered dashboard frame", flush=True)

    print(f"dashboard frames written to {args.out}", flush=True)
    return DashboardRun(env=env, dashboard=dash, windows=windows, steps=steps)


if __name__ == "__main__":
    main()

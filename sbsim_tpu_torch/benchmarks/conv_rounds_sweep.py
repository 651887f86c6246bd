"""Swap-convection statistical fidelity against the number of rounds; port
of benchmarks/conv_rounds_sweep.py, and the helpers the schedule search
(conv_schedule_search.py) and chip_smoke.py's shuffle12 share.

The swap path (`run_swap`: step_batched at SEEDS envs through the CUDA
kernel K2, `solver="pallas_env"`, the Jacobi solve with the swap rounds in
the kernel; on the CPU its plain version) is scored against the exact
Mersenne-Twister shuffle of the reference (`run_exact`: the port's
ExactHostSimulator, SEEDS convection seeds) by the worst per-zone
two-sample KS statistic and the worst zone-mean difference after N_STEPS
steps, on the 12-zone sb1 plan at rounds 8, 12 and 16, mirroring
tests/test_convection.py::TestSwapVsExactShuffleStatistics. The JAX
script's `use_pallas=False` runs the XLA solver of the config's method
(jacobi); K2 runs the same solve.

Usage:
  python -m sbsim_tpu_torch.benchmarks.conv_rounds_sweep --out CONV_ROUNDS.json
  python -m sbsim_tpu_torch.benchmarks.conv_rounds_sweep --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch

from sbsim_tpu_torch import rng
from sbsim_tpu_torch.benchmarks import card_line
from sbsim_tpu_torch.envs import presets
from sbsim_tpu_torch.envs.building_env import BuildingEnv
from sbsim_tpu_torch.envs.exact_host import ExactHostSimulator

N_STEPS = 36
SEEDS = 4
SWAP_KEY = 42
SETPOINTS = {
    "supply_water_setpoint": 340.0,
    "supply_air_heating_temperature_setpoint": 285.0,
}


def run_swap(cfg, device=None, solver: str = "pallas_env"):
    """SEEDS envs (keys split from PRNGKey(SWAP_KEY)) stepped N_STEPS times
    through `solver` at the SETPOINTS action; returns (their fields as a
    (SEEDS, H, W) numpy stack, the env)."""
    env = BuildingEnv(cfg, device=device)
    action = torch.as_tensor(env.default_action(SETPOINTS), device=env.device)
    action = action[None].expand(SEEDS, -1).contiguous()
    states, _ = env.reset(rng.split(rng.PRNGKey(SWAP_KEY, device=env.device), SEEDS))
    for _ in range(N_STEPS):
        states, _ = env.step_batched(states, action, solver=solver)
    return states.temp.cpu().numpy(), env


def run_exact(cfg, device=None) -> np.ndarray:
    """The exact shuffle: one ExactHostSimulator per convection seed 100 +
    s, N_STEPS steps each; their (SEEDS, H, W) float64 fields."""
    out = []
    for s in range(SEEDS):
        c2 = dataclasses.replace(
            cfg, convection=dataclasses.replace(cfg.convection, seed=100 + s))
        host = ExactHostSimulator(BuildingEnv(c2, device=device))
        for _ in range(N_STEPS):
            host.step(SETPOINTS)
        out.append(host.temp.copy())
    return np.stack(out)


def ks_statistic(x, y) -> float:
    """Two-sample Kolmogorov-Smirnov statistic (scipy.stats.ks_2samp's)."""
    x, y = np.sort(x), np.sort(y)
    both = np.concatenate([x, y])
    cdf_x = np.searchsorted(x, both, side="right") / len(x)
    cdf_y = np.searchsorted(y, both, side="right") / len(y)
    return float(np.max(np.abs(cdf_x - cdf_y)))


def worst_stats(env, a, b, min_std: float = 0.0):
    """Worst-zone two-sample KS and mean shift of `a` against `b`, two
    (runs, H, W) stacks of fields.

    min_std > 0 restricts the KS max to zones whose oracle (b) spread is at
    least that many kelvin (the audited metric of the JAX package's
    round-5 full-scale study): near-isothermal zones make KS compare
    milli-kelvin-wide distributions, where a ~2 mK offset reads as KS
    ~0.5. The mean-shift max always covers every zone.
    """
    zone_ids = np.asarray(env.geom.zone_ids)
    worst_ks, worst_dmean = 0.0, 0.0
    for z in range(env.n_zones):
        m = zone_ids == z
        x, y = a[:, m].ravel(), b[:, m].ravel()
        worst_dmean = max(worst_dmean, abs(float(x.mean()) - float(y.mean())))
        if y.std() >= min_std:
            worst_ks = max(worst_ks, ks_statistic(x, y))
    return worst_ks, worst_dmean


def score_config(cfg, exact, min_std: float = 0.0, device=None):
    """Runs the swap path for `cfg` and scores it against the exact-oracle
    fields; returns (env, worst_zone_ks, worst_zone_dmean), rounded to 4
    digits as the JAX script rounds them."""
    swap, env = run_swap(cfg, device=device)
    ks, dmean = worst_stats(env, swap, exact, min_std=min_std)
    return env, round(float(ks), 4), round(float(dmean), 4)


def base_config(floor_plan=None):
    """sb1_config(num_days_in_episode=1) with step-function occupancy, on
    the default plan or `floor_plan`."""
    base = presets.sb1_config(num_days_in_episode=1, floor_plan=floor_plan)
    return dataclasses.replace(
        base, occupancy=dataclasses.replace(base.occupancy, kind="step_function"))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (K2's plain version); without it on the card")
    p.add_argument("--out", default=None, help="write the rows JSON to this path")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    base = base_config()
    exact = run_exact(base, device=device)
    rows, card = [], None
    for rounds in (8, 12, 16):
        cfg = dataclasses.replace(
            base, convection=dataclasses.replace(base.convection, rounds=rounds))
        env, ks, dmean = score_config(cfg, exact, device=device)
        card = card or card_line(env.device)
        row = dict(rounds=rounds, p_round=env.convection.p_round, worst_zone_ks=ks,
                   worst_zone_dmean_K=dmean)
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"card": card, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    return result


if __name__ == "__main__":
    main()

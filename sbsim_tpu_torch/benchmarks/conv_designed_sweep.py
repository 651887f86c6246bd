"""Designed 8- and 10-round swap schedules against the adopted seeded
10-round one; port of benchmarks/conv_designed_sweep.py.

The seeded schedule search found 8 rounds failing at every seed tried,
while one seeded 10-round schedule (seed 101) beats the 16-round default.
This sweep scores hand-designed compositions through
ConvectionConfig.schedule (balanced diagonals, long axes in both phases,
the winner's long-range motif) exactly as the seeded sweeps are scored
(conv_rounds_sweep.score_config: the swap path through K2 against the
exact shuffle), with the seeded 10-round schedule as the in-sweep control.

Usage:
  python -m sbsim_tpu_torch.benchmarks.conv_designed_sweep [--out PATH]
  python -m sbsim_tpu_torch.benchmarks.conv_designed_sweep --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

from sbsim_tpu_torch.benchmarks import card_line
from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs

OUT = "artifacts/CONV_DESIGNED_torch.json"
CORE = ((0, 1, 0), (1, 0, 0), (0, 1, 1), (1, 0, 1))
DESIGNS = {
    "d8_balanced_diag": CORE + ((1, 1, 0), (1, -1, 1), (2, 1, 0), (2, -1, 1)),
    "d8_long_axes": CORE + ((2, 0, 0), (2, 0, 1), (0, 2, 0), (0, 2, 1)),
    "d8_winner_motif": CORE + ((2, 1, 0), (2, 1, 1), (1, 1, 0), (1, -2, 1)),
    "d8_max_disp": CORE + ((2, 1, 0), (1, 2, 1), (2, -1, 0), (1, -2, 1)),
    "d10_winner_motif": CORE
    + ((2, 1, 0), (2, 1, 1), (1, 1, 0), (1, -2, 1), (2, -1, 0), (1, 2, 1)),
}
CONTROL = ("control_seed101_r10", 10, 101)  # name, rounds, schedule seed


def sweep(base, exact, device=None):
    """The control row, then one row per design, each scored against the
    exact-shuffle fields `exact`; returns (the rows, the last env)."""
    name, rounds, seed = CONTROL
    control = dataclasses.replace(
        base, convection=dataclasses.replace(base.convection, rounds=rounds, seed=seed))
    env, ks, dmean = crs.score_config(control, exact, device=device)
    rows = [dict(name=name, worst_zone_ks=ks, worst_zone_dmean_K=dmean)]
    print(json.dumps(rows[-1]), flush=True)
    for name, sched in DESIGNS.items():
        cfg = dataclasses.replace(
            base, convection=dataclasses.replace(base.convection, schedule=sched))
        env, ks, dmean = crs.score_config(cfg, exact, device=device)
        rows.append(dict(name=name, schedule=[list(s) for s in sched],
                         p_round=env.convection.p_round, worst_zone_ks=ks,
                         worst_zone_dmean_K=dmean))
        print(json.dumps({k: v for k, v in rows[-1].items() if k != "schedule"}),
              flush=True)
    return rows, env


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (K2's plain version); without it on the card")
    p.add_argument("--out", default=OUT)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    base = crs.base_config()
    rows, env = sweep(base, crs.run_exact(base, device), device)
    result = {"card": card_line(env.device), "rows": rows}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    return result


if __name__ == "__main__":
    main()

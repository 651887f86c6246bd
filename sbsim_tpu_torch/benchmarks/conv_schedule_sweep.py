"""Seeded swap schedules of fewer rounds against the 16-round control; port
of benchmarks/conv_schedule_sweep.py.

The default schedule needs 16 rounds to meet the 0.25 worst-zone KS budget
on the 12-zone sb1 plan, but which extra offsets a schedule takes beyond
its 4 core rounds is seeded (ConvectionConfig.seed): schedule composition
is a free variable. Each (rounds, seed) variant is scored as
conv_rounds_sweep.score_config scores (the swap path through K2 against
the exact shuffle), each row with its offsets and per-round swap
probability.

`--variants` ("rounds:seed,..." as the JAX script's CONV_SWEEP_VARIANTS)
and `--out` (a file name under artifacts/, or a path, as its
CONV_SWEEP_OUT) fall back to those environment variables when absent; a
flag wins over its variable.

Usage:
  python -m sbsim_tpu_torch.benchmarks.conv_schedule_sweep [--variants 12:5,12:11]
  python -m sbsim_tpu_torch.benchmarks.conv_schedule_sweep --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

from sbsim_tpu_torch.benchmarks import card_line
from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs

ARTIFACTS = "artifacts"
OUT = "CONV_SCHEDULES_torch.json"
VARIANTS = ((16, 5), (12, 5), (12, 11), (12, 23), (12, 101), (10, 101), (8, 101))


def parse_variants(text: str) -> List[Tuple[int, ...]]:
    """"12:5,12:11" -> [(12, 5), (12, 11)], as the JAX script reads
    CONV_SWEEP_VARIANTS."""
    return [tuple(map(int, v.split(":"))) for v in text.split(",")]


def sweep(base, exact, variants, device=None):
    """One row per (rounds, seed) variant, scored against the exact-shuffle
    fields `exact`; returns (the rows, the last env)."""
    rows, env = [], None
    for rounds, seed in variants:
        cfg = dataclasses.replace(
            base, convection=dataclasses.replace(base.convection, rounds=rounds, seed=seed))
        env, ks, dmean = crs.score_config(cfg, exact, device=device)
        rows.append(dict(rounds=rounds, schedule_seed=seed,
                         offsets=[list(o) for o in env.convection.offsets],
                         p_round=env.convection.p_round, worst_zone_ks=ks,
                         worst_zone_dmean_K=dmean))
        print(json.dumps({k: v for k, v in rows[-1].items() if k != "offsets"}),
              flush=True)
    return rows, env


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (K2's plain version); without it on the card")
    p.add_argument("--variants", default=None,
                   help="rounds:seed,... (default $CONV_SWEEP_VARIANTS, else the seven "
                   "of the JAX script)")
    p.add_argument("--out", default=None,
                   help=f"a file name under {ARTIFACTS}/ or a path (default "
                   f"$CONV_SWEEP_OUT, else {OUT})")
    args = p.parse_args(argv)
    text = args.variants or os.environ.get("CONV_SWEEP_VARIANTS")
    args.variants = parse_variants(text) if text else list(VARIANTS)
    args.out = os.path.join(ARTIFACTS, args.out or os.environ.get("CONV_SWEEP_OUT", OUT))
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    base = crs.base_config()
    rows, env = sweep(base, crs.run_exact(base, device), args.variants, device)
    result = {"card": card_line(env.device), "rows": rows}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    return result


if __name__ == "__main__":
    main()

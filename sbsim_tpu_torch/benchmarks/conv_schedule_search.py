"""Per-plan convection schedule search (a build-time tool); port of
benchmarks/conv_schedule_search.py.

Good swap-round offset schedules are plan-specific. For any floor plan this
scores seeded candidate schedules at the requested round counts against the
bit-exact reference shuffle (conv_rounds_sweep.run_exact) through K2
(conv_rounds_sweep.score_config), reports every schedule that beats the
auto-sized default with its explicit (dy, dx, phase) triples, and with
--write-cache records the winner in the port's schedule cache
(sbsim_tpu_torch/data/conv_schedules.json, through scenario/conv_cache), so
that presets.sb1_config(floor_plan=...) picks it up.

Usage:
  python -m sbsim_tpu_torch.benchmarks.conv_schedule_search
  python -m sbsim_tpu_torch.benchmarks.conv_schedule_search --rooms-x 2 --rooms-y 6 \\
      --room-cvs 16 --rounds 10 12 --seeds 5 11 23 47 101 --out CONV_SEARCH_myplan.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

from sbsim_tpu_torch.benchmarks import card_line
from sbsim_tpu_torch.benchmarks.conv_rounds_sweep import base_config, run_exact, score_config
from sbsim_tpu_torch.core.geometry import make_synthetic_office_plan
from sbsim_tpu_torch.scenario import conv_cache


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--rooms-x", type=int, default=3)
    p.add_argument("--rooms-y", type=int, default=4)
    p.add_argument("--room-cvs", type=int, default=14)
    p.add_argument("--rounds", type=int, nargs="+", default=[10, 12])
    p.add_argument("--seeds", type=int, nargs="+", default=[5, 11, 23, 47, 101])
    p.add_argument("--budget", type=float, default=0.25,
                   help="worst-zone KS acceptance budget (tests/test_convection.py)")
    p.add_argument("--spread-floor", type=float, default=0.0,
                   help="restrict the KS max to zones with oracle spread >= this many K "
                   "(the audited metric; 0.02 recommended for large buildings whose "
                   "center zones are near-isothermal)")
    p.add_argument("--out", default=None)
    p.add_argument("--write-cache", action="store_true",
                   help="record the winner in sbsim_tpu_torch/data/conv_schedules.json so "
                   "presets.sb1_config(floor_plan=...) picks it up automatically")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (K2's plain version); without it on the card")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    plan = make_synthetic_office_plan(args.rooms_x, args.rooms_y, room_cvs=args.room_cvs)
    base = base_config(floor_plan=plan)
    exact = run_exact(base, device=device)

    # The auto-sized default is the bar to beat.
    env0, ks0, dmean0 = score_config(base, exact, min_std=args.spread_floor, device=device)
    auto_rounds = len(env0.convection.offsets)
    print(json.dumps({"candidate": "auto_default", "rounds": auto_rounds,
                      "worst_zone_ks": ks0, "worst_zone_dmean_K": dmean0}), flush=True)
    rows = [dict(candidate="auto_default", rounds=auto_rounds, worst_zone_ks=ks0,
                 worst_zone_dmean_K=dmean0)]
    best = None
    for rounds in args.rounds:
        for seed in args.seeds:
            cfg = dataclasses.replace(
                base, convection=dataclasses.replace(base.convection, rounds=rounds, seed=seed))
            env, ks, dmean = score_config(cfg, exact, min_std=args.spread_floor, device=device)
            row = dict(
                candidate=f"r{rounds}_s{seed}",
                rounds=rounds,
                seed=seed,
                worst_zone_ks=ks,
                worst_zone_dmean_K=dmean,
                beats_auto=bool(ks < ks0),
                within_budget=bool(ks <= args.budget),
                offsets=[list(o) for o in env.convection.offsets],
            )
            rows.append(row)
            print(json.dumps({k: v for k, v in row.items() if k != "offsets"}), flush=True)
            if row["within_budget"] and (
                best is None or rounds < best["rounds"]
                or (rounds == best["rounds"] and ks < best["worst_zone_ks"])
            ):
                best = row
    verdict = {
        "plan": f"{args.rooms_x}x{args.rooms_y} rooms, {args.room_cvs} CVs/side",
        "auto_default_ks": ks0,
        "recommendation": (
            best["candidate"] if best and (
                best["rounds"] < auto_rounds or best["worst_zone_ks"] < ks0
            ) else "auto_default"
        ),
    }
    print(json.dumps(verdict), flush=True)
    result = {"card": card_line(env0.device), "verdict": verdict, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    if args.write_cache and verdict["recommendation"] != "auto_default":
        key = conv_cache.record(
            plan,
            rounds=best["rounds"],
            seed=best["seed"],
            worst_zone_ks=best["worst_zone_ks"],
            worst_zone_dmean_k=best["worst_zone_dmean_K"],
            plan_desc=verdict["plan"],
            source=args.out or "conv_schedule_search run",
        )
        result["cache_key"] = key
        print(json.dumps({"cache_key": key, **best}), flush=True)
    return result


if __name__ == "__main__":
    main()

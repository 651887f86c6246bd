"""The null calibration of swap-convection fidelity at full scale; port of
benchmarks/conv_fullscale_null.py.

The full-scale schedule search found no candidate inside the worst-zone KS
budget calibrated at 12 zones. Before that reads as a fidelity failure,
the nulls at this scale are measured on the 126-room plan
(make_synthetic_office_plan(9, 14, room_cvs=12)):

  * exact_vs_exact: two exact-shuffle host runs (convection seeds 100-103
    and 200-203): the distance chaos and finite samples give under the
    reference's own semantics;
  * swap_vs_swap: two swap-path draws (reset keys split from PRNGKey(42)
    and PRNGKey(1042)): the same-method null of the device path;
  * swap_vs_exact_auto: the score itself, the first draw against the first
    exact run.

Both swap draws go through the CUDA kernel K2 (`solver="pallas_env"`, its
plain version with --cpu); the JAX script's `use_pallas=False` is the XLA
Jacobi solve of the same method, which K2 runs. The 126-room grid (23,436
cells) fits K2's unstaged launch; a plan above its shared-memory budget is
refused by the kernel's wrapper.

Usage:
  python -m sbsim_tpu_torch.benchmarks.conv_fullscale_null [--rooms-x 9 --rooms-y 14]
  python -m sbsim_tpu_torch.benchmarks.conv_fullscale_null --cpu --rooms-x 2 --rooms-y 2
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from sbsim_tpu_torch.benchmarks import card_line
from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
from sbsim_tpu_torch.core.geometry import make_synthetic_office_plan

OUT = "artifacts/CONV_FULLSCALE_NULL_torch.json"
EXACT_SEED_BASES = (100, 200)
SWAP_KEYS = (crs.SWAP_KEY, 1042)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--rooms-x", type=int, default=9)
    p.add_argument("--rooms-y", type=int, default=14)
    p.add_argument("--room-cvs", type=int, default=12)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (K2's plain version); without it on the card")
    p.add_argument("--out", default=OUT)
    return p.parse_args(argv)


def _stats(env, a, b) -> dict:
    ks, dmean = crs.worst_stats(env, a, b)
    return {"worst_zone_ks": float(ks), "worst_zone_dmean_K": float(dmean)}


def _line(head: dict, stats: dict) -> str:
    return json.dumps({**head, **{k: round(v, 4) for k, v in stats.items()}})


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    plan = make_synthetic_office_plan(args.rooms_x, args.rooms_y, room_cvs=args.room_cvs)
    base = crs.base_config(plan)

    swap_a, env = crs.run_swap(base, device, key=SWAP_KEYS[0])
    exact_a, exact_b = (crs.run_exact(base, device, seed_base=b) for b in EXACT_SEED_BASES)
    result = {
        "plan": f"{args.rooms_x}x{args.rooms_y} rooms, {args.room_cvs} CVs/side",
        "card": card_line(env.device),
        "exact_vs_exact": _stats(env, exact_a, exact_b),
    }
    print(_line({"null": "exact_vs_exact"}, result["exact_vs_exact"]), flush=True)
    swap_b, _ = crs.run_swap(base, device, key=SWAP_KEYS[1])
    result["swap_vs_swap"] = _stats(env, swap_a, swap_b)
    print(_line({"null": "swap_vs_swap"}, result["swap_vs_swap"]), flush=True)
    result["swap_vs_exact_auto"] = _stats(env, swap_a, exact_a)
    print(_line({"score": "swap_vs_exact (auto default)"}, result["swap_vs_exact_auto"]),
          flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()

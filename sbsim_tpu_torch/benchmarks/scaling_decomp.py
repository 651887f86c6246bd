"""Decomposition of a scaling falloff into four taxes; port of
benchmarks/scaling_decomp.py.

The scaling harness (scaling.py) reports per-rank throughput at N ranks
against one. This script breaks the loss into parts measured at the same
configuration (sb1_config(num_days_in_episode=2), the schedule-policy
actions, batch-per-device envs per rank):

  plain_1dev_b{bpd}          the plain rollout, one process, bpd envs (the baseline row)
  shardmap_1dev_b{bpd}       the per-rank program on a one-rank group, bpd envs
                             (the wrapper tax alone)
  plain_1dev_big             the plain rollout, one process, bpd x N envs (the same
                             total work in one program: the shared-host control)
  shardmap_ndev_big          the per-rank program at N ranks (the falloff row itself)
  shardmap_ndev_big_nopmean  the same without the reward's all-reduce (collective cost)

Attribution, by the JAX script's formulas:
  naive_efficiency  = (shardmap_ndev_big / N) / plain_1dev_b{bpd}
  wrapper_tax       = 1 - shardmap_1dev_b{bpd} / plain_1dev_b{bpd}
  core_sharing_tax  = 1 - (plain_1dev_big / N) / plain_1dev_b{bpd}
  partition_tax     = 1 - shardmap_ndev_big / plain_1dev_big
  collective_share  = (shardmap_ndev_big_nopmean - shardmap_ndev_big) / shardmap_ndev_big

Every row is spawned as scaling.py spawns its rows (`--backend nccl`: rank
r on card r; `gloo`: every rank on the one card, or with --cpu on the
CPU), timed warm between barriers with CUDA events (the best and the
median of --repeats calls of --steps steps), and its gathered states must
equal one process's step_batched bitwise, or the script exits non-zero.
torch has no shard_map: the per-rank program is
mesh.make_shardmapped_rollout, and the program it runs without a group
(no collective) is both the plain rollout and the no-pmean variant. Under
nccl every row is a captured program, under gloo every row runs op by op
(distributed/mesh.py's rule). More ranks than cards under nccl are
refused.

Usage:
  python -m sbsim_tpu_torch.benchmarks.scaling_decomp --ranks 2 --backend gloo
  python -m sbsim_tpu_torch.benchmarks.scaling_decomp --cpu --ranks 2 --batch-per-device 2
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Sequence

import torch

from sbsim_tpu_torch.benchmarks import card_line, scaling


def plain_rollout(env, mesh, actions_table, n_steps, solver="auto"):
    """The per-rank program without the reward's all-reduce: each rank
    steps its rows and returns its own mean reward. Captured or op by op by
    the rank's mesh, as its make_shardmapped_rollout, so that every row of
    a job runs the same way."""
    from sbsim_tpu_torch.distributed import mesh as mesh_lib

    return mesh_lib.make_shardmapped_rollout(env, mesh, actions_table, n_steps, solver=solver,
                                             pmean=False)


def attribution(rates: dict, n: int, bpd: int) -> dict:
    """The JAX script's attribution of the falloff from the five rates."""
    plain = rates[f"plain_1dev_b{bpd}"]
    big, shard = rates["plain_1dev_big"], rates["shardmap_ndev_big"]
    return {
        "naive_efficiency": round((shard / n) / plain, 3),
        "wrapper_tax": round(1 - rates[f"shardmap_1dev_b{bpd}"] / plain, 3),
        "core_sharing_tax": round(1 - (big / n) / plain, 3),
        "partition_tax": round(1 - shard / big, 3),
        "collective_share": round((rates["shardmap_ndev_big_nopmean"] - shard) / shard, 3),
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--batch-per-device", type=int, default=64)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--solver", default="auto")
    p.add_argument("--out", default=None)
    p.add_argument("--ranks", "--devices", dest="ranks", type=int, default=None,
                   help="N, the ranks of the ndev rows (default: the cards under nccl, 2 "
                   "under gloo)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="nccl (the default on the card): rank r on card r; gloo: every rank "
                   "on the one card (or the CPU)")
    p.add_argument("--cpu", action="store_true",
                   help="ranks on the CPU over gloo; without it on the card")
    args = p.parse_args(argv)
    if args.repeats < 1:
        p.error("--repeats must be at least 1")
    if args.backend is None:
        args.backend = "gloo" if args.cpu else "nccl"
    if args.cpu and args.backend == "nccl":
        p.error("--cpu runs the ranks over gloo")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("the scaling decomposition runs on CUDA devices and none is "
                           "available; pass --cpu to run its ranks on the CPU")
    n = args.ranks
    if n is None:
        n = torch.cuda.device_count() if args.backend == "nccl" else 2
    if args.backend == "nccl" and n > torch.cuda.device_count():
        raise RuntimeError(f"{n} NCCL ranks need {n} cards; {torch.cuda.device_count()} "
                           "present (gloo puts every rank on one card)")
    bpd = args.batch_per_device
    # (row, ranks, envs per rank, per-rank program; None: make_shardmapped_rollout)
    specs = ((f"plain_1dev_b{bpd}", 1, bpd, plain_rollout),
             (f"shardmap_1dev_b{bpd}", 1, bpd, None),
             ("plain_1dev_big", 1, bpd * n, plain_rollout),
             ("shardmap_ndev_big", n, bpd, None),
             ("shardmap_ndev_big_nopmean", n, bpd, plain_rollout))
    rates, medians, rows = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ranks, per_rank, make_rollout in specs:
            row_args = argparse.Namespace(**{**vars(args), "batch_per_device": per_rank,
                                             "full_scale": False})
            row = scaling.run_row(row_args, ranks, os.path.join(tmp, name), make_rollout)
            rates[name] = row["env_steps_per_sec"]
            medians[name] = row["median_env_steps_per_sec"]
            rows[name] = row
            print(name, rates[name], flush=True)
    payload = {
        "platform": "cpu" if args.cpu else "gpu",
        "card": card_line("cpu" if args.cpu else "cuda:0"),
        "backend": args.backend,
        "n_devices": n,
        "batch_per_device": bpd,
        "steps": args.steps,
        "repeats": args.repeats,
        "solver": args.solver,
        "rates_env_steps_per_s": rates,
        "median_env_steps_per_s": medians,
        "attribution": attribution(rates, n, bpd),
        "rows": rows,
    }
    print(json.dumps({k: v for k, v in payload.items() if k != "rows"}, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
    return payload


if __name__ == "__main__":
    main()

"""Scaling harness: env-steps/s of the batched rollout at 1 / N ranks; port
of benchmarks/scaling.py.

Each row runs `--devices` ranks (spawned processes joined by a process
group: NCCL with one card per rank, or gloo when asked for, all ranks on
the one card or, with --cpu, on the CPU), each stepping its block of a
batch of batch-per-device x ranks envs of the calibrated building through
distributed/mesh.make_shardmapped_rollout with the schedule-policy
actions. Each rank resets its rows from the global key split, makes one
untimed call on a copy of them, then `--repeats` timed calls, each fenced
by a barrier and CUDA events (the host clock after a synchronize on the
CPU). A repeat's rate is batch x steps over the slowest rank's time; the
row reports the best, as the JAX script does, and the median. After the
timed calls the gathered rows must equal one process's step_batched over
the same steps bitwise, or the script exits non-zero.

Deviation from the JAX script: torch has no GSPMD partitioner, so every
row is the per-rank program of make_shardmapped_rollout, the JAX script's
`--shard-map` mode; the flag is accepted and changes nothing. Under nccl
that program is captured (a CUDA graph, the JAX script's jit), under gloo
it runs op by op (distributed/mesh.py's rule).

Usage:
  python -m sbsim_tpu_torch.benchmarks.scaling --devices 1 2 4 --batch-per-device 512
  python -m sbsim_tpu_torch.benchmarks.scaling --devices 1 2 --backend gloo
  python -m sbsim_tpu_torch.benchmarks.scaling --cpu --devices 1 2 --batch-per-device 2
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

TIMEOUT = 600.0  # seconds: a row's deadline, and its collectives'


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--devices", "--ranks", dest="devices", type=int, nargs="+",
                   default=[1, 2, 4, 8], help="the rank counts, one row each")
    p.add_argument("--batch-per-device", type=int, default=128)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--cpu", action="store_true",
                   help="ranks on the CPU over gloo; without it on the card")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="nccl (the default on the card): rank r on card r; gloo: every rank "
                   "on the one card (or the CPU)")
    p.add_argument("--full-scale", action="store_true")
    p.add_argument("--out", default=None, help="write results JSON to this path")
    p.add_argument("--shard-map", action="store_true",
                   help="accepted: every row runs the per-rank shard-map program")
    p.add_argument("--solver", default="pallas_cheby", help="FDM path per rank")
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    if args.repeats < 1:
        p.error("--repeats must be at least 1")
    if args.backend is None:
        args.backend = "gloo" if args.cpu else "nccl"
    if args.cpu and args.backend == "nccl":
        p.error("--cpu runs the ranks over gloo")
    return args


def make_env(full_scale: bool, device):
    from sbsim_tpu_torch.core.geometry import make_synthetic_office_plan
    from sbsim_tpu_torch.envs import presets
    from sbsim_tpu_torch.envs.building_env import BuildingEnv

    floor_plan = make_synthetic_office_plan(9, 14, room_cvs=12) if full_scale else None
    return BuildingEnv(presets.sb1_config(num_days_in_episode=2, floor_plan=floor_plan),
                       device=device)


def rows_of(states) -> dict:
    """Every field of an EnvState batch as a numpy array, by "/"-joined path."""
    from sbsim_tpu_torch import convert

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, np.asarray(v)

    return dict(leaves(convert.env_state_to_numpy(states)))


def _rank_device(args, rank: int) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if args.backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", 0)


def rank_main(rank: int, world: int, args, out: str, make_rollout=None) -> None:
    """One rank of a row: joins the group (a FileStore under `out`), runs
    the warm-up and the timed calls on its rows, writes its times and
    launches to out/rank{rank}.json and, on rank 0, the gathered rows.
    `make_rollout` builds the per-rank program from (env, mesh, actions
    table, steps, solver=...); default mesh.make_shardmapped_rollout."""
    import torch.distributed as dist

    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.distributed import mesh as mesh_lib
    from sbsim_tpu_torch.distributed import runtime
    from sbsim_tpu_torch.physics import fdm_cuda

    if args.cpu:
        torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    runtime.initialize(backend=args.backend, init_method=f"file://{out}/store",
                       world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        device = _rank_device(args, rank)
        env = make_env(args.full_scale, device)
        mesh = mesh_lib.make_mesh()
        batch = args.batch_per_device * world
        keys = rng.split(rng.PRNGKey(0, device=device), batch)
        rows = slice(rank * args.batch_per_device, (rank + 1) * args.batch_per_device)
        states, _ = env.reset(keys[rows])
        roll = (make_rollout or mesh_lib.make_shardmapped_rollout)(
            env, mesh, schedule_policy.build_schedule_actions(env), args.steps,
            solver=args.solver)
        cuda = device.type == "cuda"
        fdm_cuda.reset_launch_counts()
        roll(env.reset(keys[rows])[0])  # untimed, on a copy of the rows: the first call
        times = []
        for _ in range(args.repeats):
            if cuda:
                torch.cuda.synchronize(device)
            dist.barrier()
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            states, reward = roll(states)
            if cuda:
                end.record()
                torch.cuda.synchronize(device)
                times.append(start.elapsed_time(end))
            else:
                times.append((time.perf_counter() - t0) * 1e3)
            dist.barrier()
        launches = dict(fdm_cuda.launch_counts)
        whole = rows_of(mesh_lib.gather_rows(states, mesh))
        if rank == 0:
            np.savez(f"{out}/rows.npz", **whole)
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump({"ms": times, "launches": launches, "reward": float(reward),
                       "device": str(device)}, f)
    finally:
        runtime.shutdown()


def one_process(args, batch: int, device):
    """The rows one process's step_batched gives over the same steps."""
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import schedule_policy

    env = make_env(args.full_scale, device)
    table = torch.as_tensor(schedule_policy.build_schedule_actions(env), device=env.device)
    states, _ = env.reset(rng.split(rng.PRNGKey(0, device=env.device), batch))
    for _ in range(args.repeats * args.steps):
        act = table[torch.clamp(states.step_idx.long(), 0, table.shape[0] - 1)]
        states, _ = env.step_batched(states, act, solver=args.solver)
    return rows_of(states)


def run_row(args, n: int, tmp: str, make_rollout=None) -> Optional[dict]:
    """One row at n ranks, each running `make_rollout`'s program (see
    rank_main); None when there are fewer cards than ranks."""
    from sbsim_tpu_torch.distributed import runtime

    if not args.cpu and args.backend == "nccl" and n > torch.cuda.device_count():
        print(f"skipping {n} devices (only {torch.cuda.device_count()} present)", flush=True)
        return None
    out = os.path.join(tmp, f"ranks{n}")
    os.makedirs(out)
    t0 = time.time()
    runtime.spawn(rank_main, n, (args, out, make_rollout), timeout=TIMEOUT)
    ranks = []
    for r in range(n):
        with open(f"{out}/rank{r}.json") as f:
            ranks.append(json.load(f))
    batch = args.batch_per_device * n
    with np.load(f"{out}/rows.npz") as got:
        want = one_process(args, batch, "cpu" if args.cpu else "cuda:0")
        differ = sorted(k for k in want if not np.array_equal(
            got[k], want[k], equal_nan=want[k].dtype.kind == "f"))
    if differ:
        print(f"FAILED: {n} ranks' rows differ from one process's step_batched in {differ}",
              flush=True)
        raise SystemExit(1)
    slowest = [max(r["ms"][i] for r in ranks) for i in range(args.repeats)]
    rates = [batch * args.steps / (ms / 1e3) for ms in slowest]
    for rep, rate in enumerate(rates):
        print(f"  rep {rep}: {rate:.0f} env-steps/s", flush=True)
    best = max(rates)
    return {
        "devices": n,
        "batch": batch,
        "env_steps_per_sec": round(best, 1),
        "median_env_steps_per_sec": round(statistics.median(rates), 1),
        "per_device": round(best / n, 1),
        "slowest_rank_ms": slowest,
        "rank_ms": [r["ms"] for r in ranks],
        "launches": [r["launches"] for r in ranks],
        "rank_devices": [r["device"] for r in ranks],
        "bitwise_one_process": True,
        "seconds_with_start_up": round(time.time() - t0, 1),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    from sbsim_tpu_torch.benchmarks import card_line

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("the scaling harness runs on CUDA devices and none is available; "
                           "pass --cpu to run its ranks on the CPU")
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in args.devices:
            row = run_row(args, n, tmp)
            if row is not None:
                results.append(row)
                print(json.dumps({k: row[k] for k in ("devices", "batch", "env_steps_per_sec",
                                                      "median_env_steps_per_sec",
                                                      "per_device")}), flush=True)
    summary = None
    if len(results) >= 2:
        eff = (results[-1]["per_device"] / results[0]["per_device"]
               if results[0]["per_device"] else 0.0)
        summary = {"metric": "scaling_efficiency", "value": round(eff, 3),
                   "from_devices": results[0]["devices"], "to_devices": results[-1]["devices"]}
        print(json.dumps(summary), flush=True)
    payload = {
        "platform": "cpu" if args.cpu else "gpu",
        "card": card_line("cpu" if args.cpu else "cuda:0"),
        "backend": args.backend,
        "solver": args.solver,
        "mode": "shard_map",
        "batch_per_device": args.batch_per_device,
        "steps": args.steps,
        "repeats": args.repeats,
        "full_scale": bool(args.full_scale),
        "results": results,
        "summary": summary,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
    return payload


if __name__ == "__main__":
    main()

"""Throughput bench: env-steps/s of the batched env step on the calibrated
building; port of bench.py.

    python -m sbsim_tpu_torch.bench                          # 12 zones, B=2048, on the card
    python -m sbsim_tpu_torch.bench --full-scale             # 126 rooms, B=512
    python -m sbsim_tpu_torch.bench --solver pallas_env      # K2 in place of K1
    python -m sbsim_tpu_torch.bench --cpu --batch 4 --steps 4 --max-repeats 2

It builds the JAX bench's env (`sb1_config(num_days_in_episode=2)`; with
`--full-scale` the 126-room plan, `layout="auto"` set after the preset, so
the interleave width stays the reference orientation's), resets the batch
from `rng.split(rng.PRNGKey(0), batch)` and steps it with the schedule
policy's action table for `--steps` steps per call (`make_rollout`: on the
card one captured CUDA graph, graphs.py, as the JAX bench jits its scan).
Before timing, one step of the timed solver is held against `xla_jacobi`
on the fresh states with zero actions (max |dT| < 0.8 K for the Chebyshev
paths, else 1e-2 K; max |d reward| < 1e-3). Then one untimed call (it builds the
kernels and captures the rollout, as the JAX script's first call compiles
it), and timed calls under the JAX script's plateau rule: at least
`--min-repeats` (and 5), at most `--max-repeats`, stopping once the best
has not grown by more than 1% over the last 4, or when `--budget-sec` has
passed. Each call is timed by a pair of CUDA events (the host clock on the
CPU). The states carry on from call to call and are never reset, so the
steps run past the episode's end: the env's tables clamp the step there
as the JAX package's do.

Prints ONE JSON line: the JAX script's keys (`metric`, `value` = `best`,
`unit`, `median`, `solver`, `batch`, `weather`, `repeats`, `plateaued`)
without `vs_baseline` and `median_vs_baseline` (their target is a TPU pod's
per-chip share), and with `card` (nvidia-smi's name and power limit, "cpu"
on the CPU), `timing` ("cuda_events" or "host_clock") and `solver_check`
(its figures, limits and verdict).

Deviations from the JAX script, deliberate: no device probe and no quiet
CPU fallback (without `--cpu` the bench needs a card, else it exits 1); no
fallback between solvers (`auto` is "pallas_cheby" on the card,
"xla_jacobi" with `--cpu` or `--no-pallas`; a failed solver check prints
its line and exits 1, and a kernel's or a capture's error propagates,
with no eager rerun); `median` is `statistics.median`, not the upper
middle element.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from sbsim_tpu_torch import graphs
from sbsim_tpu_torch.utils import profiling

SOLVERS = ("auto", "pallas_env", "pallas_cheby", "xla_jacobi", "xla_chebyshev")
CPU_BATCH_CAP = 64  # bench.py:108
CHEBY_TEMP_TOL = 0.8  # K, bench.py:171
TEMP_TOL = 1e-2  # K
REWARD_TOL = 1e-3


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=None,
                   help="env batch; default 2048 (12 zones) / 512 (--full-scale)")
    p.add_argument("--steps", type=int, default=64, help="env steps per timed call")
    p.add_argument("--min-repeats", type=int, default=6,
                   help="minimum timed repeats before the plateau rule can stop")
    p.add_argument("--max-repeats", type=int, default=20, help="hard cap on timed repeats")
    p.add_argument("--budget-sec", type=float, default=60.0,
                   help="wall-clock budget for the timed repeats")
    p.add_argument("--no-pallas", action="store_true",
                   help="auto picks xla_jacobi, the plain batched solver")
    p.add_argument("--solver", default="auto", choices=SOLVERS,
                   help="FDM path; auto = pallas_cheby on the card, xla_jacobi on the CPU")
    p.add_argument("--cpu", "--force-cpu", dest="cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions); without it on the card")
    p.add_argument("--full-scale", action="store_true",
                   help="126-room building matching the real sb1 device count")
    args = p.parse_args(argv)
    if args.steps < 1 or args.max_repeats < 1:
        p.error("--steps and --max-repeats must be at least 1")
    return args


def bench_config(full_scale: bool):
    """The JAX bench's env config (bench.py:109-127)."""
    from sbsim_tpu_torch.core.geometry import make_synthetic_office_plan
    from sbsim_tpu_torch.envs import presets

    # The recorded sb1 telemetry shows 126 VAV zones.
    floor_plan = make_synthetic_office_plan(9, 14, room_cvs=12) if full_scale else None
    cfg = presets.sb1_config(num_days_in_episode=2, floor_plan=floor_plan)
    if full_scale:
        # After the preset, as the JAX bench does: pallas_block_envs keeps
        # the reference orientation's width.
        cfg = dataclasses.replace(
            cfg, building=dataclasses.replace(cfg.building, layout="auto"))
    return cfg


def bench_batch(batch: Optional[int], full_scale: bool, cpu: bool) -> int:
    if batch is None:
        batch = 512 if full_scale else 2048
    return min(batch, CPU_BATCH_CAP) if cpu else batch


def pick_solver(solver: str, cpu: bool, no_pallas: bool) -> str:
    """The one solver the bench runs: an explicit name, else pallas_cheby
    on the card and xla_jacobi with --cpu or --no-pallas. No fallback."""
    if solver != "auto":
        return solver
    return "xla_jacobi" if cpu or no_pallas else "pallas_cheby"


def make_rollout(env, actions, n_steps: int, solver: str) -> Callable:
    """rollout(states) -> (states, mean reward): `n_steps` step_batched
    calls, each env taking the action table's row at its own step (clamped
    into the table). The rewards stay on the device; nothing in the loop
    waits for it. On the card the whole call is one captured program
    (graphs.capture, the counterpart of bench.py:146's `jax.jit`), captured
    at its first call; its `fn` is the rollout op by op. The states it
    returns are fresh tensors, bitwise the eager rollout's. Traced, each
    call adds the returned states' FDM iterations (the call's last step) to
    the counter `fdm.iterations`, kept on the device and summed when read,
    and their number to `env.steps`; where the solve runs on thread-block
    clusters (a plan that spans blocks), the same step's barrier counts
    (`StepOutput.fdm_barriers`, the program's third output, None on other
    plans) to `fdm.barriers`. `call.eager` is the rollout op by op, and
    `call.programs` the captured function's."""
    table = torch.tensor(np.asarray(actions), dtype=torch.float32, device=env.device)
    last = table.shape[0] - 1

    def rollout(states):
        rewards = []
        for _ in range(n_steps):
            act = table[states.step_idx.to(torch.int64).clamp(0, last)]
            states, out = env.step_batched(states, act, solver=solver)
            rewards.append(out.reward)
        return states, torch.stack(rewards).mean(), out.fdm_barriers

    captured = graphs.capture(rollout)

    def call(states):
        states, mean, barriers = captured(states)
        profiling.count_tensor("fdm.iterations", states.fdm_iterations)
        if barriers is not None:
            profiling.count_tensor("fdm.barriers", barriers)
        profiling.count("env.steps", states.fdm_iterations.shape[0])
        return states, mean

    call.eager = lambda states: captured.eager(states)[:2]
    call.programs = captured.programs
    return call


def solver_check(env, states, solver: str) -> dict:
    """One step of `solver` against xla_jacobi from `states` with zero
    actions (bench.py:148-184): max |dT| and max |d reward| and their
    limits. A kernel's error propagates."""
    acts = torch.zeros(states.temp.shape[0], env.n_actions, device=env.device)
    sp, op = env.step_batched(states, acts, solver=solver)
    sx, ox = env.step_batched(states, acts, solver="xla_jacobi")
    d_temp = float((sp.temp - sx.temp).abs().max())
    d_reward = float((op.reward - ox.reward).abs().max())
    temp_tol = CHEBY_TEMP_TOL if "cheby" in solver else TEMP_TOL
    return {
        "max_abs_dtemp": d_temp,
        "temp_limit": temp_tol,
        "max_abs_dreward": d_reward,
        "reward_limit": REWARD_TOL,
        # NaN compares False: a NaN field fails.
        "passed": bool(d_temp < temp_tol and d_reward < REWARD_TOL),
    }


def time_call(rollout, states, cuda: bool):
    """(states, ms) of one rollout call: CUDA events around it on the card,
    the host clock after it on the CPU."""
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        states, _ = rollout(states)
        end.record()
        end.synchronize()
        return states, start.elapsed_time(end)
    t0 = time.perf_counter()
    states, _ = rollout(states)
    return states, (time.perf_counter() - t0) * 1e3


def repeat_until_plateau(run_once: Callable[[], float], min_repeats: int,
                         max_repeats: int, budget_sec: float,
                         clock: Callable[[], float] = time.perf_counter) -> List[float]:
    """The JAX bench's stabilization rule (bench.py:217-232): rates from
    `run_once` until the best has not improved by more than 1% over the
    trailing 4 (at least max(min_repeats, 5)), at most `max_repeats`; the
    budget is checked before every repeat, and one always runs."""
    reps: List[float] = []
    t_start = clock()
    while len(reps) < max_repeats:
        if reps and clock() - t_start > budget_sec:
            break
        reps.append(run_once())
        if len(reps) >= max(min_repeats, 5) and max(reps) <= max(reps[:-4]) * 1.01:
            break
    return reps


def summarize(reps: Sequence[float]) -> dict:
    """best, the true median and whether the trailing 4 plateaued
    (bench.py:233-235, with statistics.median for its upper middle)."""
    reps = list(reps)
    return {
        "best": max(reps),
        "median": float(statistics.median(reps)),
        "plateaued": len(reps) >= 5 and max(reps[-4:]) <= max(reps[:-4]) * 1.01,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("the bench runs on a CUDA device and none is available; pass --cpu to run "
              "the plain versions on the CPU", file=sys.stderr, flush=True)
        return 1
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.benchmarks import card_line
    from sbsim_tpu_torch.envs.building_env import BuildingEnv

    device = torch.device("cpu" if args.cpu else "cuda")
    cuda = device.type == "cuda"
    batch = bench_batch(args.batch, args.full_scale, args.cpu)
    env = BuildingEnv(bench_config(args.full_scale), device=device)
    actions = schedule_policy.build_schedule_actions(env)
    states0, _ = env.reset(rng.split(rng.PRNGKey(0, device=device), batch))
    solver = pick_solver(args.solver, args.cpu, args.no_pallas)
    check = solver_check(env, states0, solver)
    line = {
        "metric": "env_steps_per_sec_single_chip",
        "value": None,
        "unit": "env-steps/s (cpu)" if args.cpu else "env-steps/s",
        "best": None,
        "median": None,
        "solver": solver,
        "batch": batch,
        "weather": env.config.weather.kind,
        "repeats": [],
        "plateaued": False,
        "card": card_line(device),
        "timing": "cuda_events" if cuda else "host_clock",
        "solver_check": check,
    }
    if not check["passed"]:
        print(json.dumps(line), flush=True)
        return 1
    rollout = make_rollout(env, actions, args.steps, solver)
    states, _ = rollout(states0)  # untimed: builds the kernels, captures the rollout
    if cuda:
        torch.cuda.synchronize(device)

    def run_once() -> float:
        nonlocal states
        states, ms = time_call(rollout, states, cuda)
        return batch * args.steps / (ms / 1e3)

    reps = repeat_until_plateau(run_once, args.min_repeats, args.max_repeats, args.budget_sec)
    summary = summarize(reps)
    line.update(
        value=round(summary["best"], 1),
        best=round(summary["best"], 1),
        median=round(summary["median"], 1),
        repeats=[round(r, 1) for r in reps],
        plateaued=summary["plateaued"],
    )
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

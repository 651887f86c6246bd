"""SAC training on the calibrated sb1-scale building: the learning run; port
of benchmarks/sac_sb1_train.py.

Trains SAC with the reference recipe (schedule-policy replay seeding,
SAC_Demo.ipynb cells 26-48) on the 12-zone calibrated config (or the
126-room --full-scale building), evaluates the greedy policy against the
rules-based schedule baseline over full days, and writes the learning
curve. The trainer's "auto" solver is the CUDA kernel K2 on the card (the
JAX package resolved it to its XLA solver off the TPU); --cpu runs the
plain versions on the CPU. The JAX script's jitted programs are captured
programs here (graphs.py): its lax.scan chunks are loops of --chunk calls
of the captured train step (one program per side of the update gate) or
seeding step, made once for the run, each evaluation the captured
`evaluate`, and each baseline rollout's step a captured program made for
the rollout; an evaluation's or rollout's step is replayed once per step.
A rollout or evaluation through a plain solver ("xla_*", the parity
re-scoring) runs op by op: its convergence loop reads the device back
(`BuildingEnv.capture`).

Usage:
  python -m sbsim_tpu_torch.benchmarks.sac_sb1_train --train-steps 12000 --parity-eval
  python -m sbsim_tpu_torch.benchmarks.sac_sb1_train --cpu --n-envs 4 --train-steps 200
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from sbsim_tpu_torch import graphs, rng
from sbsim_tpu_torch.agents import schedule_policy
from sbsim_tpu_torch.agents.sac import SACConfig
from sbsim_tpu_torch.agents.train import SACTrainer, TrainConfig
from sbsim_tpu_torch.benchmarks import card_line
from sbsim_tpu_torch.envs import presets
from sbsim_tpu_torch.envs.building_env import BuildingEnv


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain versions); without it on the card")
    p.add_argument("--full-scale", action="store_true",
                   help="126-room building matching the real sb1 device count")
    p.add_argument("--n-envs", type=int, default=64)
    p.add_argument("--train-steps", type=int, default=12_000)
    p.add_argument("--seed-steps", type=int, default=600)
    p.add_argument("--chunk", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=2_000)
    p.add_argument("--eval-envs", type=int, default=4)
    p.add_argument("--updates-per-step", type=int, default=1)
    p.add_argument("--replay-capacity", type=int, default=50_000,
                   help="replay ring size (reference default 50k; larger retains "
                   "schedule-seeded and peak-policy data longer against late-training "
                   "collapse)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--target-entropy", type=float, default=None,
                   help="override the -|A| default")
    p.add_argument("--min-alpha", type=float, default=0.0,
                   help="temperature floor (0 = off, the reference default)")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="global-norm gradient clipping")
    p.add_argument("--mean-reg", type=float, default=0.0,
                   help="L2 penalty on the actor's pre-tanh mean (anti-saturation; 0 = "
                   "off, the reference default)")
    p.add_argument("--label-suffix", default="",
                   help="appended to the artifact label/filename")
    p.add_argument("--constant-sweep", type=int, default=0,
                   help="evaluate an NxN grid of constant actions and record the best (the "
                   "policy-landscape baseline SAC is compared against)")
    p.add_argument("--parity-eval", action="store_true",
                   help="additionally re-score the best SAC checkpoint, the schedule "
                   "baseline and the constant sweep under the xla_jacobi parity solver and "
                   "a Chebyshev solver, so the SAC-beats-baselines ordering is shown to be "
                   "solver-independent")
    return p.parse_args(argv)


def make_env(full_scale: bool, device):
    """The 12-zone calibrated building (or the 126-room one, layout "auto"),
    one-day episodes; returns (env, label)."""
    floor_plan = None
    label = "sb1_12zone"
    if full_scale:
        from sbsim_tpu_torch.core.geometry import make_synthetic_office_plan

        floor_plan = make_synthetic_office_plan(9, 14, room_cvs=12)
        label = "sb1_126room"
    env = BuildingEnv(presets.sb1_config(num_days_in_episode=1, floor_plan=floor_plan,
                                         layout="auto" if full_scale else "ref"),
                      device=device)
    return env, label


def rollout_step(env, solver: str = "auto") -> graphs.CapturedFunction:
    """One step of a baseline rollout, (the device action table, states) ->
    (states, rewards), each env taking the table's row at its own step (the
    last row past the table's end): a captured program
    (`BuildingEnv.capture`: op by op through a plain solver), replayed once
    per step as the JAX script's compiled scan runs its body, so that a
    capture costs one step."""

    def step(table, states):
        act = table[torch.clamp(states.step_idx.to(torch.int64), 0, table.shape[0] - 1)]
        states, out = env.step_batched(states, act, solver=solver)
        return states, out.reward

    return env.capture(step, solver)


def _rollout(step, env, table, key, n_eval: int, eval_envs: int):
    states, _ = env.reset(rng.split(key, eval_envs))
    rewards = []
    for _ in range(n_eval):
        states, reward = step(table, states)
        rewards.append(reward)
    return states, torch.stack(rewards)


def rollout(env, table, key, n_eval: int, eval_envs: int, solver: str = "auto"):
    """eval_envs envs reset from `key`, stepped n_eval times by
    `rollout_step` (made for this call) over the action table; returns (the
    final states, the (n_eval, eval_envs) rewards)."""
    table = torch.as_tensor(np.asarray(table), dtype=torch.float32, device=env.device)
    return _rollout(rollout_step(env, solver), env, table, key.to(env.device), n_eval,
                    eval_envs)


def _day_return(rewards: torch.Tensor) -> float:
    """The mean over the envs of the summed rewards."""
    return float(torch.mean(rewards.sum(dim=0)))


def schedule_return(env, table, key, n_eval: int, eval_envs: int, solver: str = "auto") -> float:
    """The rules-based schedule baseline's return over n_eval steps: each
    env's action from the schedule table at its own step."""
    return _day_return(rollout(env, table, key, n_eval, eval_envs, solver)[1])


def constant_return(env, act, key, n_eval: int, eval_envs: int, solver: str = "auto") -> float:
    """The return of one action vector held all day by every env (a
    one-row action table)."""
    return _day_return(rollout(env, np.asarray(act)[None], key, n_eval, eval_envs, solver)[1])


def run_constant_sweep(env, grid_n: int, n_eval: int, eval_envs: int, solver: str = "auto"):
    """The strongest trivial policy class: an grid_n^|A| grid of constant
    actions over the normalized box; returns (the best, the grid)."""
    lin = np.linspace(-1.0, 1.0, grid_n)
    grid = np.stack([g.ravel() for g in np.meshgrid(*([lin] * env.n_actions))],
                    axis=-1).astype(np.float32)
    t0 = time.time()
    rets = [constant_return(env, a, rng.PRNGKey(7), n_eval, eval_envs, solver) for a in grid]
    k = int(np.argmax(rets))
    best = {"return": round(rets[k], 4), "action": [round(float(v), 3) for v in grid[k]],
            "grid": grid_n, "solver": solver}
    print(f"best constant action [{solver}] {best['action']}: {best['return']:.3f} "
          f"({len(grid)} evals, {time.time() - t0:.0f}s)", flush=True)
    return best, grid


def seed_replay(trainer, state, table, chunks: int, chunk: int):
    """`chunks` chunks of `chunk` schedule-table collect steps."""
    seed_one = trainer.seed_with_actions(state, table)
    for _ in range(chunks * chunk):
        state, _ = seed_one(state)
    return state


def train_chunk(step, state, chunk: int):
    """`chunk` calls of `step` (the trainer's captured train step); returns
    the state and the last step's critic loss and alpha."""
    for _ in range(chunk):
        state, m = step(state)
    return state, float(m["critic_loss"]), float(m["alpha"])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    env, label = make_env(args.full_scale, "cpu" if args.cpu else None)
    label += args.label_suffix
    n_eval = env.steps_per_episode  # one simulated day
    card = card_line(env.device)
    print(f"{label}: grid={env.geom.shape} zones={env.n_zones} obs={env.obs_dim} "
          f"acts={env.n_actions} device={env.device} card={card}", flush=True)

    trainer = SACTrainer(env, TrainConfig(
        n_envs=args.n_envs,
        replay_capacity=args.replay_capacity,
        batch_size=256,
        updates_per_env_step=args.updates_per_step,
        seed_steps=0,
        sac=SACConfig(target_entropy=args.target_entropy, min_alpha=args.min_alpha,
                      gradient_clipping=args.grad_clip, mean_reg=args.mean_reg),
    ))
    state = trainer.init(rng.PRNGKey(args.seed))
    table = schedule_policy.build_schedule_actions(env)
    # The captured programs, made once for the run.
    train_step, evaluator = trainer.captured_train_step(), trainer.captured_evaluate()
    ev = lambda sac, seed: float(evaluator(sac, rng.PRNGKey(seed), n_eval, args.eval_envs))

    # --- baselines over one full simulated day ---------------------------
    sched_ret = schedule_return(env, table, rng.PRNGKey(7), n_eval, args.eval_envs)
    print(f"schedule-policy baseline return/day: {sched_ret:.3f}", flush=True)
    best_constant = None
    if args.constant_sweep > 1:
        best_constant, _ = run_constant_sweep(env, args.constant_sweep, n_eval, args.eval_envs)

    # --- replay seeding with the schedule policy ---------------------------
    t0 = time.time()
    state = seed_replay(trainer, state, table, max(1, args.seed_steps // args.chunk), args.chunk)
    print(f"seeded replay: {int(state.replay.size) * args.n_envs} transitions "
          f"({time.time() - t0:.0f}s)", flush=True)
    ret0 = ev(state.sac, 9)
    print(f"untrained greedy return/day: {ret0:.3f}", flush=True)

    # --- training loop, chunked ---------------------------------------------
    curve = [{"env_steps": 0, "eval_return": ret0}]
    best_sac, best_ret = copy.deepcopy(state.sac), ret0
    t0 = time.time()
    done_steps = 0
    while done_steps < args.train_steps:
        state, critic_loss, alpha = train_chunk(train_step, state, args.chunk)
        done_steps += args.chunk
        if done_steps % args.eval_every < args.chunk:
            ret = ev(state.sac, 9)
            curve.append({"env_steps": done_steps, "eval_return": ret})
            if ret > best_ret:
                best_ret, best_sac = ret, copy.deepcopy(state.sac)
            print(f"step {done_steps}: eval {ret:.3f} critic {critic_loss:.4f} alpha "
                  f"{alpha:.3f} ({time.time() - t0:.0f}s)", flush=True)

    final = curve[-1]["eval_return"]
    best = max(c["eval_return"] for c in curve)
    # The best checkpoint re-scored on a held-out eval seed, so that the
    # selection's noise cannot inflate it.
    best_holdout = ev(best_sac, 11)
    sched_holdout = schedule_return(env, table, rng.PRNGKey(11), n_eval, args.eval_envs)
    print(f"best checkpoint on held-out seed: {best_holdout:.3f} (schedule same seed: "
          f"{sched_holdout:.3f})", flush=True)

    # --- parity re-scoring ------------------------------------------------------
    # The Chebyshev and Jacobi returns differ by ~2% a day, the order of the
    # SAC-against-constant margin: the same checkpoint and every baseline
    # re-scored under both solver families show whether the ordering holds.
    parity = None
    if args.parity_eval:
        cheby = "pallas_cheby" if env.device.type == "cuda" else "xla_chebyshev"
        parity = {}
        for solver in ("xla_jacobi", cheby):
            tr_eval = trainer.with_solver(solver).captured_evaluate()
            block = {
                "sac_best_eval_seed": round(float(tr_eval(best_sac, rng.PRNGKey(9), n_eval,
                                                          args.eval_envs)), 4),
                "sac_best_holdout_seed": round(float(tr_eval(best_sac, rng.PRNGKey(11), n_eval,
                                                             args.eval_envs)), 4),
                "schedule_eval_seed": round(schedule_return(
                    env, table, rng.PRNGKey(7), n_eval, args.eval_envs, solver), 4),
                "schedule_holdout_seed": round(schedule_return(
                    env, table, rng.PRNGKey(11), n_eval, args.eval_envs, solver), 4),
            }
            if args.constant_sweep > 1:
                const_s, _ = run_constant_sweep(env, args.constant_sweep, n_eval,
                                                args.eval_envs, solver)
                block["best_constant"] = const_s
                block["sac_beats_constant_class"] = bool(
                    block["sac_best_eval_seed"] > const_s["return"])
            block["sac_beats_schedule"] = bool(
                block["sac_best_holdout_seed"] > block["schedule_holdout_seed"])
            parity[solver] = block
            print(f"parity eval ({solver}): {json.dumps(block)}", flush=True)
    result = {
        "label": label,
        "platform": "gpu" if env.device.type == "cuda" else "cpu",
        "card": card,
        "n_envs": args.n_envs,
        "train_steps": args.train_steps,
        "eval_days": 1,
        "schedule_baseline_return": round(sched_ret, 4),
        "untrained_return": round(ret0, 4),
        "final_return": round(final, 4),
        "best_return": round(best, 4),
        "best_return_holdout_seed": round(best_holdout, 4),
        "schedule_return_holdout_seed": round(sched_holdout, 4),
        "beats_schedule": bool(best_holdout > sched_holdout),
        "final_beats_schedule": bool(final > sched_ret),
        "best_constant": best_constant,
        "parity_eval": parity,
        "replay_capacity": args.replay_capacity,
        "mean_reg": args.mean_reg,
        "target_entropy": args.target_entropy,
        "min_alpha": args.min_alpha,
        "grad_clip": args.grad_clip,
        "seed": args.seed,
        "curve": curve,
        "wall_sec": round(time.time() - t0, 1),
    }
    print(json.dumps({k: v for k, v in result.items() if k != "curve"}), flush=True)
    out = args.out or f"artifacts/sac_{label}_torch_curve.json"
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(f"wrote {out}", flush=True)
    return result


if __name__ == "__main__":
    main()

"""SAC smoke on the calibrated sb1 building (12 zones, one-day episodes);
port of benchmarks/sac_sb1_smoke.py.

The JAX script's recipe: n_envs 8, replay 50,000, batch 256, 2 updates per
env step, the replay seeded with 500 schedule-table steps, then 8,000
train steps with a greedy evaluation of a day (288 steps at 2 envs from
PRNGKey(9)) every 2,000. The env step is the CUDA kernel K2 on the card,
its plain version with --cpu; on the card the seeding and train steps and
the evaluations are captured programs (graphs.py), as the JAX script
jits them. `--train-steps`, `--seed-steps` and
`--eval-every` cut the run.

Usage:
  python -m sbsim_tpu_torch.benchmarks.sac_sb1_smoke
  python -m sbsim_tpu_torch.benchmarks.sac_sb1_smoke --cpu --train-steps 100 --eval-every 100
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from sbsim_tpu_torch import rng
from sbsim_tpu_torch.agents import schedule_policy
from sbsim_tpu_torch.agents.train import SACTrainer, TrainConfig
from sbsim_tpu_torch.benchmarks import card_line
from sbsim_tpu_torch.envs import presets
from sbsim_tpu_torch.envs.building_env import BuildingEnv

N_EVAL = 288  # a day
RECIPE = dict(n_envs=8, replay_capacity=50_000, batch_size=256, updates_per_env_step=2,
              seed_steps=0)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain versions); without it on the card")
    p.add_argument("--train-steps", type=int, default=8_000)
    p.add_argument("--seed-steps", type=int, default=500)
    p.add_argument("--eval-every", type=int, default=2_000)
    args = p.parse_args(argv)
    if args.seed_steps < 1:
        p.error("--seed-steps must be at least 1 (the schedule's step reward is printed)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    env = BuildingEnv(presets.sb1_config(num_days_in_episode=1),
                      device="cpu" if args.cpu else None)
    result = {"card": card_line(env.device), "grid": list(env.geom.shape),
              "zones": env.n_zones, "obs": env.obs_dim}
    print(f"grid={env.geom.shape} zones={env.n_zones} obs={env.obs_dim}", flush=True)

    trainer = SACTrainer(env, TrainConfig(**RECIPE))
    state = trainer.init(rng.PRNGKey(0))
    evaluator = trainer.captured_evaluate()
    eval_key = rng.PRNGKey(9, device=env.device)
    evaluate = lambda sac: float(evaluator(sac, eval_key, N_EVAL, 2))

    seed_fn = trainer.seed_with_actions(state, schedule_policy.build_schedule_actions(env))
    t0 = time.time()
    for _ in range(args.seed_steps):
        state, m = seed_fn(state)
    result["replay_size"] = int(state.replay.size)
    result["schedule_step_reward"] = float(m["reward_mean"])
    print(f"seeded {result['replay_size']} transitions in {time.time() - t0:.0f}s; schedule "
          f"step-reward {result['schedule_step_reward']:.4f}", flush=True)
    result["untrained_return"] = evaluate(state.sac)
    print(f"untrained greedy return ({N_EVAL} steps): {result['untrained_return']:.3f}",
          flush=True)

    result["curve"] = []
    train_step = trainer.captured_train_step()
    t0 = time.time()
    for i in range(args.train_steps):
        state, metrics = train_step(state)
        if (i + 1) % args.eval_every == 0:
            row = {"step": i + 1, "eval_return": evaluate(state.sac),
                   "critic_loss": float(metrics["critic_loss"]),
                   "alpha": float(metrics["alpha"])}
            result["curve"].append(row)
            print(f"step {i + 1}: eval {row['eval_return']:.3f} critic "
                  f"{row['critic_loss']:.4f} alpha {row['alpha']:.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    print("done", flush=True)
    return result


if __name__ == "__main__":
    main()

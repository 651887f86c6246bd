"""SAC learning smoke on the two-zone building; port of
benchmarks/sac_smoke.py.

Does training beat the untrained policy and approach the schedule
baseline? The recipe is the JAX script's: n_envs 8, replay 50,000, batch
256, 2 updates per env step, the replay seeded with 600 schedule-table
steps (SAC_Demo.ipynb cells 34-40), 12,000 train steps with a greedy
evaluation of half a day (144 steps at 4 envs from PRNGKey(9)) every
1,500. The env step is the CUDA kernel K2 on the card, its plain version
with --cpu; on the card the seeding and train steps, the evaluations and
the baseline's rollout are captured programs (graphs.py), as the JAX
script jits them. `--train-steps`, `--seed-steps` and `--eval-every` cut the run.

Usage:
  python -m sbsim_tpu_torch.benchmarks.sac_smoke
  python -m sbsim_tpu_torch.benchmarks.sac_smoke --cpu --train-steps 200 --eval-every 100
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from sbsim_tpu_torch import rng
from sbsim_tpu_torch.agents import schedule_policy
from sbsim_tpu_torch.agents.train import SACTrainer, TrainConfig
from sbsim_tpu_torch.benchmarks import card_line, sac_sb1_train
from sbsim_tpu_torch.envs import presets
from sbsim_tpu_torch.envs.building_env import BuildingEnv

N_EVAL = 144  # half a day
RECIPE = dict(n_envs=8, replay_capacity=50_000, batch_size=256, updates_per_env_step=2,
              seed_steps=0)


def rollout_fixed(env, actions_table, n_steps, n_envs=4, seed=123) -> float:
    """The mean over n_envs envs (keys split from PRNGKey(seed)) of the
    return of n_steps steps, each env taking the table's action for its own
    step."""
    return sac_sb1_train.schedule_return(env, actions_table, rng.PRNGKey(seed), n_steps, n_envs)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain versions); without it on the card")
    p.add_argument("--train-steps", type=int, default=12_000)
    p.add_argument("--seed-steps", type=int, default=600)
    p.add_argument("--eval-every", type=int, default=1_500)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    env = BuildingEnv(presets.two_zone_test_config(num_days_in_episode=1),
                      device="cpu" if args.cpu else None)
    result = {"card": card_line(env.device)}

    sched = schedule_policy.build_schedule_actions(env)
    result["schedule_return"] = rollout_fixed(env, sched, N_EVAL)
    print(f"schedule baseline return ({N_EVAL} steps): {result['schedule_return']:.3f}",
          flush=True)

    trainer = SACTrainer(env, TrainConfig(**RECIPE))
    state = trainer.init(rng.PRNGKey(0))
    evaluator = trainer.captured_evaluate()
    eval_key = rng.PRNGKey(9, device=env.device)
    evaluate = lambda sac: float(evaluator(sac, eval_key, N_EVAL, 4))
    result["untrained_return"] = evaluate(state.sac)
    print(f"untrained greedy return: {result['untrained_return']:.3f}", flush=True)

    seed_fn = trainer.seed_with_actions(state, sched)
    for _ in range(args.seed_steps):
        state, _ = seed_fn(state)
    result["replay_size"] = int(state.replay.size)
    print(f"replay seeded: {result['replay_size']} transitions", flush=True)

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
            print(f"step {i + 1}: eval return {row['eval_return']:.3f} critic_loss "
                  f"{row['critic_loss']:.4f} alpha {row['alpha']:.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    result["final_return"] = evaluate(state.sac)
    print(f"final greedy return: {result['final_return']:.3f} (untrained "
          f"{result['untrained_return']:.3f}, schedule {result['schedule_return']:.3f})",
          flush=True)
    return result


if __name__ == "__main__":
    main()

"""End-to-end SAC training on the calibrated building (script form of the
reference's SAC_Demo notebook pipeline); port of examples/train_sac.py.

Pipeline (matching SAC_Demo.ipynb cells 13-48): build the calibrated env,
build the rules-based schedule baseline, seed the replay buffer by running
that baseline, then train SAC (collection + replay + one update per env
step), evaluating the greedy policy and checkpointing every --eval_every
steps. JSONL metrics (and TensorBoard, where it imports) and checkpoints
are written under --output_dir. The env runs on the GPU (the FDM solve in
the CUDA kernel `fdm_jacobi`); --cpu runs it on the CPU with the kernels'
plain versions. On one GPU there is no device mesh: the train step is
`SACTrainer.train_step`.

Usage:
  python -m sbsim_tpu_torch.examples.train_sac --train_steps 20000 \\
      --n_envs 64 --output_dir runs/sbsim
  python -m sbsim_tpu_torch.examples.train_sac --small --cpu --train_steps 500
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Optional, Sequence


@dataclasses.dataclass
class TrainRun:
    """What a run leaves behind: its env, trainer and final TrainState."""

    env: Any
    trainer: Any
    state: Any
    output_dir: str
    baseline_reward: float
    final_return: float


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir",
                        default=os.path.join(tempfile.gettempdir(), "sbsim_tpu_torch_run"))
    parser.add_argument("--train_steps", type=int, default=20_000)
    parser.add_argument("--seed_episodes_steps", type=int, default=2_000)
    parser.add_argument("--n_envs", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--replay_capacity", type=int, default=50_000)
    parser.add_argument("--eval_every", type=int, default=2_000)
    parser.add_argument("--eval_steps", type=int, default=288)
    parser.add_argument("--num_days_in_episode", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--small", action="store_true",
                        help="use the tiny two-zone building")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions); "
                        "without it the run needs a CUDA device")
    parser.add_argument("--weather_csv", default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)

    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.agents.train import SACTrainer, recipe_for
    from sbsim_tpu_torch.envs import presets
    from sbsim_tpu_torch.envs.building_env import BuildingEnv
    from sbsim_tpu_torch.io.checkpoint import TrainCheckpointer
    from sbsim_tpu_torch.io.metrics import MetricsAccumulator

    os.makedirs(args.output_dir, exist_ok=True)

    if args.small:
        config = presets.two_zone_test_config(
            num_days_in_episode=args.num_days_in_episode,
            occupancy_kind="randomized",
        )
    else:
        config = presets.sb1_config(
            num_days_in_episode=args.num_days_in_episode,
            weather_csv=args.weather_csv,
        )
    env = BuildingEnv(config, device="cpu" if args.cpu else None)
    dev = env.device
    print(
        f"building: grid={env.geom.shape} zones={env.n_zones} "
        f"obs_dim={env.obs_dim} actions={env.n_actions} device={dev}",
        flush=True,
    )

    # recipe_for gates the full-scale stability recipe (min_alpha=0.01 at
    # >= 100 zones) on the building's scale.
    train_config = recipe_for(
        env,
        n_envs=args.n_envs,
        replay_capacity=args.replay_capacity,
        batch_size=args.batch_size,
        updates_per_env_step=1,
        seed_steps=0,
    )
    if train_config.sac.min_alpha > 0:
        print(f"full-scale recipe: min_alpha={train_config.sac.min_alpha}", flush=True)
    trainer = SACTrainer(env, train_config)
    state = trainer.init(rng.PRNGKey(args.seed, device=dev))

    def evaluate(sac) -> float:
        return float(trainer.evaluate(sac, rng.PRNGKey(7, device=dev),
                                      n_steps=args.eval_steps, n_envs=4))

    metrics_out = MetricsAccumulator(
        os.path.join(args.output_dir, "train_metrics.jsonl"),
        reporting_interval=100,
        tensorboard_dir=os.path.join(args.output_dir, "tb"),
    )
    checkpointer = TrainCheckpointer(os.path.join(args.output_dir, "ckpt"), trainer)

    # --- Schedule baseline + replay seeding (SAC_Demo cells 13-18, 34-40) --
    schedule_table = schedule_policy.build_schedule_actions(env)
    seed_fn = trainer.seed_with_actions(state, schedule_table)
    n_seed = max(1, args.seed_episodes_steps // args.n_envs)
    t0 = time.time()
    for _ in range(n_seed):
        state, m = seed_fn(state)
    baseline_reward = float(m["reward_mean"])
    print(
        f"seeded replay with {int(state.replay.size)} baseline transitions "
        f"({time.time() - t0:.0f}s); baseline step reward {baseline_reward:.4f}",
        flush=True,
    )

    # --- Train ------------------------------------------------------------
    t0 = time.time()
    for i in range(args.train_steps):
        state, metrics = trainer.train_step(state)
        metrics_out.record(metrics)
        if (i + 1) % args.eval_every == 0:
            ret = evaluate(state.sac)
            sps = state.env_steps / (time.time() - t0)
            print(
                f"step {i + 1}: eval_return {ret:.3f} "
                f"critic_loss {float(metrics['critic_loss']):.4f} "
                f"alpha {float(metrics['alpha']):.4f} "
                f"env_steps {state.env_steps} ({sps:.0f} env-steps/s)",
                flush=True,
            )
            checkpointer.save(i + 1, state)
    metrics_out.close()
    checkpointer.close()

    ret = evaluate(state.sac)
    print(f"final greedy eval return ({args.eval_steps} steps): {ret:.3f}", flush=True)
    return TrainRun(env=env, trainer=trainer, state=state, output_dir=args.output_dir,
                    baseline_reward=baseline_reward, final_return=ret)


if __name__ == "__main__":
    main()

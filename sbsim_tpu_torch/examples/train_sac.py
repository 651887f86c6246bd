"""End-to-end SAC training on the calibrated building (script form of the
reference's SAC_Demo notebook pipeline); port of examples/train_sac.py.

Pipeline (matching SAC_Demo.ipynb cells 13-48): build the calibrated env,
build the rules-based schedule baseline, seed the replay buffer by running
that baseline, then train SAC (collection + replay + one update per env
step), evaluating the greedy policy and checkpointing every --eval_every
steps. JSONL metrics (and TensorBoard, where it imports) and checkpoints
are written under --output_dir. The env runs on the GPU (the FDM solve in
the CUDA kernel `fdm_jacobi`); --cpu runs it on the CPU with the kernels'
plain versions.

As the JAX script shards its state over a device mesh, this one shards it
over the ranks of a process group (distributed/): under torchrun each rank
drives one card over NCCL (with --cpu, the CPU over gloo), steps
n_envs / ranks of the envs and mean-reduces the SAC gradients; rank 0
prints and writes the metrics and checkpoints. Run as one process, it is
a mesh of one rank, and on the card its seeding step, train step and
evaluation are captured CUDA graphs (graphs.py), as the JAX script jits
them.

Usage:
  python -m sbsim_tpu_torch.examples.train_sac --train_steps 20000 \\
      --n_envs 64 --output_dir runs/sbsim
  torchrun --nproc_per_node 4 -m sbsim_tpu_torch.examples.train_sac \\
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
                        help="run on the CPU (the kernels' plain versions; ranks "
                        "over gloo); without it the run needs a CUDA device")
    parser.add_argument("--weather_csv", default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)

    from sbsim_tpu_torch.distributed import runtime

    created = runtime.initialize(backend="gloo" if args.cpu else None)
    try:
        return _run(args)
    finally:
        if created:
            runtime.shutdown()


def _run(args: argparse.Namespace) -> TrainRun:
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.agents.train import SACTrainer, recipe_for
    from sbsim_tpu_torch.distributed import mesh as mesh_lib
    from sbsim_tpu_torch.envs import presets
    from sbsim_tpu_torch.envs.building_env import BuildingEnv
    from sbsim_tpu_torch.io.checkpoint import TrainCheckpointer
    from sbsim_tpu_torch.io.metrics import MetricsAccumulator

    mesh = mesh_lib.make_mesh()
    log = _rank0_print(mesh.rank)
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
    log(
        f"building: grid={env.geom.shape} zones={env.n_zones} "
        f"obs_dim={env.obs_dim} actions={env.n_actions} device={dev}",
        flush=True,
    )
    if mesh.size > 1:
        log(f"mesh: {mesh.size} ranks of {args.n_envs // mesh.size} envs", flush=True)

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
        log(f"full-scale recipe: min_alpha={train_config.sac.min_alpha}", flush=True)
    trainer = SACTrainer(env, train_config)
    state = trainer.init(rng.PRNGKey(args.seed, device=dev))

    state = mesh_lib.shard_train_state(state, mesh)
    train_step = mesh_lib.make_distributed_train_step(trainer, mesh)

    # The evaluation is one captured program (examples/train_sac.py:97 jits it).
    captured_evaluate = trainer.captured_evaluate()
    eval_key = rng.PRNGKey(7, device=dev)

    def evaluate(sac) -> float:
        return float(captured_evaluate(sac, eval_key, args.eval_steps, 4))

    metrics_out = MetricsAccumulator(
        os.path.join(args.output_dir, "train_metrics.jsonl"),
        reporting_interval=100,
        tensorboard_dir=os.path.join(args.output_dir, "tb"),
    )
    checkpointer = TrainCheckpointer(os.path.join(args.output_dir, "ckpt"), trainer,
                                     mesh=mesh)

    # --- Schedule baseline + replay seeding (SAC_Demo cells 13-18, 34-40) --
    schedule_table = schedule_policy.build_schedule_actions(env)
    seed_fn = mesh_lib.make_distributed_collect_step(trainer, mesh, schedule_table)
    n_seed = max(1, args.seed_episodes_steps // args.n_envs)
    t0 = time.time()
    for _ in range(n_seed):
        state, m = seed_fn(state)
    baseline_reward = float(m["reward_mean"])
    log(
        f"seeded replay with {int(state.replay.size)} baseline transitions "
        f"({time.time() - t0:.0f}s); baseline step reward {baseline_reward:.4f}",
        flush=True,
    )

    # --- Train ------------------------------------------------------------
    t0 = time.time()
    for i in range(args.train_steps):
        state, metrics = train_step(state)
        metrics_out.record(metrics)
        if (i + 1) % args.eval_every == 0:
            ret = evaluate(state.sac)
            sps = state.env_steps / (time.time() - t0)
            log(
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
    log(f"final greedy eval return ({args.eval_steps} steps): {ret:.3f}", flush=True)
    return TrainRun(env=env, trainer=trainer, state=state, output_dir=args.output_dir,
                    baseline_reward=baseline_reward, final_return=ret)


def _rank0_print(rank: int):
    """print on rank 0; nothing on the others."""
    return print if rank == 0 else (lambda *args, **kwargs: None)


if __name__ == "__main__":
    main()

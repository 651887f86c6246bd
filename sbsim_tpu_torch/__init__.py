"""sbsim_tpu_torch: the smart-building control stack on PyTorch and CUDA.

A port of `sbsim_tpu` (JAX/XLA/Pallas) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper. It imports nothing of JAX and nothing of
`sbsim_tpu`: every module it needs is copied or rewritten here, with the
same layout and names, so each module's counterpart is easy to find.

Layer map:
  core/       building geometry -> static stencil arrays     (host, numpy)
  physics/    FDM Jacobi/Chebyshev solvers (torch + CUDA), convection,
              deterministic zone/grid statistics
  hvac/       batched VAV / air handler / boiler / thermostat
  scenario/   weather, occupancy, calendar/tariff tables (no pandas)
  envs/       batched environment: obs / action / reward; multi-building
              suites; the proto host adapter, host loop and real-building
              controller
  agents/     SAC: networks, replay, learner, trainer, schedule baseline
  distributed/ ranks over the env axis on torch.distributed: the process
              group, sharded train states, the per-rank train step
  io/         JSONL metrics, TrainState checkpoints (numpy archives),
              proto record shards
  proto/      the wire-format schemas on the port's own proto3 runtime
  utils/      time/unit/id conversions, telemetry imputation
  interfaces  the abstract building / reward / normalizer contracts
  examples/   entry points (`python -m sbsim_tpu_torch.examples.train_sac`)
  rng.py      threefry2x32, bitwise equal to jax.random
  convert.py  EnvState / TrainState <-> nested dicts of numpy arrays

PyTorch idiom throughout: dataclasses of tensors with an explicit leading
batch dimension, and an explicit `device`. `BuildingEnv(config)` runs on
the GPU; the CPU is used only when the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level conveniences, as the JAX package has them."""
    if name == "BuildingEnv":
        from sbsim_tpu_torch.envs.building_env import BuildingEnv

        return BuildingEnv
    if name == "presets":
        from sbsim_tpu_torch.envs import presets

        return presets
    if name == "SACTrainer":
        from sbsim_tpu_torch.agents.train import SACTrainer

        return SACTrainer
    if name == "TrainConfig":
        from sbsim_tpu_torch.agents.train import TrainConfig

        return TrainConfig
    if name == "SimulatedBuilding":
        from sbsim_tpu_torch.envs.host_adapter import SimulatedBuilding

        return SimulatedBuilding
    if name == "interfaces":
        import importlib

        return importlib.import_module("sbsim_tpu_torch.interfaces")
    raise AttributeError(f"module 'sbsim_tpu_torch' has no attribute {name!r}")

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
              suites
  agents/     SAC: networks, replay, learner, trainer, schedule baseline
  io/         JSONL metrics, TrainState checkpoints (numpy archives)
  examples/   entry points (`python -m sbsim_tpu_torch.examples.train_sac`)
  rng.py      threefry2x32, bitwise equal to jax.random
  convert.py  EnvState / TrainState <-> nested dicts of numpy arrays

PyTorch idiom throughout: dataclasses of tensors with an explicit leading
batch dimension, and an explicit `device`. `BuildingEnv(config)` runs on
the GPU; the CPU is used only when the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

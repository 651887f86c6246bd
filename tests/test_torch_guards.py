"""Guards of the port: it imports no JAX (nor flax, optax, orbax, pandas,
protobuf, matplotlib, PIL, scikit-learn, zoneinfo or the JAX package), runs
on a CUDA device unless told otherwise, and makes no kernel launch on the
CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sbsim_tpu_torch import rng
from sbsim_tpu_torch.envs import building_env, presets
from sbsim_tpu_torch.physics import fdm_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import sbsim_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sbsim_tpu_torch.__path__, "sbsim_tpu_torch.")]
for name in names:
    importlib.import_module(name)
agents = {"networks", "replay", "sac", "exploration", "schedule_policy", "train", "policies"}
missing = agents - {n.split(".")[-1] for n in names if n.startswith("sbsim_tpu_torch.agents.")}
missing |= {"sbsim_tpu_torch.io.metrics", "sbsim_tpu_torch.io.checkpoint",
            "sbsim_tpu_torch.envs.suite", "sbsim_tpu_torch.examples.train_sac",
            "sbsim_tpu_torch.proto.building_pb2", "sbsim_tpu_torch.io.records",
            "sbsim_tpu_torch.envs.host_adapter", "sbsim_tpu_torch.envs.host_environment",
            "sbsim_tpu_torch.envs.real_building", "sbsim_tpu_torch.interfaces",
            "sbsim_tpu_torch.utils.regression", "sbsim_tpu_torch.utils.reducers",
            "sbsim_tpu_torch.utils.energy", "sbsim_tpu_torch.utils.run_command_predictor",
            "sbsim_tpu_torch.utils.testing", "sbsim_tpu_torch.utils.profiling",
            "sbsim_tpu_torch.utils.frame", "sbsim_tpu_torch.io.render",
            "sbsim_tpu_torch.io.plots", "sbsim_tpu_torch.examples.episode_dashboard",
            "sbsim_tpu_torch.native", "sbsim_tpu_torch.physics.reference_impl",
            "sbsim_tpu_torch.envs.exact_host", "sbsim_tpu_torch.envs.gin_compat",
            "sbsim_tpu_torch.distributed.runtime", "sbsim_tpu_torch.distributed.mesh",
            "sbsim_tpu_torch.benchmarks.conv_rounds_sweep",
            "sbsim_tpu_torch.benchmarks.conv_schedule_search",
            "sbsim_tpu_torch.benchmarks.fullscale_parity_check",
            "sbsim_tpu_torch.benchmarks.scaling",
            "sbsim_tpu_torch.benchmarks.sac_sb1_train",
            "sbsim_tpu_torch.benchmarks.conv_fullscale_null",
            "sbsim_tpu_torch.benchmarks.conv_designed_sweep",
            "sbsim_tpu_torch.benchmarks.conv_schedule_sweep",
            "sbsim_tpu_torch.benchmarks.sac_smoke",
            "sbsim_tpu_torch.benchmarks.sac_sb1_smoke",
            "sbsim_tpu_torch.benchmarks.scaling_decomp"} - set(names)
import chip_smoke
chip_smoke.make_env, chip_smoke.main, chip_smoke.training_phase, chip_smoke.entry_train_sac
chip_smoke.host_phase, chip_smoke.offline_phase, chip_smoke.validation_phase
chip_smoke.distributed_phase, chip_smoke.rank_main, chip_smoke.scripts_phase
chip_smoke.learn_phase, chip_smoke.study_phase
# protobuf is google.protobuf (its runtime google._upb); the bare `google`
# namespace may be set up by a .pth file at start-up.
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas",
                                    "matplotlib", "PIL", "sklearn", "sbsim_tpu", "zoneinfo")
             or k.startswith(("google.protobuf", "google._upb")))
print(bad, sorted(missing))
sys.exit(1 if bad or missing else 0)
"""


def test_port_agents_and_chip_smoke_import_no_jax_flax_optax_orbax_pandas():
    """Every module of the port, the agents, the training entry point and
    its I/O, the wire runtime, the host path, the offline path, the
    validation path and the distributed layer among them, and chip_smoke.py
    import none of these, nor protobuf, nor zoneinfo (the card's machine
    has no tz database)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lazy_top_level_names_resolve_as_in_the_jax_package():
    """Every lazy name of sbsim_tpu/__init__.py resolves in the port, to the
    port's own object of that name."""
    import ast

    import sbsim_tpu_torch

    src = open(os.path.join(REPO, "sbsim_tpu", "__init__.py")).read()
    getattr_fn = next(n for n in ast.parse(src).body
                      if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    names = sorted(c.comparators[0].value for c in ast.walk(getattr_fn)
                   if isinstance(c, ast.Compare) and isinstance(c.left, ast.Name)
                   and c.left.id == "name")
    assert names == sorted(["BuildingEnv", "presets", "SACTrainer", "TrainConfig",
                            "SimulatedBuilding", "interfaces"])
    for name in names:
        obj = getattr(sbsim_tpu_torch, name)
        assert getattr(obj, "__name__", "").split(".")[-1] == name
        assert (getattr(obj, "__module__", None) or obj.__name__).startswith("sbsim_tpu_torch.")
    with pytest.raises(AttributeError):
        sbsim_tpu_torch.no_such_name


def test_env_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = presets.two_zone_test_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        building_env.BuildingEnv(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        building_env.BuildingEnv(cfg, device="cuda")


def test_simulated_building_without_device_needs_cuda(monkeypatch):
    from sbsim_tpu_torch.envs import host_adapter

    cfg = presets.two_zone_test_config()
    cpu = host_adapter.SimulatedBuilding(building_env.BuildingEnv(cfg, device="cpu"))
    assert cpu._state.temp.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        host_adapter.SimulatedBuilding(building_env.BuildingEnv(cfg))


def test_episode_dashboard_without_device_needs_cuda(monkeypatch, tmp_path):
    from sbsim_tpu_torch.examples import episode_dashboard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        episode_dashboard.main(["--steps", "1", "--render-every", "0", "--out", str(tmp_path)])


@pytest.mark.parametrize("script", ["conv_rounds_sweep", "conv_schedule_search",
                                    "fullscale_parity_check", "scaling", "sac_sb1_train",
                                    "conv_fullscale_null", "conv_designed_sweep",
                                    "conv_schedule_sweep", "sac_smoke", "sac_sb1_smoke",
                                    "scaling_decomp"])
def test_scripts_without_cpu_need_cuda(monkeypatch, tmp_path, script):
    """Each script of sbsim_tpu_torch/benchmarks runs on the card unless
    --cpu is given, and stops before any work without one."""
    import importlib

    module = importlib.import_module(f"sbsim_tpu_torch.benchmarks.{script}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_agents_without_device_need_cuda(monkeypatch, tmp_path):
    from sbsim_tpu_torch.agents import policies, sac

    learner = sac.SACLearner(4, 2, device="cpu")
    policies.save_policy(str(tmp_path), learner, learner.init(rng.PRNGKey(0)), ["a", "b"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sac.SACLearner(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        policies.load_policy(str(tmp_path))


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.main() != 0


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo beside it the script exits non-zero
    (here also for want of a card)."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    proc = subprocess.run([sys.executable, str(dst)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


class _Window:
    """A stand-in for torch.profiler.profile whose windows record the FDM
    kernel events listed in `recorded`, one list per window."""

    recorded = []

    def __init__(self, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.events_seen = _Window.recorded.pop(0)

    def events(self):
        class Range:
            def __init__(self, us):
                self.us = us

            def elapsed_us(self):
                return self.us

        return [type("Event", (), dict(device_type=torch.autograd.DeviceType.CUDA,
                                       name="fdm_jacobi_body", time_range=Range(us)))()
                for us in self.events_seen]


@pytest.mark.parametrize("windows,want", [
    ([[30.0, 50.0]], 0.02),             # the first window sees the kernels
    ([[], [], [40.0, 40.0]], 0.02),     # two empty windows, then the kernels
    ([[], [], []], None),               # every window empty: not measured
])
def test_chip_smoke_device_ms_profiles_again_when_a_window_is_empty(monkeypatch, windows, want):
    """A profiler window that records no FDM kernel is profiled again; after
    PROFILE_TRIES empty windows the device time is None ("not measured"),
    and the run goes on."""
    import torch.profiler

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert len(windows) <= chip_smoke.PROFILE_TRIES
    monkeypatch.setattr(_Window, "recorded", [list(w) for w in windows])
    monkeypatch.setattr(torch.profiler, "profile", _Window)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    got = chip_smoke.device_ms(lambda: calls.append(1), 4)
    assert got == want and _Window.recorded == []
    assert len(calls) == 1 + 4 * len(windows)
    assert chip_smoke.fmt_ms(got) == ("not measured" if want is None else "0.0200")


def test_chip_smoke_repeat_counts_failed_parts_and_goes_on(monkeypatch, capsys):
    """`--repeat` runs phases 5-7 round after round; a part that fails is
    counted, the rest of its round still runs, and the run exits 1."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    ran = []
    monkeypatch.setattr(chip_smoke, "training_phase",
                        lambda env, kname, *a: ran.append(kname))
    monkeypatch.setattr(chip_smoke, "entry_train_sac", lambda tag: ran.append("train_sac"))
    monkeypatch.setattr(chip_smoke, "entry_suite",
                        lambda *a: chip_smoke.fail("suite differs") if len(ran) < 4 else
                        ran.append("suite"))
    monkeypatch.setattr(chip_smoke, "entry_windows", lambda tag: ran.append("windows"))
    monkeypatch.setattr(chip_smoke, "host_phase", lambda envs, tag: ran.append("host"))
    envs = {w: None for w, *_ in chip_smoke.TRAINING}
    assert chip_smoke.repeat_phases(envs, 0.0, 1.0, 1.0, "[t]") == 1
    assert ran == ["fdm_jacobi", "fdm_jacobi_block", "train_sac", "windows", "host"]
    out = capsys.readouterr().out
    assert "FAILED: suite differs" in out and "1 rounds" in out
    assert "failed parts [(1, 'suite')]" in out


@pytest.mark.parametrize("solver", ["pallas_cheby", "pallas_env", "xla_jacobi"])
def test_cpu_run_makes_no_kernel_launch(solver):
    env = building_env.BuildingEnv(presets.two_zone_test_config(), device="cpu")
    fdm_cuda.reset_launch_counts()
    state, obs = env.reset(rng.split(rng.PRNGKey(0), 2))
    actions = torch.zeros((2, env.n_actions))
    for _ in range(2):
        state, out = env.step_batched(state, actions, solver=solver)
    assert fdm_cuda.launch_counts == {"fdm_cheby": 0, "fdm_jacobi": 0,
                                      "fdm_cheby_block": 0, "fdm_jacobi_block": 0}
    assert torch.isfinite(state.temp).all() and torch.isfinite(out.observation).all()
    assert out.observation.shape == (2, env.obs_dim)
    assert np.all((out.reward.numpy() >= -1) & (out.reward.numpy() <= 0))


def test_kernel_source_and_build_flags():
    """The kernels build from the package's own source for sm_90a with
    exact float32 arithmetic (no FMA contraction, IEEE division)."""
    assert os.path.exists(fdm_cuda.SOURCE)
    flags = " ".join(fdm_cuda.NVCC_FLAGS)
    assert "code=sm_90a" in flags and "-fmad=false" in flags
    assert "use_fast_math" not in flags
    assert os.path.basename(fdm_cuda.library_path()).startswith("fdm_kernels_")


def test_cpu_training_makes_no_kernel_launch():
    """The trainer on CPU tensors takes the kernels' plain versions, the
    statistics epilogue's included."""
    from sbsim_tpu_torch.agents import train

    env = building_env.BuildingEnv(presets.two_zone_test_config(), device="cpu")
    trainer = train.SACTrainer(env, train.recipe_for(
        env, n_envs=2, batch_size=4, seed_steps=0, env_solver="pallas_env"))
    fdm_cuda.reset_launch_counts()
    state = trainer.init(rng.PRNGKey(0))
    for _ in range(2):
        state, metrics = trainer.train_step(state)
    assert fdm_cuda.launch_counts == {"fdm_cheby": 0, "fdm_jacobi": 0,
                                      "fdm_cheby_block": 0, "fdm_jacobi_block": 0}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(state.replay.size) == 2 and state.env_steps == 4

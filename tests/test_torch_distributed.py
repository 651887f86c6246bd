"""The port's distributed layer (sbsim_tpu_torch/distributed) on the CPU.

Ranks are spawned processes joined over gloo by a FileStore under the
test's tmp directory (no TCP port: the suite runs several workers at
once), each with a deadline on the rendezvous and every collective
(`runtime.initialize(timeout=...)`) and a time limit on the whole job
(`runtime.spawn(timeout=...)` kills what is still running). One job per
world size runs every multi-rank check and writes what it saw under the
tmp directory; the tests read it. The ranks import no JAX (JAX is imported
here only inside the fixtures of the parent process).

Configuration as tests/test_distributed.py: two_zone_test_config, n_envs
16, replay 256, batch 32, seed_steps 16, from the JAX TrainState of
PRNGKey(7) carried over through convert.py (the 1-process checkpoint the
ranks restore). SEED_STEPS schedule-table collect steps, then TRAIN_STEPS
train steps.

* N ranks against one process: the seeding (env fields, iteration counts,
  replay) bitwise; after the train steps tests/test_distributed.py's
  tolerances (reward 1e-5, temperatures 1e-4 K, replay rewards 1e-5,
  parameters 1e-5, log_alpha 1e-6), sac.step and the replay fill equal.
* 2 ranks against the JAX package's make_shardmapped_train_step on its
  8-device CPU mesh, from the same init: the same tolerances, temperatures
  at 2e-4 K (XLA contracts multiply-adds into FMAs, the port does not:
  tests/test_torch_env.py). The rollout likewise.
* Checkpoints: 2 ranks' checkpoint restores bitwise in one process and in
  2 ranks, a 1-process checkpoint restores in 2 ranks, training resumes.
* The flat replay ring (FLAT: two_zone_test_config, n_envs 4, replay 64,
  batch 8, seed_steps 0, both sides on xla_jacobi), from the JAX init of
  PRNGKey(7): after SEED_STEPS schedule-table collect steps every one of 2
  ranks holds the one-process ring bitwise (size 12); TRAIN_STEPS
  make_distributed_train_step steps within the tolerances above of one
  process and of the JAX package's make_distributed_train_step on a
  2-device CPU mesh.
"""

import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sbsim_tpu_torch import convert, rng
from sbsim_tpu_torch.agents import schedule_policy
from sbsim_tpu_torch.agents import train as ttrain
from sbsim_tpu_torch.distributed import mesh as mesh_lib
from sbsim_tpu_torch.distributed import runtime
from sbsim_tpu_torch.envs import building_env, presets
from sbsim_tpu_torch.io.checkpoint import TrainCheckpointer

CFG = dict(n_envs=16, replay_capacity=256, batch_size=32, seed_steps=16)
SEED_STEPS, TRAIN_STEPS, ROLLOUT_STEPS = 3, 4, 4
KEY, ROLLOUT_KEY = 7, 5
TIMEOUT = 240.0  # seconds, a whole job; the collectives' deadline too
WORLDS = (2, 4)
# tests/test_distributed.py's tolerances; temperatures against JAX 2e-4 K.
REWARD_ATOL, TEMP_ATOL, PARAM_ATOL, ALPHA_ATOL, JAX_TEMP_ATOL = 1e-5, 1e-4, 1e-5, 1e-6, 2e-4
FLAT = dict(n_envs=4, replay_capacity=64, batch_size=8, seed_steps=0, replay_layout="flat",
            env_solver="xla_jacobi")
TRAIN_SAC_ARGS = ["--small", "--cpu", "--n_envs", "4", "--batch_size", "8",
                  "--replay_capacity", "64", "--seed_episodes_steps", "8", "--train_steps",
                  "3", "--eval_every", "2", "--eval_steps", "2"]


def _trainer(**over):
    env = building_env.BuildingEnv(presets.two_zone_test_config(), device="cpu")
    return ttrain.SACTrainer(env, ttrain.TrainConfig(**{**CFG, **over}))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)  # a copy: CPU tensors share memory
    return out


def _save(path, tree):
    np.savez(path, **_flat(tree))


def _load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _state_tree(state, trainer):
    return convert.train_state_to_numpy(state, trainer)


def _equal(a, b):
    """Keys whose arrays differ (NaN equal to NaN)."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].shape != b[k].shape
                  or not np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"))


# ---------------------------------------------------------------------------
# The ranks' program
# ---------------------------------------------------------------------------


def _rank_job(rank, world, out, init):
    """One rank of a job: every multi-rank check, results under `out`;
    `init` holds the 1-process checkpoint of the JAX init."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    store = f"file://{out}/store"
    res = {"created": runtime.initialize(backend="gloo", init_method=store, timeout=TIMEOUT)}
    res["again"] = runtime.initialize(backend="gloo", init_method=store, timeout=TIMEOUT)
    res["info"] = runtime.process_info()
    mesh = mesh_lib.make_mesh()
    trainer = _trainer()
    env = trainer.env
    table = schedule_policy.build_schedule_actions(env)

    def dump(name, state):  # every rank gathers, rank 0 writes
        whole = _state_tree(mesh_lib.gather_train_state(state, mesh), trainer)
        if rank == 0:
            _save(f"{out}/{name}.npz", whole)

    # The 1-process checkpoint of the JAX init, restored onto the mesh.
    template = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(99)), mesh)
    state = TrainCheckpointer(init, trainer, mesh=mesh).restore(template, 0)
    _save(f"{out}/shard{rank}.npz", _state_tree(state, trainer))
    dump("gathered_init", state)

    seed = mesh_lib.make_distributed_collect_step(trainer, mesh, table)
    rewards = []
    for _ in range(SEED_STEPS):
        state, m = seed(state)
        rewards.append(float(m["reward_mean"]))
    dump("seeded", state)
    step = mesh_lib.make_shardmapped_train_step(trainer, mesh, state)
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state)
        metrics.append({k: float(v) for k, v in m.items()})
    dump("trained", state)
    res.update(seed_rewards=rewards, metrics=metrics, env_steps=state.env_steps)

    # A checkpoint of the ranks, restored in the ranks; one more step.
    ckpt = TrainCheckpointer(f"{out}/ckpt", trainer, mesh=mesh)
    ckpt.save(SEED_STEPS + TRAIN_STEPS, state)
    restored = ckpt.restore(template)
    res["restored_diff"] = _equal(_flat(_state_tree(restored, trainer)),
                                  _flat(_state_tree(state, trainer)))
    cont, m = step(restored)
    res["resumed"] = [cont.env_steps, float(m["reward_mean"])]

    # The rollout on this rank's rows.
    states, _ = env.reset(rng.split(rng.PRNGKey(ROLLOUT_KEY), CFG["n_envs"]))
    roll = mesh_lib.make_shardmapped_rollout(env, mesh, table, ROLLOUT_STEPS)
    states, reward = roll(mesh_lib.shard_rows(states, mesh))
    states = mesh_lib.gather_rows(states, mesh)
    if rank == 0:
        _save(f"{out}/rollout.npz", convert.env_state_to_numpy(states))
    res["rollout_reward"] = float(reward)

    if world == 2:
        res.update(_solver_and_entry(mesh, out))
        _flat_ring(mesh, out, init)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    runtime.shutdown()


def _flat_ring(mesh, out, init):
    """The flat ring on the mesh from the JAX init: each rank's own ring
    after the seeding, the gathered state after make_distributed_train_step."""
    trainer = _trainer(**FLAT)
    template = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(99)), mesh)
    state = TrainCheckpointer(f"{init}/flat", trainer, mesh=mesh).restore(template, 0)
    seed = mesh_lib.make_distributed_collect_step(
        trainer, mesh, schedule_policy.build_schedule_actions(trainer.env))
    for _ in range(SEED_STEPS):
        state, _ = seed(state)
    _save(f"{out}/flat_ring{mesh.rank}.npz", _state_tree(state, trainer)["replay"])
    step = mesh_lib.make_distributed_train_step(trainer, mesh)
    for _ in range(TRAIN_STEPS):
        state, _ = step(state)
    whole = _state_tree(mesh_lib.gather_train_state(state, mesh), trainer)
    if mesh.rank == 0:
        _save(f"{out}/flat_trained.npz", whole)


def _solver_and_entry(mesh, out):
    """make_distributed_train_step keeps pallas_env (the kernel's plain
    version on the CPU); train_sac.main on the group, TensorBoard blocked."""
    from sbsim_tpu_torch.examples import train_sac
    from sbsim_tpu_torch.physics import fdm_cuda

    calls = []
    plain = fdm_cuda.fdm_jacobi_plain
    fdm_cuda.fdm_jacobi_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
    trainer = _trainer(env_solver="pallas_env")
    state = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(0)), mesh)
    mesh_lib.make_distributed_train_step(trainer, mesh)(state)
    fdm_cuda.fdm_jacobi_plain = plain
    sys.modules["torch.utils.tensorboard"] = None
    run = train_sac.main(TRAIN_SAC_ARGS + ["--output_dir", f"{out}/train_sac"])
    return {"pallas_env_calls": len(calls), "entry_env_steps": run.state.env_steps,
            "entry_rows": int(run.state.last_obs.shape[0])}


# ---------------------------------------------------------------------------
# The parent: JAX and the one-process port on the same init
# ---------------------------------------------------------------------------


def _jax_init(init):
    """The JAX trainer and its init, saved as the ranks' 1-process
    checkpoint."""
    import jax

    from sbsim_tpu.agents.train import SACTrainer, TrainConfig
    from sbsim_tpu.envs import presets as jpresets
    from sbsim_tpu.envs.building_env import BuildingEnv

    trainer = SACTrainer(BuildingEnv(jpresets.two_zone_test_config()), TrainConfig(**CFG))
    state = jax.jit(trainer.init)(jax.random.PRNGKey(KEY))
    port = _trainer()
    TrainCheckpointer(init, port).save(0, convert.train_state_from_numpy(_jax_tree(state), port))
    return trainer, state


def _jax_flat_init(init):
    """The JAX flat-ring trainer and its init from PRNGKey(KEY), saved as the
    ranks' 1-process checkpoint."""
    import jax

    from sbsim_tpu.agents.train import SACTrainer, TrainConfig
    from sbsim_tpu.envs import presets as jpresets
    from sbsim_tpu.envs.building_env import BuildingEnv

    trainer = SACTrainer(BuildingEnv(jpresets.two_zone_test_config()),
                         TrainConfig(**{**CFG, **FLAT}))
    state = jax.jit(trainer.init)(jax.random.PRNGKey(KEY))
    port = _trainer(**FLAT)
    TrainCheckpointer(f"{init}/flat", port).save(
        0, convert.train_state_from_numpy(_jax_tree(state), port))
    return trainer, state


def _jax_flat_runs(trainer, state):
    """Schedule-table seeding, then make_distributed_train_step on a
    2-device CPU mesh (GSPMD)."""
    import jax

    from sbsim_tpu.agents import schedule_policy as jsched
    from sbsim_tpu.distributed import mesh as jmesh

    seed = jax.jit(trainer.seed_with_actions(state, jsched.build_schedule_actions(trainer.env)))
    for _ in range(SEED_STEPS):
        state, _ = seed(state)
    mesh = jmesh.make_mesh(np.asarray(jax.devices()[:2]))
    step = jmesh.make_distributed_train_step(trainer, mesh)
    for _ in range(TRAIN_STEPS):
        state, _ = step(state)
    return _flat(_jax_tree(state))


def _one_process_flat(init):
    """The one-process port of the flat ring from the same init."""
    trainer = _trainer(**FLAT)
    state = TrainCheckpointer(f"{init}/flat", trainer).restore(trainer.init(rng.PRNGKey(99)), 0)
    seed = trainer.seed_with_actions(state, schedule_policy.build_schedule_actions(trainer.env))
    for _ in range(SEED_STEPS):
        state, _ = seed(state)
    ring = _flat(_state_tree(state, trainer)["replay"])
    for _ in range(TRAIN_STEPS):
        state, _ = trainer.train_step(state)
    return {"ring": ring, "trained": _flat(_state_tree(state, trainer))}


def _jax_tree(state):
    import flax.serialization
    import jax

    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _jax_runs(trainer, state):
    """Schedule-table seeding, then the shard_map train steps on the
    8-device mesh; the shard_map rollout."""
    import jax

    from sbsim_tpu.agents import schedule_policy as jsched
    from sbsim_tpu.distributed import mesh as jmesh

    env = trainer.env
    table = jsched.build_schedule_actions(env)
    seed = jax.jit(trainer.seed_with_actions(state, table))
    for _ in range(SEED_STEPS):
        state, _ = seed(state)
    mesh = jmesh.make_mesh()
    step = jmesh.make_shardmapped_train_step(trainer, mesh, state.replay)
    state = jmesh.shard_train_state(state, mesh)
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state)
        metrics.append({k: float(v) for k, v in m.items()})
    keys = jax.random.split(jax.random.PRNGKey(ROLLOUT_KEY), CFG["n_envs"])
    states, _ = jax.jit(jax.vmap(env.reset))(keys)
    states, reward = jmesh.make_shardmapped_rollout(env, mesh, table, ROLLOUT_STEPS)(states)
    return {"trained": _flat(_jax_tree(state)), "metrics": metrics,
            "rollout": _flat(_jax_tree(states)), "rollout_reward": float(reward)}


def _one_process(init):
    """The one-process port from the same init: seeding, train steps, and
    the rollout's plain step_batched."""
    trainer = _trainer()
    ckpt = TrainCheckpointer(init, trainer)
    state = ckpt.restore(trainer.init(rng.PRNGKey(99)), 0)
    init = _flat(_state_tree(state, trainer))
    seed = trainer.seed_with_actions(state, schedule_policy.build_schedule_actions(trainer.env))
    for _ in range(SEED_STEPS):
        state, _ = seed(state)
    seeded = _flat(_state_tree(state, trainer))
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = trainer.train_step(state)
        metrics.append({k: float(v) for k, v in m.items()})
    env = trainer.env
    table = torch.as_tensor(schedule_policy.build_schedule_actions(env))
    states, _ = env.reset(rng.split(rng.PRNGKey(ROLLOUT_KEY), CFG["n_envs"]))
    rewards = []
    for _ in range(ROLLOUT_STEPS):
        act = table[torch.clamp(states.step_idx.long(), 0, table.shape[0] - 1)]
        states, o = env.step_batched(states, act)
        rewards.append(torch.mean(o.reward))
    return {"init": init, "seeded": seeded, "trained": _flat(_state_tree(state, trainer)),
            "metrics": metrics, "rollout": _flat(convert.env_state_to_numpy(states)),
            "rollout_reward": float(torch.mean(torch.stack(rewards)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both jobs, run while the parent computes JAX and the one process."""
    init = str(tmp_path_factory.mktemp("init"))
    outs = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    jax_trainer, jax_state = _jax_init(init)
    jax_flat = _jax_flat_init(init)
    errors = {}

    def job(w):
        try:
            runtime.spawn(_rank_job, w, (str(outs[w]), init), timeout=TIMEOUT)
        except RuntimeError as exc:
            errors[w] = exc

    threads = [threading.Thread(target=job, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    try:
        ref = _one_process(init)
        ref["flat"] = _one_process_flat(init)
        jax_ref = _jax_runs(jax_trainer, jax_state)
        jax_ref["flat"] = _jax_flat_runs(*jax_flat)
    finally:
        for t in threads:
            t.join(TIMEOUT + 30)
    assert not errors and not any(t.is_alive() for t in threads), errors
    ranks = {w: [json.loads((outs[w] / f"rank{r}.json").read_text()) for r in range(w)]
             for w in WORLDS}
    return dict(outs=outs, ref=ref, jax=jax_ref, ranks=ranks)


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_vars(monkeypatch):
    for name in _VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_initialize_alone_is_a_noop(no_vars):
    assert runtime.initialize() is False
    assert not dist.is_initialized()
    assert runtime.process_info() == {"process_index": 0, "process_count": 1,
                                      "local_devices": 1, "global_devices": 1}
    mesh = mesh_lib.make_mesh()
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)


def test_make_mesh_places_the_rows_on_the_given_devices(no_vars):
    """`devices` names one device per rank (the JAX package's device list);
    shard_train_state copies this rank's rows there."""
    mesh = mesh_lib.make_mesh(["cpu"])
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="2 devices for a mesh of 1"):
        mesh_lib.make_mesh(["cpu", "cpu"])
    trainer = _trainer()
    state = trainer.init(rng.PRNGKey(0))
    sharded = mesh_lib.shard_train_state(state, mesh)
    assert sharded.last_obs.device == mesh.device
    assert sharded.last_obs.data_ptr() != state.last_obs.data_ptr()  # a copy
    assert torch.equal(sharded.last_obs, state.last_obs)


def test_initialize_without_a_card_or_the_cpu_raises(no_vars, tmp_path):
    no_vars.setenv("WORLD_SIZE", "2")
    no_vars.setenv("RANK", "0")
    no_vars.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        runtime.initialize(init_method=f"file://{tmp_path}/store")
    assert not dist.is_initialized()


def test_initialize_needs_rank_and_rendezvous(no_vars):
    with pytest.raises(ValueError, match="rank"):
        runtime.initialize(backend="gloo", world_size=2)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        runtime.initialize(backend="gloo", world_size=2, rank=0)
    assert not dist.is_initialized()


def test_ranks_from_environment_variables(runs):
    for w in WORLDS:
        for r, res in enumerate(runs["ranks"][w]):
            assert res["created"] is True and res["again"] is False
            assert res["info"] == {"process_index": r, "process_count": w,
                                   "local_devices": 1, "global_devices": w}


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------


def test_every_env_state_leaf_shards_on_the_env_axis():
    """Every EnvState leaf (episode_windows > 1 too) has the env axis
    first: the rank blocks of shard_rows concatenate to the batch."""
    cfg = dataclasses.replace(presets.two_zone_test_config(), episode_windows=4,
                              window_stride_hours=24.0)
    env = building_env.BuildingEnv(cfg, device="cpu")
    states, _ = env.reset(rng.split(rng.PRNGKey(3), 8))
    want = _flat(convert.env_state_to_numpy(states))
    assert all(v.shape[0] == 8 for v in want.values())
    blocks = [_flat(convert.env_state_to_numpy(mesh_lib.shard_rows(
        states, mesh_lib.Mesh(group=None, rank=r, size=2)))) for r in range(2)]
    got = {k: np.concatenate([b[k] for b in blocks]) for k in want}
    assert _equal(got, want) == []
    assert len(set(want["window"].tolist())) > 1


def test_one_process_checkpoint_restores_sharded_in_ranks(runs):
    """Each rank's restored init holds its rows of the env states,
    observations and per-env sub-rings, and the replicated rest whole."""
    init = runs["ref"]["init"]
    for w in WORLDS:
        for r in range(w):
            shard = _load(runs["outs"][w] / f"shard{r}.npz")
            for k, v in init.items():
                rows = k.startswith(("env_states/", "last_obs", "replay/data/"))
                n = v.shape[0] // w if rows else None
                want = v[r * n:(r + 1) * n] if rows else v
                assert np.array_equal(shard[k], want), (w, r, k)


def test_gather_of_the_shards_is_the_state(runs):
    for w in WORLDS:
        assert _equal(_load(runs["outs"][w] / "gathered_init.npz"), runs["ref"]["init"]) == []


def test_world_size_one_is_bitwise_train_step():
    """A one-rank mesh (no group): shard_train_state and the shard_map
    step give trainer.train_step bitwise, state and metrics."""
    trainer = _trainer()
    mesh = mesh_lib.make_mesh()
    a = trainer.init(rng.PRNGKey(KEY))
    b = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(KEY)), mesh)
    step = mesh_lib.make_shardmapped_train_step(trainer, mesh, b)
    for _ in range(4):
        a, ma = trainer.train_step(a)
        b, mb = step(b)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert int(a.sac.step) == 4
    assert _equal(_flat(_state_tree(a, trainer)), _flat(_state_tree(b, trainer))) == []


# ---------------------------------------------------------------------------
# N ranks against one process and against JAX
# ---------------------------------------------------------------------------


def _close(got, want, label, temp_atol):
    np.testing.assert_allclose(got["env_states/temp"], want["env_states/temp"], rtol=0,
                               atol=temp_atol, err_msg=label)
    np.testing.assert_allclose(got["replay/data/reward"], want["replay/data/reward"], rtol=0,
                               atol=REWARD_ATOL, err_msg=label)
    for k in want:
        if k.startswith(("sac/actor_params/", "sac/critic_params/")):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{label} {k}")
    np.testing.assert_allclose(got["sac/log_alpha"], want["sac/log_alpha"], rtol=0,
                               atol=ALPHA_ATOL, err_msg=label)
    for k in ("sac/step", "replay/size", "replay/insert_index", "env_steps", "rng"):
        assert np.array_equal(got[k], want[k]), f"{label} {k}"


@pytest.mark.parametrize("world", WORLDS)
def test_seeding_is_bitwise_one_process(runs, world):
    got = _load(runs["outs"][world] / "seeded.npz")
    assert _equal(got, runs["ref"]["seeded"]) == []


@pytest.mark.parametrize("world", WORLDS)
def test_train_steps_within_the_jax_tests_tolerances_of_one_process(runs, world):
    got = _load(runs["outs"][world] / "trained.npz")
    _close(got, runs["ref"]["trained"], f"{world} ranks", TEMP_ATOL)
    assert int(got["sac/step"]) == TRAIN_STEPS
    for res in runs["ranks"][world]:
        assert res["metrics"] == runs["ranks"][world][0]["metrics"]  # replicated
        for m, want in zip(res["metrics"], runs["ref"]["metrics"]):
            np.testing.assert_allclose(m["reward_mean"], want["reward_mean"], rtol=0,
                                       atol=REWARD_ATOL)
            assert m["critic_loss"] != 0.0


def test_two_ranks_meet_the_jax_shardmapped_train_step(runs):
    got = _load(runs["outs"][2] / "trained.npz")
    _close(got, runs["jax"]["trained"], "against JAX", JAX_TEMP_ATOL)
    for m, want in zip(runs["ranks"][2][0]["metrics"], runs["jax"]["metrics"]):
        np.testing.assert_allclose(m["reward_mean"], want["reward_mean"], rtol=0,
                                   atol=REWARD_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_rollout_is_bitwise_one_process(runs, world):
    got = _load(runs["outs"][world] / "rollout.npz")
    assert _equal(got, runs["ref"]["rollout"]) == []
    for res in runs["ranks"][world]:
        np.testing.assert_allclose(res["rollout_reward"], runs["ref"]["rollout_reward"],
                                   rtol=0, atol=1e-6)


def test_two_rank_rollout_meets_the_jax_shardmapped_rollout(runs):
    got, want = _load(runs["outs"][2] / "rollout.npz"), runs["jax"]["rollout"]
    np.testing.assert_allclose(got["temp"], want["temp"], rtol=0, atol=JAX_TEMP_ATOL)
    assert np.array_equal(got["fdm_iterations"], want["fdm_iterations"])
    np.testing.assert_allclose(runs["ranks"][2][0]["rollout_reward"],
                               runs["jax"]["rollout_reward"], rtol=0, atol=1e-6)


def test_distributed_train_step_keeps_its_solver(runs):
    """The counterpart of test_gspmd_trainer_forces_xla_solver: nothing is
    rerouted, the pallas_env step runs K2 (its plain version here) once
    per step on each rank."""
    assert [r["pallas_env_calls"] for r in runs["ranks"][2]] == [1, 1]


def test_flat_ring_on_two_ranks_is_the_one_process_ring(runs):
    """Every rank's replicated flat ring holds all n_envs rows of each
    collect step, bitwise the one-process ring."""
    want = runs["ref"]["flat"]["ring"]
    assert int(want["size"]) == SEED_STEPS * FLAT["n_envs"] == 12
    for r in range(2):
        assert _equal(_load(runs["outs"][2] / f"flat_ring{r}.npz"), want) == [], r


@pytest.mark.parametrize("against", ["one process", "JAX"])
def test_flat_ring_distributed_train_step(runs, against):
    """make_distributed_train_step on the flat ring: 2 ranks within
    tests/test_distributed.py's tolerances of one process, and of the JAX
    package's GSPMD step on a 2-device mesh (temperatures at 2e-4 K)."""
    got = _load(runs["outs"][2] / "flat_trained.npz")
    want = runs["ref"]["flat"]["trained"] if against == "one process" else runs["jax"]["flat"]
    _close(got, want, f"flat ring against {against}",
           TEMP_ATOL if against == "one process" else JAX_TEMP_ATOL)
    assert int(got["sac/step"]) == TRAIN_STEPS
    assert int(got["replay/size"]) == (SEED_STEPS + TRAIN_STEPS) * FLAT["n_envs"]


def test_groupless_mesh_runs_the_plain_steps():
    """A mesh without a group runs the plain collect step and
    trainer.train_step (as captured programs, which call them directly on
    the CPU), the flat ring included."""
    trainer = _trainer(**FLAT)
    mesh = mesh_lib.make_mesh()
    a = trainer.init(rng.PRNGKey(KEY))
    b = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(KEY)), mesh)
    table = schedule_policy.build_schedule_actions(trainer.env)
    seed_a = trainer.seed_with_actions(a, table).eager
    seed_b = mesh_lib.make_distributed_collect_step(trainer, mesh, table)
    for _ in range(2):
        a, _ = seed_a(a)
        b, _ = seed_b(b)
    assert _equal(_flat(_state_tree(a, trainer)), _flat(_state_tree(b, trainer))) == []
    a, _ = trainer.train_step(a)
    b, _ = mesh_lib.make_distributed_train_step(trainer, mesh)(b)
    assert _equal(_flat(_state_tree(a, trainer)), _flat(_state_tree(b, trainer))) == []


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_of_ranks_restores_in_one_process(runs):
    trainer = _trainer()
    for w in WORLDS:
        ckpt = TrainCheckpointer(str(runs["outs"][w] / "ckpt"), trainer)
        restored = ckpt.restore(trainer.init(rng.PRNGKey(99)))
        assert _equal(_flat(_state_tree(restored, trainer)),
                      _load(runs["outs"][w] / "trained.npz")) == []
        cont, m = trainer.train_step(restored)
        assert cont.env_steps == restored.env_steps + CFG["n_envs"]
        assert np.isfinite(float(m["reward_mean"]))


def test_checkpoint_of_ranks_restores_in_the_ranks(runs):
    for w in WORLDS:
        for res in runs["ranks"][w]:
            assert res["restored_diff"] == []
            env_steps, reward = res["resumed"]
            assert env_steps == res["env_steps"] + CFG["n_envs"]
            assert np.isfinite(reward)


# ---------------------------------------------------------------------------
# Refusals and the entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["flat ring", "n_envs", "batch_size"])
def test_shardmapped_train_step_refuses(case):
    over = {"flat ring": dict(replay_layout="flat"), "n_envs": dict(n_envs=6, batch_size=12),
            "batch_size": dict(replay_layout="flat", n_envs=4, batch_size=10)}[case]
    trainer = _trainer(**over)
    fake = mesh_lib.Mesh(group=None, rank=0, size=4)
    state = trainer.init(rng.PRNGKey(0))
    with pytest.raises(ValueError, match={"flat ring": "per_env", "n_envs": "multiple of the "
                                          "mesh", "batch_size": "batch_size"}[case]):
        mesh_lib.make_shardmapped_train_step(trainer, fake, state)


def test_train_sac_on_two_ranks_writes_on_rank_0(runs):
    out = runs["outs"][2] / "train_sac"
    for res in runs["ranks"][2]:
        assert res["entry_rows"] == 2  # 4 envs over 2 ranks
        assert res["entry_env_steps"] == 4 * (8 // 4 + 3)
    with open(out / "train_metrics.jsonl") as f:
        lines = f.read().splitlines()
    assert len(lines) == 1  # one writer: rank 0's accumulator, flushed at close
    assert sorted(os.listdir(out / "ckpt")) == ["step_0000000002.npz"]

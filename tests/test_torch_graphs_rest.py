"""The rest of the JAX package's jitted programs as captured programs
(sbsim_tpu_torch/graphs.py), on the CPU: the ranks' steps
(distributed/mesh.py), the per-env step (`BuildingEnv.captured_step`), the
loaded policy (agents/policies.py) and the scripts' loops.

* Sync-free: with tests/test_torch_graphs.py's SyncGuard (every host read
  of a tensor and every tensor made from host data raises), after one
  warm-up call: the per-env step at fdm_solver "jacobi", "chebyshev" and in
  the stack layout; the greedy policy's body; the per-rank train step on
  both sides of the update gate and the collect step under a one-rank gloo
  group on the CPU, for both replay layouts; make_shardmapped_rollout; the
  swap step of conv_rounds_sweep and the learning run's rollout. Each
  result is also held against the JAX package's counterpart on the same
  inputs.
* Stub graph (tests/test_torch_graphs.py's, which replays by rerunning the
  function on the program's static inputs): the captured per-env step and
  policy return the eager results; SimulatedBuilding through its captured
  step writes the same protos and record files as through `step` op by
  op, and near the JAX package's building; all_gather_rows in its one
  tensor form is bitwise the list form it replaced, bool included, on two
  gloo ranks spawned on the CPU, and the rows the JAX package gathers from
  a 2-device mesh.
* Lifetime: the kernels' stencil planes, which a captured program reads
  by address at every replay, live as long as the env's coefficients,
  however many other envs are made after them, and go with them; and
  `runtime.shutdown` drops every captured program before the group goes.
* Against JAX: the one-rank mesh's train step against
  sbsim_tpu.distributed.mesh.make_shardmapped_train_step on a one-device
  mesh within tests/test_distributed.py's tolerances; the per-env step
  against `jax.jit(env.step)` within FIELD_ATOL (2e-4 K).

JAX is imported inside the tests only: the spawned ranks import this
module by name.
"""

import contextlib
import dataclasses
import gc
import json
import os
import weakref

import numpy as np
import pytest
import torch

from sbsim_tpu_torch import convert, graphs, rng
from sbsim_tpu_torch.agents import policies, sac as tsac
from sbsim_tpu_torch.agents import schedule_policy as tsched
from sbsim_tpu_torch.agents import train as ttrain
from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
from sbsim_tpu_torch.benchmarks import sac_sb1_train
from sbsim_tpu_torch.distributed import mesh as mesh_lib
from sbsim_tpu_torch.distributed import runtime
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import host_adapter as tha
from sbsim_tpu_torch.envs import host_environment as the
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.physics import fdm_cuda

FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_env.py)
OUT_ATOL = 1e-4
FWD_RTOL = 1e-5  # tests/test_torch_agents.py
# tests/test_distributed.py's tolerances; temperatures against JAX 2e-4 K.
REWARD_ATOL, PARAM_ATOL, ALPHA_ATOL, JAX_TEMP_ATOL = 1e-5, 1e-5, 1e-6, 2e-4
RETURN_ATOL = 1e-3  # tests/test_torch_scripts.py
STEPS = 3
TIMEOUT = 120.0  # seconds: the spawned job, and its collectives
LAYOUTS = {"jacobi": {}, "chebyshev": {"fdm_solver": "chebyshev"},
           "stack": {"pallas_block_mode": "stack", "pallas_block_envs": 2}}
RANK_CFG = dict(n_envs=4, replay_capacity=64, batch_size=8)


def _jax_modules():
    import jax

    from sbsim_tpu.envs import building_env as jbe
    from sbsim_tpu.envs import presets as jpresets

    return jax, jbe, jpresets


def _configs(layout):
    _, _, jpresets = _jax_modules()
    kw = LAYOUTS[layout]
    return (dataclasses.replace(jpresets.two_zone_test_config(), **kw),
            dataclasses.replace(tpresets.two_zone_test_config(), **kw))


def _guard(monkeypatch):
    """SyncGuard, the block kernels' plain versions (the CPU route of the
    stack layout, which reads back by design) left unguarded as the solo
    ones are."""
    from test_torch_graphs import SyncGuard

    from sbsim_tpu_torch.physics import fdm_cuda

    guard = SyncGuard(monkeypatch)
    for name in ("fdm_jacobi_block_plain", "fdm_cheby_block_plain"):
        monkeypatch.setattr(fdm_cuda, name, guard.unguarded(getattr(fdm_cuda, name)))
    return guard


def _diff(a, b, prefix=""):
    """Leaves of two nested numpy dicts that differ (NaN = NaN)."""
    out = []
    for k, x in a.items():
        if isinstance(x, dict):
            out += _diff(x, b[k], prefix + k + ".")
        elif not np.array_equal(x, b[k], equal_nan=x.dtype.kind == "f"):
            out.append(prefix + k)
    return out


def _jax_tree(state):
    import flax.serialization
    import jax

    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)
    return out


@contextlib.contextmanager
def _one_rank_group(tmp_path):
    """A one-rank gloo group in this process (a FileStore under tmp_path)."""
    runtime.initialize(backend="gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                       rank=0, timeout=TIMEOUT)
    try:
        yield mesh_lib.make_mesh()
    finally:
        runtime.shutdown()


# ---------------------------------------------------------------------------
# The per-env step
# ---------------------------------------------------------------------------


def _jax_steps(jenv, key, actions):
    """jax.jit(env.step) from reset(key), one step per action; the states."""
    jax, _, _ = _jax_modules()
    jstate, _ = jenv.reset(key)
    step = jax.jit(jenv.step)
    out = []
    for a in actions:
        jstate, jout = step(jstate, a)
        out.append((jstate, jout))
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_per_env_step_makes_no_host_sync_and_meets_jax(monkeypatch, layout):
    jax, jbe, _ = _jax_modules()
    jcfg, tcfg = _configs(layout)
    env = tbe.BuildingEnv(tcfg, device="cpu")
    actions = np.random.default_rng(5).uniform(-1, 1, (STEPS, env.n_actions)).astype(np.float32)
    state, _ = env.reset(rng.PRNGKey(6)[None])
    guard = _guard(monkeypatch)
    want = _jax_steps(jbe.BuildingEnv(jcfg), jax.random.PRNGKey(6), actions)
    for i, a in enumerate(actions):
        act = torch.as_tensor(a[None])
        state, out = guard.run_twice(lambda: env.step(state, act))
        jstate, jout = want[i]
        np.testing.assert_allclose(state.temp[0].numpy(), np.asarray(jstate.temp), rtol=0,
                                   atol=(i + 1) * FIELD_ATOL)
        np.testing.assert_allclose(out.observation[0].numpy(), np.asarray(jout.observation),
                                   rtol=0, atol=OUT_ATOL)
        assert int(state.fdm_iterations[0]) == int(jstate.fdm_iterations)


def _stub_call(monkeypatch):
    """graphs.CapturedFunction.__call__ on CPU tensors through a
    graphs.Program with tests/test_torch_graphs.py's stub graph: the first
    call is the warm-up's, every later one a replay (the function rerun on
    the program's static inputs into its static outputs)."""
    from test_torch_graphs import _StubGraphs

    def call(self, *args):
        if graphs._disabled or self.op_by_op:
            return self.eager(*args)
        leaves = []
        spec = graphs.flatten(args, leaves)
        key = (spec, tuple((t.shape, t.dtype) for t in leaves))
        program = self.programs.get(key)
        if program is None:
            program = self.programs[key] = graphs.Program(self.eager, args, spec, leaves,
                                                          self.counters, api=_StubGraphs)

            def rerun(program=program, spec=spec):
                saved = [dict(c) for c in self.counters]
                out = []
                graphs.flatten(self.eager(*graphs.unflatten(spec, iter(program.static_in))), out)
                for dst, src in zip(program.static_out, out):
                    if dst is not src:
                        dst.copy_(src)
                for c, s in zip(self.counters, saved):
                    c.update(s)

            program.graph.run = rerun
            return program.take_first()
        return program(leaves)

    monkeypatch.setattr(graphs.CapturedFunction, "__call__", call)


@pytest.mark.parametrize("layout", ["jacobi", "chebyshev"])
def test_captured_per_env_step_returns_the_eager_results(monkeypatch, layout):
    jax, jbe, _ = _jax_modules()
    jcfg, tcfg = _configs(layout)
    env = tbe.BuildingEnv(tcfg, device="cpu")
    _stub_call(monkeypatch)
    actions = np.random.default_rng(7).uniform(-1, 1, (STEPS, env.n_actions)).astype(np.float32)
    graph, _ = env.reset(rng.PRNGKey(8)[None])
    eager = graph
    want = _jax_steps(jbe.BuildingEnv(jcfg), jax.random.PRNGKey(8), actions)
    for i, a in enumerate(actions):
        act = torch.as_tensor(a[None])
        graph, gout = env.captured_step(graph, act)
        eager, eout = env.step(eager, act)
        assert not _diff(convert.env_state_to_numpy(graph), convert.env_state_to_numpy(eager))
        assert torch.equal(gout.observation, eout.observation)
        assert torch.equal(gout.reward, eout.reward)
        np.testing.assert_allclose(graph.temp[0].numpy(), np.asarray(want[i][0].temp), rtol=0,
                                   atol=(i + 1) * FIELD_ATOL)
    (program,) = env.captured_step.programs.values()
    assert program.replays == STEPS - 1
    assert env.captured_step is env.captured_step  # made once per env


def test_simulated_building_writes_the_eager_protos(monkeypatch, tmp_path):
    _, jbe, jpresets = _jax_modules()
    from sbsim_tpu.envs import host_adapter as jha
    from sbsim_tpu.envs import host_environment as jhe

    env = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    _stub_call(monkeypatch)
    actions = np.random.default_rng(9).uniform(-1, 1, (4, env.n_actions)).astype(np.float32)
    runs = {}
    for path in ("graph", "eager"):
        building = tha.SimulatedBuilding(env, seed=0)
        host = the.HostEnvironment(building, env, metrics_path=str(tmp_path / path), label="ep")
        with graphs.disabled() if path == "eager" else contextlib.nullcontext():
            steps = [host.reset()] + [host.step(a) for a in actions]
        (episode,) = os.listdir(tmp_path / path)
        folder = tmp_path / path / episode
        runs[path] = (steps, {f: (folder / f).read_bytes() for f in sorted(os.listdir(folder))},
                      building.reward_info)
    (program,) = env.captured_step.programs.values()
    assert program.replays == len(actions) - 1
    (gsteps, gfiles, ginfo), (esteps, efiles, einfo) = runs["graph"], runs["eager"]
    assert gfiles == efiles and len(gfiles) > 1
    assert ginfo == einfo
    for a, b in zip(gsteps, esteps, strict=True):
        assert (a.step_type, a.reward, a.discount) == (b.step_type, b.reward, b.discount)
        np.testing.assert_array_equal(a.observation, b.observation)
    jenv = jbe.BuildingEnv(jpresets.two_zone_test_config())
    jhost = jhe.HostEnvironment(jha.SimulatedBuilding(jenv, seed=0), jenv,
                                metrics_path=str(tmp_path / "jax"), label="ep")
    jsteps = [jhost.reset()] + [jhost.step(a) for a in actions]
    for a, b in zip(gsteps, jsteps):
        assert abs(a.reward - b.reward) <= OUT_ATOL
        np.testing.assert_allclose(a.observation, np.asarray(b.observation), atol=OUT_ATOL)


def test_stencil_planes_live_as_long_as_the_coefficients():
    """A program captured on an env replays reading its stencil planes by
    address; a cache of the last 8 coefficient sets freed them once more
    envs were made (the 126-room HostEnvironment day, replaying a program
    captured before a dozen other envs, read freed memory). The env's
    step against jax.jit(env.step) after the other envs are made."""
    jax, jbe, _ = _jax_modules()
    jcfg, tcfg = _configs("jacobi")
    env = tbe.BuildingEnv(tcfg, device="cpu")
    planes = fdm_cuda._stencil_planes(env.coeffs)
    others = [tbe.BuildingEnv(tcfg, device="cpu") for _ in range(10)]
    for other in others:
        fdm_cuda._stencil_planes(other.coeffs)
    again = fdm_cuda._stencil_planes(env.coeffs)
    assert all(a is b for a, b in zip(planes, again, strict=True))
    gone = [weakref.ref(other.coeffs) for other in others]
    del others, other
    gc.collect()
    assert all(ref() is None for ref in gone) and env.coeffs in fdm_cuda._PLANES
    actions = np.zeros((1, env.n_actions), np.float32)
    state, _ = env.reset(rng.PRNGKey(6)[None])
    state, _ = env.step(state, torch.as_tensor(actions))
    ((jstate, _),) = _jax_steps(jbe.BuildingEnv(jcfg), jax.random.PRNGKey(6), actions)
    np.testing.assert_allclose(state.temp[0].numpy(), np.asarray(jstate.temp), rtol=0,
                               atol=FIELD_ATOL)


# ---------------------------------------------------------------------------
# The loaded policy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loaded_policy(tmp_path_factory):
    """A JAX learner's actor, carried over, saved and loaded by the port;
    the JAX learner, its state and a day's worth of observations."""
    import jax

    from sbsim_tpu.agents import sac as jsac

    env = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    jl = jsac.SACLearner(env.obs_dim, env.n_actions)
    jstate = jl.init(jax.random.PRNGKey(3))
    tl = tsac.SACLearner(env.obs_dim, env.n_actions, device="cpu")
    directory = str(tmp_path_factory.mktemp("policy"))
    policies.save_policy(directory, tl, convert.sac_state_from_numpy(_jax_tree(jstate), tl),
                         env.action_names)
    policy, _ = policies.load_policy(directory, device="cpu")
    obs = np.random.default_rng(4).normal(size=(6, 1, env.obs_dim)).astype(np.float32)
    return policy, jl, jstate, obs


def test_greedy_policy_makes_no_host_sync_and_meets_jax(monkeypatch, loaded_policy):
    policy, jl, jstate, obs = loaded_policy
    guard = _guard(monkeypatch)
    for o in obs:
        x = torch.as_tensor(o)  # the wrapper's conversion, outside the program
        got = guard.run_twice(lambda: policy.program.eager(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl.act_greedy(jstate, o)),
                                   rtol=FWD_RTOL, atol=1e-6)


def test_captured_policy_returns_the_eager_results(monkeypatch, loaded_policy):
    policy, jl, jstate, obs = loaded_policy
    _stub_call(monkeypatch)
    monkeypatch.setattr(policy.program, "programs", {})
    for o in obs:
        got = policy(o)  # host data: converted by the wrapper
        assert torch.equal(got, policy.program.eager(torch.as_tensor(o)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl.act_greedy(jstate, o)),
                                   rtol=FWD_RTOL, atol=1e-6)
    (program,) = policy.program.programs.values()
    assert program.replays == len(obs) - 1


# ---------------------------------------------------------------------------
# The ranks' steps
# ---------------------------------------------------------------------------


def _rank_trainer(layout, **over):
    """The port's trainer on K2's route (its plain version here: what the
    card captures); the JAX trainer's "auto" is its XLA solver."""
    env = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    return ttrain.SACTrainer(env, ttrain.TrainConfig(
        **{**RANK_CFG, "replay_layout": layout, "seed_steps": 4 * RANK_CFG["n_envs"],
           "env_solver": "pallas_env", **over}))


def _jax_trainer(layout, **over):
    from sbsim_tpu.agents.train import SACTrainer, TrainConfig

    _, jbe, jpresets = _jax_modules()
    return SACTrainer(jbe.BuildingEnv(jpresets.two_zone_test_config()), TrainConfig(
        **{**RANK_CFG, "replay_layout": layout, "seed_steps": 4 * RANK_CFG["n_envs"], **over}))


@pytest.mark.parametrize("layout", ["per_env", "flat"])
def test_rank_steps_make_no_host_sync_and_meet_jax(monkeypatch, tmp_path, layout):
    """Under a one-rank gloo group (op by op: gloo's rule) the collect step
    and the train step on both sides of the gate run without a host read,
    their hooks and collectives included; the result against the JAX
    package's make_distributed_train_step on a one-device mesh."""
    import jax

    from sbsim_tpu.agents import schedule_policy as jsched
    from sbsim_tpu.distributed import mesh as jmesh

    trainer = _rank_trainer(layout)
    jt = _jax_trainer(layout)
    jstate = jax.jit(jt.init)(jax.random.PRNGKey(2))
    table = jsched.build_schedule_actions(jt.env)
    guard = _guard(monkeypatch)
    with _one_rank_group(tmp_path) as mesh:
        assert not runtime.captures(mesh.group)
        state = mesh_lib.shard_train_state(
            convert.train_state_from_numpy(_jax_tree(jstate), trainer), mesh)
        seed = mesh_lib.make_distributed_collect_step(trainer, mesh, table)
        step = mesh_lib.make_distributed_train_step(trainer, mesh)
        for _ in range(2):
            state, _ = guard.run_twice(lambda: seed(state))
        sides = []
        for _ in range(2):
            state, m = guard.run_twice(lambda: step(state))
            sides.append(bool(m["critic_loss"] != 0))
    assert sides == [False, True]
    jseed = jax.jit(jt.seed_with_actions(jstate, table))
    for _ in range(2):
        jstate, _ = jseed(jstate)
    jstep = jmesh.make_distributed_train_step(jt, jmesh.make_mesh(np.asarray(jax.devices()[:1])))
    for _ in range(2):
        jstate, _ = jstep(jstate)
    got, want = _flat(convert.train_state_to_numpy(state, trainer)), _flat(_jax_tree(jstate))
    _close(got, want)


def _close(got, want):
    np.testing.assert_allclose(got["env_states/temp"], want["env_states/temp"], rtol=0,
                               atol=JAX_TEMP_ATOL)
    np.testing.assert_allclose(got["replay/data/reward"], want["replay/data/reward"], rtol=0,
                               atol=REWARD_ATOL)
    for k in want:
        if k.startswith(("sac/actor_params/", "sac/critic_params/")):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(got["sac/log_alpha"], want["sac/log_alpha"], rtol=0,
                               atol=ALPHA_ATOL)
    for k in ("sac/step", "replay/size", "replay/insert_index", "env_steps", "rng"):
        assert np.array_equal(got[k], want[k]), k


def test_one_rank_mesh_train_step_meets_the_jax_shardmapped_step(tmp_path):
    """The one-rank mesh's make_shardmapped_train_step (a gloo group: op by
    op) and the groupless mesh's (captured; on the CPU called directly)
    against sbsim_tpu.distributed.mesh.make_shardmapped_train_step on a
    one-device mesh, from the same init."""
    import jax

    from sbsim_tpu.distributed import mesh as jmesh

    trainer = _rank_trainer("per_env", seed_steps=0)
    jt = _jax_trainer("per_env", seed_steps=0)
    jstate = jax.jit(jt.init)(jax.random.PRNGKey(4))
    jm = jmesh.make_mesh(np.asarray(jax.devices()[:1]))
    jstep = jmesh.make_shardmapped_train_step(jt, jm, jstate.replay)
    jstate = jmesh.shard_train_state(jstate, jm)
    want = jstate
    for _ in range(STEPS):
        want, _ = jstep(want)
    want = _flat(_jax_tree(want))
    start = convert.train_state_from_numpy(_jax_tree(jstate), trainer)
    with _one_rank_group(tmp_path) as mesh:
        state = mesh_lib.shard_train_state(start, mesh)
        step = mesh_lib.make_shardmapped_train_step(trainer, mesh, state)
        for _ in range(STEPS):
            state, _ = step(state)
        _close(_flat(convert.train_state_to_numpy(state, trainer)), want)
    alone = mesh_lib.make_mesh()
    assert alone.group is None and runtime.captures(None)
    state = mesh_lib.shard_train_state(start, alone)
    step = mesh_lib.make_shardmapped_train_step(trainer, alone, state)
    for _ in range(STEPS):
        state, _ = step(state)
    _close(_flat(convert.train_state_to_numpy(state, trainer)), want)


def test_shardmapped_rollout_makes_no_host_sync_and_meets_jax(monkeypatch, tmp_path):
    import jax

    from sbsim_tpu.agents import schedule_policy as jsched
    from sbsim_tpu.distributed import mesh as jmesh

    _, jbe, jpresets = _jax_modules()
    jenv = jbe.BuildingEnv(jpresets.two_zone_test_config())
    env = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    table = jsched.build_schedule_actions(jenv)
    guard = _guard(monkeypatch)
    keys = rng.split(rng.PRNGKey(5), 4)
    with _one_rank_group(tmp_path) as mesh:
        roll = mesh_lib.make_shardmapped_rollout(env, mesh, table, STEPS, solver="pallas_env")
        states, _ = env.reset(keys)
        got, reward = guard.run_twice(lambda: roll(states))
    jstates, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(5), 4))
    jroll = jmesh.make_shardmapped_rollout(jenv, jmesh.make_mesh(np.asarray(jax.devices()[:1])),
                                           table, STEPS)
    want, jreward = jroll(jstates)
    np.testing.assert_allclose(got.temp.numpy(), np.asarray(want.temp), rtol=0,
                               atol=STEPS * FIELD_ATOL)
    np.testing.assert_array_equal(got.step_idx.numpy(), np.asarray(want.step_idx))
    np.testing.assert_allclose(float(reward), float(jreward), rtol=0, atol=OUT_ATOL)


def test_one_rule_decides_what_is_captured(tmp_path):
    """BuildingEnv.capture: a program through a plain solver, or through a
    gloo group's collectives (the mesh's hooks), runs op by op; through a
    kernel's route without a group (or on NCCL) it is captured."""
    env = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    for solver, plain in (("pallas_env", False), ("pallas_cheby", False),
                          ("xla_jacobi", True), ("xla_chebyshev", True)):
        assert env.capture(lambda x: x, solver).op_by_op == plain
    trainer = _rank_trainer("flat")
    table = tsched.build_schedule_actions(env)
    alone = mesh_lib.make_mesh()
    with _one_rank_group(tmp_path) as mesh:
        for m, gloo in ((alone, False), (mesh, True)):
            step = mesh_lib.make_distributed_train_step(trainer, m)
            assert [side.program.op_by_op for side in step.sides] == [gloo, gloo]
            seed = mesh_lib.make_distributed_collect_step(trainer, m, table)
            assert seed.program.op_by_op == gloo
            roll = mesh_lib.make_shardmapped_rollout(trainer.env, m, table, 2,
                                                     solver="pallas_env")
            assert roll.op_by_op == gloo
    plain = trainer.with_solver("xla_jacobi")
    assert all(side.program.op_by_op for side in plain.captured_train_step().sides)


def test_shutdown_releases_the_captured_programs(monkeypatch, tmp_path):
    """runtime.shutdown drops every captured program before it destroys the
    group (an NCCL group destroyed under a live graph of its collectives
    hangs); the next call captures again. The stub graph's step against
    jax.jit(env.step)."""
    jax, jbe, _ = _jax_modules()
    jcfg, tcfg = _configs("jacobi")
    env = tbe.BuildingEnv(tcfg, device="cpu")
    _stub_call(monkeypatch)
    act = torch.zeros((1, env.n_actions))
    start, _ = env.reset(rng.PRNGKey(6)[None])
    with _one_rank_group(tmp_path):
        env.captured_step(start, act)
        (program,) = env.captured_step.programs.values()
    assert not env.captured_step.programs and program.graph.run is None
    state, _ = env.captured_step(start, act)
    assert len(env.captured_step.programs) == 1
    ((jstate, _),) = _jax_steps(jbe.BuildingEnv(jcfg), jax.random.PRNGKey(6),
                                act.numpy())
    np.testing.assert_allclose(state.temp[0].numpy(), np.asarray(jstate.temp), rtol=0,
                               atol=FIELD_ATOL)


# ---------------------------------------------------------------------------
# all_gather_rows on two ranks
# ---------------------------------------------------------------------------

GATHER_SEED = 11


def _gather_inputs(rank):
    g = np.random.default_rng(GATHER_SEED)
    whole = {"f32": g.normal(size=(4, 3)).astype(np.float32),
             "i64": g.integers(-9, 9, size=(4, 2, 2)),
             "bool": g.uniform(size=(4, 5)) > 0.5}
    return whole, {k: torch.as_tensor(v[2 * rank:2 * rank + 2]) for k, v in whole.items()}


def _old_all_gather_rows(x, group):
    """The list form all_gather_rows replaced."""
    import torch.distributed as dist

    src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts).to(x.device)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def _gather_rank(rank, world, out):
    torch.set_num_threads(1)
    runtime.initialize(backend="gloo", init_method=f"file://{out}/store", world_size=world,
                       rank=rank, timeout=TIMEOUT)
    try:
        import torch.distributed as dist

        _, mine = _gather_inputs(rank)
        res = {}
        for k, x in mine.items():
            new = runtime.all_gather_rows(x, dist.group.WORLD)
            old = _old_all_gather_rows(x, dist.group.WORLD)
            res[k] = {"dtype": str(new.dtype), "same": bool(new.dtype == old.dtype
                                                            and torch.equal(new, old)),
                      "rows": new.to(torch.float64).tolist()}
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        runtime.shutdown()


def test_all_gather_rows_one_tensor_form_is_the_list_form(tmp_path):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    runtime.spawn(_gather_rank, 2, (str(tmp_path),), timeout=TIMEOUT)
    whole, _ = _gather_inputs(0)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("env",))
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        for k, v in whole.items():
            assert res[k]["same"], (r, k)
            assert res[k]["dtype"] == str(torch.as_tensor(v).dtype)
            # The rows the JAX package gathers from the env-sharded array.
            sharded = jax.device_put(v, NamedSharding(mesh, PartitionSpec("env")))
            np.testing.assert_array_equal(np.asarray(res[k]["rows"]),
                                          np.asarray(sharded).astype(np.float64))


# ---------------------------------------------------------------------------
# The scripts' loops
# ---------------------------------------------------------------------------


def test_swap_program_makes_no_host_sync_and_meets_jax(monkeypatch):
    from test_torch_scripts import _jax_run_swap, _two_zone

    _, _, jpresets = _jax_modules()
    monkeypatch.setattr(crs, "N_STEPS", STEPS)
    env = tbe.BuildingEnv(_two_zone(tpresets), device="cpu")
    action = torch.as_tensor(env.default_action(crs.SETPOINTS))[None].expand(crs.SEEDS, -1)
    action = action.contiguous()
    states, _ = env.reset(rng.split(rng.PRNGKey(crs.SWAP_KEY), crs.SEEDS))
    step = crs.swap_step(env)

    def roll():
        st = states
        for _ in range(crs.N_STEPS):
            st = step.eager(st, action)
        return st

    guard = _guard(monkeypatch)
    got = guard.run_twice(roll)
    swap, _ = crs.run_swap(_two_zone(tpresets), device="cpu")
    np.testing.assert_array_equal(got.temp.numpy(), swap)
    jswap, _ = _jax_run_swap(_two_zone(jpresets))
    np.testing.assert_allclose(swap, jswap, rtol=0, atol=STEPS * FIELD_ATOL)


def test_learning_rollout_makes_no_host_sync_and_meets_jax(monkeypatch):
    """sac_sb1_train's rollout body (the schedule table and a one-row
    constant table) through K2's route, against the JAX script's closures
    (the same steps under jax.jit, the XLA solver: FIELD_ATOL a step)."""
    import jax
    import jax.numpy as jnp

    from sbsim_tpu.agents import schedule_policy as jsched

    _, jbe, jpresets = _jax_modules()
    jenv = jbe.BuildingEnv(jpresets.two_zone_test_config())
    env = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    sched = jsched.build_schedule_actions(jenv)
    np.testing.assert_array_equal(tsched.build_schedule_actions(env), sched)
    const = np.asarray([[0.5, -0.25]], np.float32)
    key = rng.PRNGKey(7)
    guard = _guard(monkeypatch)
    for table in (sched, const):
        t = torch.as_tensor(table, dtype=torch.float32)
        states, rewards = guard.run_twice(
            lambda: sac_sb1_train._rollout(sac_sb1_train.rollout_step(env, "pallas_env").eager,
                                           env, t, key, STEPS, 2))
        jtable = jnp.asarray(table)

        def body(s, _):
            a = jtable[jnp.clip(s.step_idx, 0, jtable.shape[0] - 1)]
            s, out = jenv.step_batched(s, a, solver="xla_jacobi")
            return s, out.reward

        @jax.jit
        def run(k):
            s, _ = jax.vmap(jenv.reset)(jax.random.split(k, 2))
            return jax.lax.scan(body, s, None, length=STEPS)

        jstates, jrewards = run(jax.random.PRNGKey(7))
        np.testing.assert_allclose(states.temp.numpy(), np.asarray(jstates.temp), rtol=0,
                                   atol=STEPS * FIELD_ATOL)
        np.testing.assert_allclose(rewards.numpy(), np.asarray(jrewards), rtol=0, atol=OUT_ATOL)
        # The script's entry, on the CPU the plain solver op by op.
        _, again = sac_sb1_train.rollout(env, table, key, STEPS, 2, "pallas_env")
        assert torch.equal(again, rewards)
    assert abs(sac_sb1_train.constant_return(env, const[0], key, STEPS, 2)
               - float(jnp.mean(jnp.sum(run(jax.random.PRNGKey(7))[1], axis=0)))) <= RETURN_ATOL

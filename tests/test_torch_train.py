"""The port's trainer and the kernels' statistics against the JAX package,
on the CPU.

* SACTrainer: a JAX TrainState (two-zone test plan and the 12-zone sb1
  plan, n_envs=4, batch_size=8, solver xla_jacobi) is carried into the
  port, and both take 3 train_steps. Keys, counts and replay cursors are
  exact. The env side inherits the one-solve bound of
  tests/test_torch_env.py (XLA:CPU contracts FMAs, the port does not), and
  the policy's Gaussian noise differs from jax.random.normal by a few ulps
  (XLA fuses the erfinv polynomial), so observations, rewards and actions
  in the replay ring are held to REPLAY_ATOL, and the SAC metrics, which
  see those inputs through two updates, to METRIC_RTOL.
* The schedule baseline's action table equals the JAX one exactly.
* The statistics of fdm_step_cuda(stat_layout=...): on CPU tensors the
  plain epilogue equals the gridstats fold bitwise and, on the JAX
  kernel's own field, the JAX kernel's sums (fdm_step_pallas in interpret
  mode) bitwise; on the port's field, those sums within SUM_RTOL.
* step_batched takes its statistics from the kernel by the JAX rule
  (building_env.py:441-447).
"""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.agents import schedule_policy as jsched
from sbsim_tpu.agents import train as jtrain
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.physics import convection as jconv
from sbsim_tpu.physics import fdm_pallas
from sbsim_tpu.physics import gridstats as jgs
from sbsim_tpu_torch import convert, rng
from sbsim_tpu_torch.agents import schedule_policy as tsched
from sbsim_tpu_torch.agents import train as ttrain
from sbsim_tpu_torch.core import geometry as tgeo
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.physics import fdm_cuda, gridstats as tgs

N_ENVS, BATCH, STEPS = 4, 8, 3
REPLAY_ATOL = 1e-4  # observations/rewards (tests/test_torch_env.py OUT_ATOL)
METRIC_RTOL = 1e-3
SUM_RTOL = 2e-6  # zone sums of fields that agree within 2e-4 K at ~294 K


def _tree(x):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(x))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


PRESETS = {
    "two_zone": lambda lib: lib.two_zone_test_config(),
    "sb1": lambda lib: lib.sb1_config(num_days_in_episode=1),
}


def _trainers(name):
    make = PRESETS[name]
    jenv = jbe.BuildingEnv(make(jpresets))
    tenv = tbe.BuildingEnv(make(tpresets), device="cpu")
    kw = dict(n_envs=N_ENVS, batch_size=BATCH, replay_capacity=64, seed_steps=0,
              env_solver="xla_jacobi")
    jt = jtrain.SACTrainer(jenv, jtrain.recipe_for(jenv, **kw))
    tt = ttrain.SACTrainer(tenv, ttrain.recipe_for(tenv, **kw))
    return name, jt, tt


@pytest.fixture(scope="module", params=sorted(PRESETS))
def trainers(request):
    return _trainers(request.param)


def test_three_train_steps_match_jax(trainers):
    name, jt, tt = trainers
    jstate = jax.jit(jt.init)(jax.random.PRNGKey(11))
    tstate = convert.train_state_from_numpy(_tree(jstate), tt)
    train_step = jax.jit(jt.train_step)
    for step in range(STEPS):
        jstate, jm = train_step(jstate)
        tstate, tm = tt.train_step(tstate)
        want = _tree(jstate)
        got = dict(_flat(convert.train_state_to_numpy(tstate, tt)))
        for key in ("rng", "env_steps", "replay/insert_index", "replay/size",
                    "env_states/rng", "env_states/step_idx", "sac/step",
                    "sac/critic_opt/0/count"):
            np.testing.assert_array_equal(got[key], dict(_flat(want))[key], err_msg=key)
        for field in ("obs", "action", "reward", "discount", "next_obs"):
            k = f"replay/data/{field}"
            np.testing.assert_allclose(got[k], dict(_flat(want))[k], rtol=0,
                                       atol=REPLAY_ATOL, err_msg=f"{name} step {step} {k}")
        for metric, value in jm.items():
            np.testing.assert_allclose(float(tm[metric]), float(value), rtol=METRIC_RTOL,
                                       atol=1e-6, err_msg=f"{name} step {step} {metric}")
    assert float(tm["alpha"]) != 1.0
    assert int(tstate.replay.size) == STEPS


def test_seed_with_schedule_and_evaluate():
    # The sb1 schedule table is held to JAX's in test_schedule_table_equals_jax.
    name, jt, tt = _trainers("two_zone")
    jstate = jax.jit(jt.init)(jax.random.PRNGKey(3))
    tstate = convert.train_state_from_numpy(_tree(jstate), tt)
    jtable = jsched.build_schedule_actions(jt.env)
    ttable = tsched.build_schedule_actions(tt.env)
    np.testing.assert_array_equal(ttable, jtable)
    jstep = jax.jit(jt.seed_with_actions(jstate, jtable))
    tstep = tt.seed_with_actions(tstate, ttable)
    for _ in range(2):
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        np.testing.assert_allclose(float(tm["reward_mean"]), float(jm["reward_mean"]),
                                   rtol=0, atol=REPLAY_ATOL)
    np.testing.assert_array_equal(tstate.replay.data.action.numpy(),
                                  np.asarray(jstate.replay.data.action))
    want = jax.jit(jt.evaluate, static_argnums=(2, 3))(jstate.sac, jax.random.PRNGKey(5), 2, 2)
    got = tt.evaluate(tstate.sac, rng.PRNGKey(5), n_steps=2, n_envs=2)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=2 * REPLAY_ATOL)


@pytest.mark.parametrize("start", ["2023-07-06 07:00:00+00:00", "2023-12-22 12:00:00",
                                   "2024-05-24 20:00:00-07:00"])
def test_schedule_table_equals_jax(start):
    def config(lib):
        cfg = lib.sb1_config(num_days_in_episode=4, weather_kind="sinusoid")
        return dataclasses.replace(cfg, start_timestamp=start)

    jenv = jbe.BuildingEnv(config(jpresets))
    tenv = tbe.BuildingEnv(config(tpresets), device="cpu")
    np.testing.assert_array_equal(tsched.build_schedule_actions(tenv),
                                  jsched.build_schedule_actions(jenv))


def test_episode_reset_selects_fresh_envs():
    """_maybe_reset swaps in fresh states only where done."""
    tenv = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    tt = ttrain.SACTrainer(tenv, ttrain.TrainConfig(n_envs=2, batch_size=2))
    state = tt.init(rng.PRNGKey(0))
    stepped, out = tenv.step_batched(state.env_states, torch.zeros(2, tenv.n_actions))
    done = torch.tensor([True, False])
    mixed, obs = tt._maybe_reset(stepped, out.observation, done, rng.PRNGKey(1))
    assert mixed.step_idx.tolist() == [0, 1]
    assert torch.equal(obs[1], out.observation[1])
    same, same_obs = tt._maybe_reset(stepped, out.observation,
                                     torch.tensor([False, False]), rng.PRNGKey(1))
    # No env done: the masked select keeps every stepped field, bitwise.
    want = dict(_flat(convert.env_state_to_numpy(stepped)))
    for key, value in _flat(convert.env_state_to_numpy(same)):
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    assert torch.equal(same_obs, out.observation)


# ---------------------------------------------------------------------------
# Kernel statistics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sb1():
    jenv = jbe.BuildingEnv(jpresets.sb1_config(num_days_in_episode=1))
    tenv = tbe.BuildingEnv(tpresets.sb1_config(num_days_in_episode=1), device="cpu")
    return jenv, tenv


def _step_inputs(env_geom_shape, batch, seed):
    rs = np.random.default_rng(seed)
    shape = (batch,) + env_geom_shape
    return dict(
        temp=(294.0 + rs.normal(0, 2.0, shape)).astype(np.float32),
        input_q=rs.uniform(0.0, 50.0, shape).astype(np.float32),
        t_inf=rs.uniform(270.0, 300.0, batch).astype(np.float32),
        h_conv=np.full(batch, 12.0, np.float32),
        keys=rs.integers(0, 2**32, (batch, 2), dtype=np.uint64).astype(np.uint32),
    )


@pytest.mark.parametrize("method", ["jacobi", "chebyshev"])
def test_plain_stats_equal_fold_and_jax_kernel(sb1, method):
    jenv, tenv = sb1
    x = _step_inputs(tenv.geom.shape, 3, seed=4 if method == "jacobi" else 5)
    conv = tenv.convection
    kw = dict(convergence_threshold=0.1, iteration_limit=100, method=method,
              spectral_radius=tenv._spectral_radius, check_every=4,
              conv_offsets=conv.offsets)
    jout = fdm_pallas.fdm_step_pallas(
        jnp.asarray(x["temp"]), jnp.asarray(x["input_q"]), jnp.asarray(x["t_inf"]),
        jnp.asarray(x["h_conv"]), jenv.coeffs, interpret=True,
        conv_lead=jenv.convection.lead_words, conv_foll=jenv.convection.foll_words,
        conv_keys=jnp.asarray(x["keys"]),
        conv_word_params=jconv.decision_word_params(jenv.convection),
        stat_layout=jenv.zone_stats, **kw)
    jtemp, _, _, jstats = (np.array(a) for a in jout)
    t = lambda a: torch.as_tensor(a)
    tout = fdm_cuda.fdm_step_cuda(
        t(x["temp"]), t(x["input_q"]), t(x["t_inf"]), t(x["h_conv"]), tenv.coeffs,
        conv_lead=tenv._conv_lead, conv_foll=tenv._conv_foll,
        conv_keys=t(x["keys"].astype(np.int64)), conv_word_params=tenv._conv_word_params,
        stat_layout=tenv.zone_stats, **kw)
    ttemp, titers, _, sums = tout
    z = tenv.n_zones
    # The plain epilogue is the gridstats fold of the port's own field.
    stats = tgs.ZoneStats(tenv.zone_stats, "cpu")
    assert torch.equal(sums.zone_sums, stats.zone_sums(ttemp))
    assert torch.equal(sums.grid_sums, stats.grid_sum(ttemp))
    # On the JAX kernel's field, the port's fold gives the JAX kernel's sums.
    on_jax = fdm_cuda.fold_stats(torch.as_tensor(jtemp), stats)
    np.testing.assert_array_equal(on_jax.zone_sums.numpy(), jstats[:, 0, :z])
    np.testing.assert_array_equal(on_jax.grid_sums.numpy(), jstats[:, 1, 0])
    np.testing.assert_array_equal(jstats[:, 0, :z], np.asarray(jax.vmap(
        lambda f: jgs.zone_sums(f, jenv.zone_stats))(jnp.asarray(jtemp))))
    # And the port's sums are the JAX sums up to the one-solve bound.
    np.testing.assert_allclose(sums.zone_sums.numpy(), jstats[:, 0, :z], rtol=SUM_RTOL)
    np.testing.assert_allclose(sums.grid_sums.numpy(), jstats[:, 1, 0], rtol=SUM_RTOL)


def test_stats_refuse_more_than_128_zones(sb1):
    _, tenv = sb1
    layout = tenv.zone_stats
    big = tgs.ZoneStatLayout(
        masks=np.repeat(layout.masks[:1], 129, axis=0), sizes=np.ones(129, np.float32),
        row0=(0,) * 129, col0=(0,) * 129, window=layout.window, grid_n=layout.grid_n)
    x = _step_inputs(tenv.geom.shape, 1, seed=0)
    with pytest.raises(ValueError, match="128"):
        fdm_cuda.fdm_step_cuda(
            *(torch.as_tensor(x[k]) for k in ("temp", "input_q", "t_inf", "h_conv")),
            tenv.coeffs, convergence_threshold=0.1, iteration_limit=5, stat_layout=big)


def _stat_layout_passed(env, solver, monkeypatch):
    seen = []
    real = fdm_cuda.Route.run

    def spy(route, inp, conv=None, stats=None, barriers=None):
        seen.append(stats is not None)
        return real(route, inp, conv, stats, barriers)

    monkeypatch.setattr(fdm_cuda.Route, "run", spy)
    state, _ = env.reset(rng.split(rng.PRNGKey(0), 2))
    env.step_batched(state, torch.zeros(2, env.n_actions), solver=solver)
    return seen == [True]


def test_step_batched_kernel_stats_rule(sb1, monkeypatch):
    _, tenv = sb1
    # Solo K2 on the 12-zone plan: statistics from the kernel.
    assert _stat_layout_passed(tenv, "pallas_env", monkeypatch)
    # The preset's interleaved K1 keeps the fold.
    assert tenv.config.pallas_block_envs > 1
    assert not _stat_layout_passed(tenv, "pallas_cheby", monkeypatch)
    # K1 with one env per program takes them from the kernel.
    solo = tbe.BuildingEnv(dataclasses.replace(
        tpresets.sb1_config(num_days_in_episode=1), pallas_block_envs=1), device="cpu")
    assert _stat_layout_passed(solo, "pallas_cheby", monkeypatch)
    # More zones than kernel_stats_max_zones: the fold.
    rooms = tbe.BuildingEnv(tpresets.sb1_config(
        num_days_in_episode=1, floor_plan=tgeo.make_synthetic_office_plan(3, 5, room_cvs=8)),
        device="cpu")
    assert rooms.n_zones > rooms.config.kernel_stats_max_zones
    assert not _stat_layout_passed(rooms, "pallas_env", monkeypatch)

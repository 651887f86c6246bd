"""Episode windows and the time-zone table: the port against the JAX
package on the CPU.

* build_episode_tables with episode_windows > 1: the (W, T) tables and the
  (W,) reset values equal JAX's exactly, leaf by leaf (values and dtypes),
  and so does tables_for_window; on the two-zone plan and on sb1 with its
  windows across the US and the EU daylight-saving changes.
* The window drawn by reset equals JAX's for 32 keys (exact).
* 3 steps at episode_windows=4, B=8, against jax.vmap(env.step): the
  two-zone plan through xla_jacobi, and sb1 (randomized occupancy, which
  reads each window's local hours) through pallas_env (K2's plain version
  on the CPU; env.step solves by the same Jacobi rule). Keys, occupants,
  windows, step counts, iteration counts and converged flags exact; each
  step from the carried JAX state within FIELD_ATOL, the port's own
  trajectory within (step) x FIELD_ATOL, observations and rewards within
  OUT_ATOL (tests/test_torch_env.py's bounds).
"""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.scenario import tables as jtables
from sbsim_tpu_torch import convert, rng
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.scenario import tables as ttables

B = 8
STEPS = 3
WINDOWS = 4
FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_env.py)
OUT_ATOL = 1e-4
STATE_RTOL = 1e-5
STATE_ATOL = {"input_q": 1e-3}
EXACT = ("rng", "occupants", "step_idx", "window", "fdm_iterations", "fdm_converged")


def _two_zone(lib):
    return dataclasses.replace(lib.two_zone_test_config(), episode_windows=WINDOWS,
                               window_stride_hours=24.0)


def _sb1(lib):
    return dataclasses.replace(lib.sb1_config(num_days_in_episode=1),
                               episode_windows=WINDOWS, window_stride_hours=24.0)


def _sb1_dst(lib):
    """Windows from 10 March 2023 across the US change (12 March)."""
    cfg = lib.sb1_config(num_days_in_episode=1, weather_kind="sinusoid")
    return dataclasses.replace(cfg, start_timestamp="2023-03-10 07:00:00+00:00",
                               episode_windows=WINDOWS, window_stride_hours=24.0)


def _sb1_berlin(lib):
    """Windows from a naive 27 October 2023 stamp across the EU change
    (29 October), schedule and occupancy in Europe/Berlin, 30 h apart."""
    cfg = lib.sb1_config(num_days_in_episode=1, weather_kind="sinusoid")
    return dataclasses.replace(
        cfg, start_timestamp="2023-10-27 20:00:00", episode_windows=WINDOWS,
        window_stride_hours=30.0,
        schedule=dataclasses.replace(cfg.schedule, time_zone="Europe/Berlin"),
        occupancy=dataclasses.replace(cfg.occupancy, time_zone="Europe/Berlin",
                                      kind="step_function"))


CONFIGS = {"two_zone": _two_zone, "sb1": _sb1, "sb1_dst": _sb1_dst, "sb1_berlin": _sb1_berlin}


def _leaves(tables):
    return {f.name: getattr(tables, f.name) for f in dataclasses.fields(tables)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stacked_tables_equal_jax(name):
    jt = jtables.build_episode_tables(CONFIGS[name](jpresets))
    tt = ttables.build_episode_tables(CONFIGS[name](tpresets))
    want, got = _leaves(jt), _leaves(tt)
    assert want.keys() == got.keys()
    for key, value in want.items():
        if key in ("n_steps", "time_step_sec"):
            assert got[key] == value, key
            continue
        value = np.asarray(value)
        assert value.shape[0] == WINDOWS, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert np.asarray(got[key]).dtype == value.dtype, key
    for w in (0, WINDOWS - 1):
        one = _leaves(ttables.tables_for_window(tt, w))
        for key, value in _leaves(jtables.tables_for_window(jt, w)).items():
            np.testing.assert_array_equal(np.asarray(one[key]), np.asarray(value),
                                          err_msg=f"window {w} {key}")


def test_window_draw_equals_jax():
    jenv = jbe.BuildingEnv(_two_zone(jpresets))
    tenv = tbe.BuildingEnv(_two_zone(tpresets), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), 32)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    tstate, tobs = tenv.reset(torch.as_tensor(np.asarray(keys).astype(np.int64)))
    want = np.asarray(jstate.window)
    np.testing.assert_array_equal(tstate.window.numpy(), want)
    assert tstate.window.dtype == torch.int32 and len(np.unique(want)) > 1
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=OUT_ATOL, rtol=0)


def _tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _compare_states(jtree, ttree, temp_atol, label):
    tflat = dict(_flat(ttree))
    for name, want in _flat(jtree):
        got = tflat[name]
        assert got.shape == want.shape, name
        if name in EXACT or want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {name}")
        elif name == "temp":
            np.testing.assert_allclose(got, want, atol=temp_atol, rtol=0,
                                       err_msg=f"{label} {name}")
        else:
            atol = STATE_ATOL.get(name, STATE_RTOL * max(1.0, float(np.abs(want).max())))
            np.testing.assert_allclose(got, want, atol=atol, rtol=STATE_RTOL,
                                       err_msg=f"{label} {name}")


@pytest.mark.parametrize("name, solver", [("two_zone", "xla_jacobi"), ("sb1", "pallas_env")])
def test_windowed_trajectory_matches_vmapped_step(name, solver):
    jenv = jbe.BuildingEnv(CONFIGS[name](jpresets))
    tenv = tbe.BuildingEnv(CONFIGS[name](tpresets), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    jstate, _ = jax.vmap(jenv.reset)(keys)
    assert len(np.unique(np.asarray(jstate.window))) > 1
    free = convert.env_state_from_numpy(_tree(jstate), "cpu")
    actions = np.random.default_rng(2).uniform(
        -1, 1, (STEPS, B, tenv.n_actions)).astype(np.float32)
    step = jax.jit(jax.vmap(jenv.step))
    for i, action in enumerate(actions):
        carried = convert.env_state_from_numpy(_tree(jstate), "cpu")
        tstate, tout = tenv.step_batched(carried, torch.as_tensor(action), solver=solver)
        jstate, jout = step(jstate, jnp.asarray(action))
        jtree = _tree(jstate)
        _compare_states(jtree, convert.env_state_to_numpy(tstate), FIELD_ATOL, f"step {i}")
        free, fout = tenv.step_batched(free, torch.as_tensor(action), solver=solver)
        _compare_states(jtree, convert.env_state_to_numpy(free), (i + 1) * FIELD_ATOL,
                        f"free step {i}")
        for out in (tout, fout):
            for field in ("observation", "reward", "done"):
                np.testing.assert_allclose(
                    getattr(out, field).numpy(), np.asarray(getattr(jout, field)),
                    atol=OUT_ATOL, rtol=0, err_msg=f"step {i} {field}")


def test_single_window_env_keeps_window_zero():
    tenv = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    state, _ = tenv.reset(rng.split(rng.PRNGKey(0), 4))
    assert state.window.tolist() == [0] * 4
    assert tenv._tab["ambient_temp"].shape[0] == 1

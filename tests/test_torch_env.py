"""The slice end to end: the port's batched sb1 env against the JAX env.

12-zone sb1 preset, B=4, on the CPU. The JAX reset state is carried into
the port with sbsim_tpu_torch.convert, then both take 3 step_batched steps
under each of pallas_cheby, pallas_env and xla_jacobi (the JAX Pallas
kernels in interpret mode; the port's kernel wrappers take their plain
versions on CPU tensors).

Keys, occupants, iteration counts and converged flags must be exact;
observations and rewards within 1e-4; the other float state within 1e-5 of
each field's scale, and the diffuser heat within STATE_ATOL (XLA's FMAs move
a few ulps, which the VAV heat magnifies through the supply-minus-zone
temperature difference). Temperatures: each step is compared
from the same (carried) state, within FIELD_ATOL, the one-solve bound of
tests/test_torch_physics.py (XLA:CPU contracts FMAs, the port does not);
the port's own free-running 3-step trajectory adds at most one solve's
rounding per step, so it is held to 3 x FIELD_ATOL.
"""

import functools

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.physics import fdm_pallas
from sbsim_tpu_torch import convert
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.physics import fdm_cuda

B = 4
STEPS = 3
FIELD_ATOL = 2e-4  # K, one solve (see tests/test_torch_physics.py)
OUT_ATOL = 1e-4
STATE_RTOL = 1e-5  # of each field's scale; see the module docstring
# Diffuser heat, W: one ulp (3e-5 K) of a zone's supply temperature moves a
# VAV's heat by up to 0.035 kg/s x 1006 J/kg/K x 3e-5 K, about 1e-3 W.
STATE_ATOL = {"input_q": 1e-3}
EXACT = ("rng", "occupants", "step_idx", "window", "fdm_iterations", "fdm_converged")


@pytest.fixture(scope="module")
def envs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fdm_pallas, "fdm_step_pallas",
                   functools.partial(fdm_pallas.fdm_step_pallas, interpret=True))
        jenv = jbe.BuildingEnv(jpresets.sb1_config(num_days_in_episode=2))
        tenv = tbe.BuildingEnv(tpresets.sb1_config(num_days_in_episode=2), device="cpu")
        keys = jax.random.split(jax.random.PRNGKey(3), B)
        jstate, jobs = jax.vmap(jenv.reset)(keys)
        actions = np.random.default_rng(0).uniform(-1, 1, (STEPS, B, 2))
        yield dict(jenv=jenv, tenv=tenv, keys=keys, jstate=jstate, jobs=jobs,
                   actions=actions.astype(np.float32))


def _tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _compare_states(jtree, ttree, temp_atol):
    tflat = dict(_flat(ttree))
    for name, want in _flat(jtree):
        got = tflat[name]
        assert got.shape == want.shape, name
        if name in EXACT or want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name in ("temp",):
            np.testing.assert_allclose(got, want, atol=temp_atol, rtol=0, err_msg=name)
        else:
            atol = STATE_ATOL.get(name, STATE_RTOL * max(1.0, float(np.abs(want).max())))
            np.testing.assert_allclose(got, want, atol=atol, rtol=STATE_RTOL, err_msg=name)


def test_reset_matches_jax(envs):
    keys = torch.as_tensor(np.asarray(envs["keys"]).astype(np.int64))
    tstate, tobs = envs["tenv"].reset(keys)
    tree = convert.env_state_to_numpy(tstate)
    _compare_states(_tree(envs["jstate"]), tree, temp_atol=0.0)
    np.testing.assert_array_equal(tstate.temp.numpy(), np.asarray(envs["jstate"].temp))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(envs["jobs"]), atol=OUT_ATOL, rtol=0)


def test_convert_round_trip(envs):
    tree = _tree(envs["jstate"])
    back = convert.env_state_to_numpy(convert.env_state_from_numpy(tree, "cpu"))
    back = dict(_flat(back))
    for name, a in _flat(tree):
        b = back[name]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("solver", ["pallas_cheby", "pallas_env", "xla_jacobi"])
def test_three_steps_match_jax(envs, solver, monkeypatch):
    monkeypatch.setattr(fdm_pallas, "fdm_step_pallas",
                        functools.partial(fdm_pallas.fdm_step_pallas, interpret=True))
    jenv, tenv = envs["jenv"], envs["tenv"]
    jstate = envs["jstate"]
    free = convert.env_state_from_numpy(_tree(jstate), "cpu")
    fdm_cuda.reset_launch_counts()
    for i in range(STEPS):
        action = envs["actions"][i]
        # One step from the carried JAX state.
        carried = convert.env_state_from_numpy(_tree(jstate), "cpu")
        tstate, tout = tenv.step_batched(carried, torch.as_tensor(action), solver=solver)
        jstate, jout = jenv.step_batched(jstate, jnp.asarray(action), solver=solver)
        jtree = _tree(jstate)
        _compare_states(jtree, convert.env_state_to_numpy(tstate), FIELD_ATOL)
        for name in ("observation", "reward", "done"):
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                atol=OUT_ATOL, rtol=0, err_msg=name)
        # The port's own trajectory from the reset state.
        free, fout = tenv.step_batched(free, torch.as_tensor(action), solver=solver)
        _compare_states(jtree, convert.env_state_to_numpy(free), (i + 1) * FIELD_ATOL)
        np.testing.assert_allclose(fout.observation.numpy(), np.asarray(jout.observation),
                                   atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(fout.reward.numpy(), np.asarray(jout.reward),
                                   atol=OUT_ATOL, rtol=0)
    assert (np.asarray(jstate.fdm_iterations) > 0).all()
    # CPU tensors take the plain versions: no kernel launches.
    assert fdm_cuda.launch_counts == {"fdm_cheby": 0, "fdm_jacobi": 0,
                                      "fdm_cheby_block": 0, "fdm_jacobi_block": 0}


@pytest.mark.parametrize("solver", ["pallas_cheby", "pallas_env"])
def test_env_result_does_not_depend_on_its_batch(envs, solver):
    tenv = envs["tenv"]
    tree = _tree(envs["jstate"])
    full = convert.env_state_from_numpy(tree, "cpu")
    solo = convert.env_state_from_numpy(
        jax.tree.map(lambda a: a[2:3], tree), "cpu")
    action = torch.as_tensor(envs["actions"][0])
    for _ in range(2):
        full, fout = tenv.step_batched(full, action, solver=solver)
        solo, sout = tenv.step_batched(solo, action[2:3], solver=solver)
    ft, st = convert.env_state_to_numpy(full), convert.env_state_to_numpy(solo)
    for (name, a), (_, b) in zip(_flat(ft), _flat(st)):
        np.testing.assert_array_equal(a[2:3], b, err_msg=name)
    np.testing.assert_array_equal(fout.observation[2:3].numpy(), sout.observation.numpy())


def test_auto_solver_on_cpu_is_the_plain_solver(envs):
    assert envs["tenv"].resolve_solver(B) == "xla_jacobi"
    assert envs["tenv"].resolve_solver(B, solver="pallas_cheby") == "pallas_cheby"
    with pytest.raises(ValueError):
        envs["tenv"].resolve_solver(B, solver="bogus")

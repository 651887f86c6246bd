"""The port against the JAX package run op by op, bitwise.

Jitted XLA on the CPU fuses elementwise chains and contracts multiply-adds
into FMAs, which is why tests/test_torch_physics.py and test_torch_env.py
hold fields to a few ulps. Under `jax.disable_jit()` every jnp operation
runs alone, in the order the source writes it, as the port's PyTorch code
runs; the two packages then agree bitwise:

  * the FDM solvers (fdm_step, fdm_step_chebyshev) and the plain version
    of the Jacobi kernel K2, with and without convection;
  * a 3-step sb1 trajectory, every field of the state, under xla_jacobi
    and pallas_env (both against JAX's xla_jacobi: the same Jacobi
    semantics) and under xla_chebyshev.

K1's plain version has no unfused JAX counterpart: the Pallas kernel runs
fused even in interpret mode, and fdm_step_chebyshev rounds its first
omega in float32 where the Pallas kernels round it from Python double
(fdm.py:332 vs fdm_pallas.py:698), so the two JAX solvers differ by ulps.

Observations and rewards pass through cos/sin/exp, whose implementations
differ between the two libraries: within 1e-4.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.physics import convection as jconv
from sbsim_tpu.physics import fdm as jfdm
from sbsim_tpu_torch import convert
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.physics import convection as tconv
from sbsim_tpu_torch.physics import fdm as tfdm
from sbsim_tpu_torch.physics import fdm_cuda

from test_torch_physics import _edge_plan_geoms, _inputs, _ring_plan_geoms, _torch

B = 4
STEPS = 3
OUT_ATOL = 1e-4
FDM_KW = dict(convergence_threshold=0.1, iteration_limit=100)


@pytest.mark.parametrize("which", ["edge", "ring"])
def test_solvers_bitwise_against_unfused_jax(which):
    jg, tg = _edge_plan_geoms() if which == "edge" else _ring_plan_geoms()
    jc = jfdm.stencil_coefficients(jg, 300.0)
    tc = tfdm.stencil_coefficients(tg, 300.0, device="cpu")
    rho = jfdm.estimate_spectral_radius(jc, 12.0)
    jb = jconv.make_convection_buckets(jg, p=1.0, distance=5, seed=5, rng="mix32")
    tb = tconv.make_convection_buckets(tg, p=1.0, distance=5, seed=5, rng="mix32")
    temp, q, t_inf, h, keys = _inputs(jg.shape, 3, seed=11)
    with jax.disable_jit():
        j_in = [jnp.asarray(a) for a in (temp, q, t_inf, h)]
        jac = jfdm.fdm_step(*j_in, jc, **FDM_KW)
        cheb = jfdm.fdm_step_chebyshev(*j_in, jc, spectral_radius=rho, **FDM_KW)
        swap = jax.vmap(lambda x, k: jconv.apply_swaps_with_word(
            x, jb, jconv.swap_decision_word(jb, k, jg.shape)))
        jac_conv = np.asarray(swap(jac[0], jnp.asarray(keys)))
    t_in = _torch(temp, q, t_inf, h)
    inp = fdm_cuda.kernel_inputs(*t_in, tc)
    conv = fdm_cuda.ConvInputs(
        offsets=tb.offsets, lead=fdm_cuda.packed_plane(tb.lead_words, "cpu"),
        foll=fdm_cuda.packed_plane(tb.foll_words, "cpu"),
        word_params=tconv.decision_word_params(tb),
        keys=torch.as_tensor(keys.astype(np.int64)))
    # (field, converged, iterations), in the JAX solvers' order.
    port = {
        "fdm_step": tfdm.fdm_step(*t_in, tc, **FDM_KW),
        "fdm_step_chebyshev": tfdm.fdm_step_chebyshev(
            *t_in, tc, spectral_radius=rho, **FDM_KW),
    }
    x, it, cv = fdm_cuda.fdm_jacobi_plain(inp, threshold=0.1, iteration_limit=100)
    port["fdm_jacobi_plain"] = (x, cv, it)
    ref = {"fdm_step": jac, "fdm_jacobi_plain": jac, "fdm_step_chebyshev": cheb}
    for name, got in port.items():
        for g, w in zip(got, ref[name]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    x, _, _ = fdm_cuda.fdm_jacobi_plain(inp, threshold=0.1, iteration_limit=100,
                                        conv=conv)
    np.testing.assert_array_equal(x.numpy(), jac_conv)


def _tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


@pytest.fixture(scope="module")
def unfused():
    """The JAX env's 3-step trajectories, op by op, from one reset."""
    cfg = jpresets.sb1_config(num_days_in_episode=2)
    jenv = jbe.BuildingEnv(cfg)
    actions = np.random.default_rng(1).uniform(-1, 1, (STEPS, B, 2)).astype(np.float32)
    runs = {}
    with jax.disable_jit():
        start, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(8), B))
        for solver in ("xla_jacobi", "xla_chebyshev"):
            state, outs = start, []
            for a in actions:
                state, out = jenv.step_batched(state, jnp.asarray(a), solver=solver)
                outs.append((_tree(state), np.asarray(out.observation),
                             np.asarray(out.reward)))
            runs[solver] = outs
    return dict(start=_tree(start), actions=actions, runs=runs)


@pytest.mark.parametrize("solver, reference", [
    ("xla_jacobi", "xla_jacobi"),
    ("pallas_env", "xla_jacobi"),
    ("xla_chebyshev", "xla_chebyshev"),
])
def test_trajectory_bitwise_against_unfused_jax(unfused, solver, reference):
    tenv = tbe.BuildingEnv(tpresets.sb1_config(num_days_in_episode=2), device="cpu")
    state = convert.env_state_from_numpy(unfused["start"], "cpu")
    for a, (jtree, jobs, jrew) in zip(unfused["actions"], unfused["runs"][reference]):
        state, out = tenv.step_batched(state, torch.as_tensor(a), solver=solver)
        got = dict(_flat(convert.env_state_to_numpy(state)))
        for name, want in _flat(jtree):
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        np.testing.assert_allclose(out.observation.numpy(), jobs, atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(out.reward.numpy(), jrew, atol=OUT_ATOL, rtol=0)

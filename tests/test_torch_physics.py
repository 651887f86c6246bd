"""The port's physics against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX functions (the Pallas
kernels in interpret mode, as tests/test_fdm_pallas.py runs them) and the
port's plain PyTorch versions:

  * mix32 decision words and the swap rounds: bitwise;
  * zone/grid statistics fold: bitwise;
  * FDM solves (Jacobi and Chebyshev, edge-fill and ring plans, with and
    without fused convection): iteration counts and converged flags exact,
    fields within FIELD_ATOL.

XLA on the CPU contracts multiply-adds into FMAs (about one cell in six of
a Jacobi update rounds differently) and the port does not, so that its CUDA
kernels can equal the plain versions bitwise. One solve then leaves up to 5
float32 ulps at ~300 K: 1.5e-4 K on the sb1 plan, one ulp more than the
repo's own bound for two compilations of one solve (1e-4 K,
tests/test_fdm_pallas.py:56-62). FIELD_ATOL is 2e-4 K, under 7 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.core import geometry as jgeo
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.physics import convection as jconv
from sbsim_tpu.physics import fdm as jfdm
from sbsim_tpu.physics import fdm_pallas
from sbsim_tpu.physics import gridstats as jgs
from sbsim_tpu_torch.core import geometry as tgeo
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.physics import convection as tconv
from sbsim_tpu_torch.physics import fdm as tfdm
from sbsim_tpu_torch.physics import fdm_cuda
from sbsim_tpu_torch.physics import gridstats as tgs

FDM_KW = dict(convergence_threshold=0.1, iteration_limit=100)
FIELD_ATOL = 2e-4  # K; see the module docstring


def _edge_plan_geoms():
    """The legacy rectangular building: its edge CVs exchange with ambient
    through the shift fill, so the kernels take the edge-fill path."""

    def build(lib):
        return lib.geometry_rectangular(
            cv_size_cm=20.0, floor_height_cm=300.0, room_shape=(8, 6),
            building_shape=(2, 1), initial_temp=294.0,
            inside_air=lib.MaterialProperties(50.0, 700.0, 1.0),
            inside_wall=lib.MaterialProperties(2.0, 500.0, 1800.0),
            building_exterior=lib.MaterialProperties(0.05, 700.0, 1.0))

    return build(jgeo), build(tgeo)


def _ring_plan_geoms():
    """The 12-zone sb1 plan: its outer ring is exterior (the ring path)."""
    jg = jbe.build_geometry(jpresets.sb1_config(num_days_in_episode=1))
    tg = tbe.build_geometry(tpresets.sb1_config(num_days_in_episode=1))
    return jg, tg


@pytest.fixture(scope="module", params=["edge", "ring"])
def plan(request):
    jg, tg = _edge_plan_geoms() if request.param == "edge" else _ring_plan_geoms()
    jc = jfdm.stencil_coefficients(jg, 300.0)
    tc = tfdm.stencil_coefficients(tg, 300.0, device="cpu")
    assert tc.ring_exterior == (request.param == "ring") == jc.ring_exterior
    rho = jfdm.estimate_spectral_radius(jc, 12.0)
    assert tfdm.estimate_spectral_radius(tc, 12.0) == rho
    jb = jconv.make_convection_buckets(jg, p=1.0, distance=5, seed=5, rng="mix32")
    tb = tconv.make_convection_buckets(tg, p=1.0, distance=5, seed=5, rng="mix32")
    return dict(name=request.param, jg=jg, tg=tg, jc=jc, tc=tc, rho=rho,
                jb=jb, tb=tb)


def _inputs(shape, batch, seed):
    rng = np.random.default_rng(seed)
    temp = (294.0 + rng.normal(0, 2.0, (batch,) + shape)).astype(np.float32)
    q = rng.uniform(0.0, 50.0, (batch,) + shape).astype(np.float32)
    t_inf = rng.uniform(270.0, 300.0, (batch,)).astype(np.float32)
    h = rng.uniform(5.0, 100.0, (batch,)).astype(np.float32)
    keys = rng.integers(0, 2**32, (batch, 2), dtype=np.uint64).astype(np.uint32)
    return temp, q, t_inf, h, keys


def _torch(*arrays):
    return [torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)
            for a in arrays]


def test_decision_words_and_swaps_bitwise(plan):
    jb, tb = plan["jb"], plan["tb"]
    params = jconv.decision_word_params(jb)
    assert params == tconv.decision_word_params(tb)
    shape = plan["jg"].shape
    temp, _, _, _, keys = _inputs(shape, 5, seed=1)
    jwords = np.stack([
        np.asarray(jconv.swap_decision_word(jb, jnp.asarray(k), shape))
        for k in keys
    ])
    twords = tconv.decision_word_from_key(torch.as_tensor(keys.astype(np.int64)),
                                          params, shape)
    np.testing.assert_array_equal(twords.numpy(), jwords.astype(np.int64))
    jout = jax.vmap(lambda x, w: jconv.apply_swaps_with_word(x, jb, w))(
        jnp.asarray(temp), jnp.asarray(jwords))
    tout = tconv.apply_swaps_with_word(
        torch.as_tensor(temp), tb.offsets,
        torch.as_tensor(tb.lead_words.astype(np.int64)),
        torch.as_tensor(tb.foll_words.astype(np.int64)), twords)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert (tout.numpy() != temp).any()


def test_gridstats_fold_bitwise(plan):
    jlay = jgs.make_zone_stat_layout(plan["jg"])
    tlay = tgs.make_zone_stat_layout(plan["tg"])
    temp, *_ = _inputs(plan["jg"].shape, 3, seed=2)
    jz = np.stack([np.asarray(jgs.zone_sums(jnp.asarray(t), jlay)) for t in temp])
    jg = np.stack([np.asarray(jgs.grid_sum(jnp.asarray(t))) for t in temp])
    stats = tgs.ZoneStats(tlay, "cpu")
    np.testing.assert_array_equal(stats.zone_sums(torch.as_tensor(temp)).numpy(), jz)
    np.testing.assert_array_equal(
        tgs.fold_sum_2d(torch.as_tensor(temp))[:, 0, 0].numpy(), jg)


def test_plain_solvers_match_jax_xla_solvers(plan):
    """physics/fdm.py (the xla_* solvers) against sbsim_tpu.physics.fdm."""
    temp, q, t_inf, h, _ = _inputs(plan["jg"].shape, 4, seed=3)
    j_in = [jnp.asarray(a) for a in (temp, q, t_inf, h)]
    t_in = _torch(temp, q, t_inf, h)
    jx, jconv_, jit = jfdm.fdm_step(*j_in, plan["jc"], **FDM_KW)
    tx, tconv_, tit = tfdm.fdm_step(*t_in, plan["tc"], **FDM_KW)
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(tconv_.numpy(), np.asarray(jconv_))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=FIELD_ATOL, rtol=0)
    kw = dict(FDM_KW, spectral_radius=plan["rho"])
    jx, jconv_, jit = jfdm.fdm_step_chebyshev(*j_in, plan["jc"], **kw)
    tx, tconv_, tit = tfdm.fdm_step_chebyshev(*t_in, plan["tc"], **kw)
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(tconv_.numpy(), np.asarray(jconv_))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=FIELD_ATOL, rtol=0)


def _port_conv(plan, keys):
    params = tconv.decision_word_params(plan["tb"])
    return fdm_cuda.ConvInputs(
        offsets=plan["tb"].offsets,
        lead=fdm_cuda.packed_plane(plan["tb"].lead_words, "cpu"),
        foll=fdm_cuda.packed_plane(plan["tb"].foll_words, "cpu"),
        word_params=params,
        keys=torch.as_tensor(keys.astype(np.int64)),
    )


def _pallas_conv_kw(plan, keys):
    jb = plan["jb"]
    return dict(conv_offsets=jb.offsets, conv_lead=jb.lead_words,
                conv_foll=jb.foll_words, conv_keys=jnp.asarray(keys),
                conv_word_params=jconv.decision_word_params(jb))


@pytest.mark.parametrize("fused", [False, True])
def test_jacobi_plain_matches_jax(plan, fused):
    """fdm_jacobi_plain (K2's plain version) against fdm.fdm_step and the
    interpret-mode _fdm_kernel."""
    temp, q, t_inf, h, keys = _inputs(plan["jg"].shape, 3, seed=4)
    inp = fdm_cuda.kernel_inputs(*_torch(temp, q, t_inf, h), plan["tc"])
    conv = _port_conv(plan, keys) if fused else None
    got, iters, conv_flag = fdm_cuda.fdm_jacobi_plain(
        inp, threshold=0.1, iteration_limit=100, conv=conv)
    j_in = [jnp.asarray(a) for a in (temp, q, t_inf, h)]
    extra = _pallas_conv_kw(plan, keys) if fused else {}
    pal, pal_iters, pal_conv = fdm_pallas.fdm_step_pallas(
        *j_in, plan["jc"], interpret=True, **FDM_KW, **extra)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(pal_iters))
    np.testing.assert_array_equal(conv_flag.numpy(), np.asarray(pal_conv))
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=FIELD_ATOL, rtol=0)
    if not fused:
        ref, ref_conv, ref_iters = jfdm.fdm_step(*j_in, plan["jc"], **FDM_KW)
        np.testing.assert_array_equal(iters.numpy(), np.asarray(ref_iters))
        np.testing.assert_array_equal(conv_flag.numpy(), np.asarray(ref_conv))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FIELD_ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_cheby_plain_matches_interleaved_kernel(plan, fused):
    """fdm_cheby_plain (K1's plain version) against the interpret-mode
    _fdm_cheby_kernel_interleaved at the preset's cadence."""
    temp, q, t_inf, h, keys = _inputs(plan["jg"].shape, 4, seed=5)
    inp = fdm_cuda.kernel_inputs(*_torch(temp, q, t_inf, h), plan["tc"])
    conv = _port_conv(plan, keys) if fused else None
    got, iters, conv_flag = fdm_cuda.fdm_cheby_plain(
        inp, threshold=0.1, iteration_limit=100, spectral_radius=plan["rho"],
        check_every=4, conv=conv)
    extra = _pallas_conv_kw(plan, keys) if fused else {}
    pal, pal_iters, pal_conv = fdm_pallas.fdm_step_pallas(
        *[jnp.asarray(a) for a in (temp, q, t_inf, h)], plan["jc"],
        interpret=True, method="chebyshev", spectral_radius=plan["rho"],
        block_mode="interleave", block_envs=4, check_every=4, **FDM_KW,
        **extra)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(pal_iters))
    np.testing.assert_array_equal(conv_flag.numpy(), np.asarray(pal_conv))
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=FIELD_ATOL, rtol=0)


@pytest.mark.parametrize("method", ["jacobi", "chebyshev"])
def test_capped_solve_reports_unconverged(plan, method):
    """At iteration_limit=3 the residual rule is not met: flags False and
    counts as the JAX kernels report them (Chebyshev may pass the cap by up
    to check_every - 1)."""
    temp, q, t_inf, h, _ = _inputs(plan["jg"].shape, 2, seed=6)
    t_inf[:] = 270.0
    kw = dict(convergence_threshold=0.1, iteration_limit=3)
    extra = {}
    if method == "chebyshev":
        extra = dict(method="chebyshev", spectral_radius=plan["rho"],
                     check_every=4, block_mode="interleave", block_envs=2)
    _, pal_iters, pal_conv = fdm_pallas.fdm_step_pallas(
        *[jnp.asarray(a) for a in (temp, q, t_inf, h)], plan["jc"],
        interpret=True, **kw, **extra)
    _, iters, conv = fdm_cuda.fdm_step_cuda(
        *_torch(temp, q, t_inf, h), plan["tc"], **kw, **extra)
    assert not np.asarray(pal_conv).any()
    np.testing.assert_array_equal(conv.numpy(), np.asarray(pal_conv))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(pal_iters))


def test_batch_composition_does_not_change_an_env(plan):
    """Each env's solve is independent of its batch companions, as the
    CUDA kernels (one thread block per env) make it."""
    temp, q, t_inf, h, keys = _inputs(plan["jg"].shape, 5, seed=7)
    full = fdm_cuda.kernel_inputs(*_torch(temp, q, t_inf, h), plan["tc"])
    solo = fdm_cuda.kernel_inputs(
        *_torch(temp[2:3], q[2:3], t_inf[2:3], h[2:3]), plan["tc"])
    kw = dict(threshold=0.1, iteration_limit=100, spectral_radius=plan["rho"],
              check_every=4)
    a, ai, _ = fdm_cuda.fdm_cheby_plain(full, conv=_port_conv(plan, keys), **kw)
    b, bi, _ = fdm_cuda.fdm_cheby_plain(solo, conv=_port_conv(plan, keys[2:3]), **kw)
    np.testing.assert_array_equal(a[2].numpy(), b[0].numpy())
    assert int(ai[2]) == int(bi[0])


def test_wrapper_refuses_unported_layouts(plan):
    """Every layout of fdm_step_pallas is ported: the stack blocks and a
    precomputed word plane run (the plain versions on CPU tensors), and the
    kernel launchers still take CUDA tensors only."""
    temp, q, t_inf, h, keys = _inputs(plan["jg"].shape, 3, seed=8)
    args = (*_torch(temp, q, t_inf, h), plan["tc"])
    fdm_cuda.reset_launch_counts()
    stack = fdm_cuda.fdm_step_cuda(*args, block_envs=2, block_mode="stack", **FDM_KW)
    solo = fdm_cuda.fdm_step_cuda(*args, **FDM_KW)
    for a, b in zip(stack, solo):
        assert torch.equal(a, b)
    tb = plan["tb"]
    words = tconv.decision_word_from_key(torch.as_tensor(keys.astype(np.int64)),
                                         tconv.decision_word_params(tb), plan["jg"].shape)
    conv = dict(conv_offsets=tb.offsets, conv_lead=tb.lead_words, conv_foll=tb.foll_words)
    by_word = fdm_cuda.fdm_step_cuda(*args, conv_word=words, **conv, **FDM_KW)
    by_key = fdm_cuda.fdm_step_cuda(
        *args, conv_keys=torch.as_tensor(keys.astype(np.int64)),
        conv_word_params=tconv.decision_word_params(tb), **conv, **FDM_KW)
    for a, b in zip(by_word, by_key):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        # The kernel launchers take CUDA tensors only; no CPU fallback.
        fdm_cuda.fdm_jacobi_cuda(
            fdm_cuda.kernel_inputs(*args), threshold=0.1, iteration_limit=5)
    with pytest.raises(ValueError):
        fdm_cuda.fdm_cheby_block_cuda(
            fdm_cuda.kernel_inputs(*args), threshold=0.1, iteration_limit=5,
            spectral_radius=plan["rho"], block_envs=2)
    assert fdm_cuda.launch_counts == dict.fromkeys(fdm_cuda.launch_counts, 0)

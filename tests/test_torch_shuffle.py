"""Swap convection against the reference's exact shuffle, on the port's
CPU env, and the Chebyshev solve's statistics witnessed by the JAX
package.

* The port's counterpart of tests/test_convection.py:178-277: mix32 swap
  convection at B=4 (keys split from PRNGKey(42)) against four exact-host
  runs of the reference's shuffle (seeds 100-103), 36 steps, on the
  two-zone plan at p=1, distance=5 and on the 12-zone sb1 plan: worst
  per-zone KS <= 0.25 and worst zone-mean difference <= 0.5 K, through the
  JAX test's path (use_pallas=False: the batched Jacobi solve, convection
  after it) and through K2's plain version (convection in the kernel).
* The same comparison through K1's plain version (the interleaved
  Chebyshev solve with the swap rounds in the kernel) sits far outside
  those limits. The JAX package's own interleaved Chebyshev kernel
  (_fdm_cheby_kernel_interleaved, in interpret mode) on the same keys is
  the witness: its fields are K1's within 1e-3 K and its statistics are
  K1's, and they are the figures chip_smoke.py holds K1 to on the card.
  The JAX package's XLA Chebyshev solve with its convection after it is
  as far from the exact shuffle: the gap is the Chebyshev solve's, which
  converges past the loosely stopped Jacobi solve that the exact host runs,
  not the swap rounds'.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import chip_smoke
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.physics import fdm_pallas
from sbsim_tpu_torch import rng
from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import exact_host as teh
from sbsim_tpu_torch.envs import presets as tpresets

SETPOINTS = crs.SETPOINTS
STEPS = crs.N_STEPS  # 36, as tests/test_convection.py
SEEDS = tuple(100 + s for s in range(crs.SEEDS))  # 100-103, as crs.run_exact
KEY = crs.SWAP_KEY  # 42
B = len(SEEDS)
FIELD_TOL = 1e-3  # K: K1's plain version against the JAX kernel after 36 steps


def _config(presets, plan):
    if plan == "two_zone":
        cfg = presets.two_zone_test_config(occupancy_kind="step_function")
        return dataclasses.replace(
            cfg, convection=dataclasses.replace(cfg.convection, p=1.0, distance=5))
    cfg = presets.sb1_config(num_days_in_episode=1)
    return dataclasses.replace(cfg, occupancy=dataclasses.replace(cfg.occupancy,
                                                                  kind="step_function"))


def _worst_stats(zone_ids, n_zones, a, b):
    """tests/test_convection.py's statistics (scipy's KS)."""
    worst_ks = worst_dmean = 0.0
    for z in range(n_zones):
        m = zone_ids == z
        x, y = a[:, m].ravel(), b[:, m].ravel()
        worst_ks = max(worst_ks, stats.ks_2samp(x, y).statistic)
        worst_dmean = max(worst_dmean, abs(x.mean() - y.mean()))
    return worst_ks, worst_dmean


@functools.lru_cache(maxsize=None)
def _exact(plan):
    cfg = _config(tpresets, plan)
    out = []
    for seed in SEEDS:
        c = dataclasses.replace(cfg, convection=dataclasses.replace(cfg.convection, seed=seed))
        host = teh.ExactHostSimulator(tbe.BuildingEnv(c, device="cpu"))
        for _ in range(STEPS):
            host.step(SETPOINTS)
        out.append(host.temp.copy())
    return np.stack(out)


def _port_swap(plan, solver):
    env = tbe.BuildingEnv(_config(tpresets, plan), device="cpu")
    action = torch.as_tensor(env.default_action(SETPOINTS))[None].expand(B, -1).contiguous()
    states, _ = env.reset(rng.split(rng.PRNGKey(KEY), B))
    for _ in range(STEPS):
        states, _ = env.step_batched(states, action, use_pallas=False, solver=solver)
    return states.temp.numpy(), env


@pytest.mark.parametrize("solver", [None, "pallas_env"])
@pytest.mark.parametrize("plan", ["two_zone", "sb1_12zone"])
def test_distribution_matches_exact_shuffle(plan, solver):
    swap, env = _port_swap(plan, solver)
    zone_ids = np.asarray(env.geom.zone_ids)
    worst_ks, worst_dmean = _worst_stats(zone_ids, env.n_zones, swap, _exact(plan))
    assert worst_ks <= chip_smoke.KS_LIMIT, worst_ks
    assert worst_dmean <= chip_smoke.DMEAN_LIMIT, worst_dmean
    # The scripts (and chip_smoke.py's shuffle12) compute the same
    # statistics without scipy.
    assert crs.worst_stats(env, swap, _exact(plan)) == pytest.approx(
        (worst_ks, worst_dmean), abs=1e-12)


def _jax_swap(cfg, solver, monkeypatch):
    monkeypatch.setattr(fdm_pallas, "fdm_step_pallas",
                        functools.partial(fdm_pallas.fdm_step_pallas, interpret=True))
    env = jbe.BuildingEnv(cfg)
    action = jnp.broadcast_to(jnp.asarray(env.default_action(SETPOINTS)), (B, env.n_actions))
    states, _ = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(KEY), B))

    def roll(s):
        def body(s, _):
            return env.step_batched(s, action, use_pallas=False, solver=solver)[0], None
        return jax.lax.scan(body, s, None, length=STEPS)[0]

    return np.asarray(jax.jit(roll)(states).temp)


def test_k1_statistics_witnessed_by_the_jax_kernel(monkeypatch):
    exact = _exact("sb1_12zone")
    k1, env = _port_swap("sb1_12zone", "pallas_cheby")
    zone_ids, n_zones = np.asarray(env.geom.zone_ids), env.n_zones
    ks, dmean = _worst_stats(zone_ids, n_zones, k1, exact)
    # The JAX package's interleaved Chebyshev kernel, swap rounds in the
    # kernel, on the same keys.
    witness = _jax_swap(_config(jpresets, "sb1_12zone"), "pallas_cheby", monkeypatch)
    np.testing.assert_allclose(k1, witness, atol=FIELD_TOL, rtol=0)
    w_ks, w_dmean = _worst_stats(zone_ids, n_zones, witness, exact)
    assert abs(ks - w_ks) <= chip_smoke.WITNESS_KS_TOL
    assert abs(dmean - w_dmean) <= chip_smoke.WITNESS_DMEAN_TOL
    # The figures chip_smoke.py holds K1 to on the card are the witness's.
    assert abs(w_ks - chip_smoke.K1_WITNESS[0]) <= chip_smoke.WITNESS_KS_TOL / 4
    assert abs(w_dmean - chip_smoke.K1_WITNESS[1]) <= chip_smoke.WITNESS_DMEAN_TOL / 4
    assert w_ks > chip_smoke.KS_LIMIT
    # The JAX package's XLA Chebyshev solve, convection after it: as far
    # from the exact shuffle, so the gap is the solve's.
    cheby_cfg = dataclasses.replace(_config(jpresets, "sb1_12zone"), fdm_solver="chebyshev")
    xla = _jax_swap(cheby_cfg, None, monkeypatch)
    x_ks, x_dmean = _worst_stats(zone_ids, n_zones, xla, exact)
    assert x_ks > chip_smoke.KS_LIMIT and abs(x_dmean - w_dmean) < 0.05, (x_ks, x_dmean)

"""The scripts beside the port's package (sbsim_tpu_torch/benchmarks) on the
CPU, each held against the JAX script's logic, written inline here on the
JAX package, at small sizes.

* conv_rounds_sweep: the KS statistic is scipy.stats.ks_2samp's;
  `run_exact` is the JAX script's run_exact bitwise (the port's exact host
  is the JAX package's); `score_config` through K2's plain version is
  within 0.02 KS and 0.01 K of the JAX score through the XLA Jacobi solve.
* conv_schedule_search: --write-cache records the candidate in a copy of
  the schedule cache, which conv_cache.lookup and presets.sb1_config read
  back; the packaged cache is untouched.
* fullscale_parity_check: a small plan for a few steps in both
  orientations: the host fields bitwise the JAX ExactHostSimulator's, the
  device fields within 2e-4 K per step of the jitted JAX step's (one
  solve's bound: XLA contracts multiply-adds, the port does not;
  tests/test_torch_env.py), the modes equal.
* scaling: 1 and 2 gloo ranks; every row bitwise one process (the harness
  exits otherwise), the JSON with `results` and the scaling efficiency.
* sac_sb1_train: the schedule and constant baselines within 2 x REPLAY_ATOL
  of the JAX script's closures under xla_jacobi; `main` on the two-zone
  building writes every key of the JAX curve.

The two-zone learning recipe of tests/test_sac_learning.py on the card is
tests/test_torch_cuda.py::test_sac_improves_with_seeded_replay_on_the_card
(marked slow; that file imports no JAX, so it runs on the card's machine).
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from sbsim_tpu.agents import schedule_policy as jsched
from sbsim_tpu.core import geometry as jgeometry
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.envs.building_env import BuildingEnv as JEnv
from sbsim_tpu.envs.exact_host import ExactHostSimulator as JHost
from sbsim_tpu_torch import rng
from sbsim_tpu_torch.agents import schedule_policy as tsched
from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
from sbsim_tpu_torch.benchmarks import conv_schedule_search, sac_sb1_train, scaling
from sbsim_tpu_torch.benchmarks import fullscale_parity_check as fpc
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.scenario import conv_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETPOINTS = crs.SETPOINTS
KS_TOL, DMEAN_TOL = 0.02, 0.01  # K
FIELD_ATOL = 2e-4  # K: one FDM solve against jitted JAX (tests/test_torch_env.py)
RETURN_ATOL = 2 * 1e-4  # tests/test_torch_train.py:130, 2 x REPLAY_ATOL
SWAP_STEPS = 12


def _two_zone(presets):
    """The two-zone building with swap convection on (p=1, distance 5)."""
    cfg = presets.two_zone_test_config(occupancy_kind="step_function")
    return dataclasses.replace(cfg, convection=dataclasses.replace(cfg.convection, p=1.0,
                                                                   distance=5))


# ---------------------------------------------------------------------------
# conv_rounds_sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ks_statistic_is_scipy_s(seed):
    rs = np.random.default_rng(seed)
    x = rs.normal(0.0, 1.0, 60 + 7 * seed).astype(np.float32)
    y = np.round(rs.normal(0.2, 1.3, 45), 1)  # ties within y and across
    y[:5] = x[:5]
    assert crs.ks_statistic(x, y) == pytest.approx(stats.ks_2samp(x, y).statistic, abs=1e-12)


def _jax_run_exact(cfg):
    """benchmarks/conv_rounds_sweep.py's run_exact."""
    out = []
    for s in range(crs.SEEDS):
        c2 = dataclasses.replace(cfg, convection=dataclasses.replace(cfg.convection,
                                                                     seed=100 + s))
        host = JHost(JEnv(c2))
        for _ in range(crs.N_STEPS):
            host.step(SETPOINTS)
        out.append(host.temp.copy())
    return np.stack(out)


def _jax_run_swap(cfg):
    """benchmarks/conv_rounds_sweep.py's run_swap (use_pallas=False: the XLA
    solver of the config's method)."""
    env = JEnv(cfg)
    action = jnp.asarray(env.default_action(SETPOINTS))
    keys = jax.random.split(jax.random.PRNGKey(42), crs.SEEDS)
    states, _ = jax.jit(jax.vmap(env.reset))(keys)

    def roll(s):
        def body(s, _):
            s, _ = env.step_batched(s, jnp.broadcast_to(action, (crs.SEEDS, action.shape[0])),
                                    use_pallas=False)
            return s, None

        return jax.lax.scan(body, s, None, length=crs.N_STEPS)[0]

    return np.asarray(jax.jit(roll)(states).temp), env


def test_run_exact_is_the_jax_script_s_bitwise(monkeypatch):
    monkeypatch.setattr(crs, "N_STEPS", 3)
    got = crs.run_exact(_two_zone(tpresets), device="cpu")
    want = _jax_run_exact(_two_zone(jpresets))
    assert got.shape == (crs.SEEDS, 9, 11)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])  # the seeds' shuffles differ


def test_score_config_meets_the_jax_score(monkeypatch):
    monkeypatch.setattr(crs, "N_STEPS", SWAP_STEPS)
    exact = crs.run_exact(_two_zone(tpresets), device="cpu")
    env, ks, dmean = crs.score_config(_two_zone(tpresets), exact, device="cpu")
    jswap, jenv = _jax_run_swap(_two_zone(jpresets))
    worst_ks = worst_dmean = 0.0  # benchmarks/conv_rounds_sweep.py's worst_stats
    zone_ids = np.asarray(jenv.geom.zone_ids)
    for z in range(jenv.n_zones):
        m = zone_ids == z
        x, y = jswap[:, m].ravel(), exact[:, m].ravel()
        worst_dmean = max(worst_dmean, abs(x.mean() - y.mean()))
        worst_ks = max(worst_ks, stats.ks_2samp(x, y).statistic)
    assert abs(ks - round(float(worst_ks), 4)) <= KS_TOL
    assert abs(dmean - round(float(worst_dmean), 4)) <= DMEAN_TOL
    swap, _ = crs.run_swap(_two_zone(tpresets), device="cpu")
    np.testing.assert_allclose(swap, jswap, rtol=0, atol=SWAP_STEPS * FIELD_ATOL)
    assert env.n_zones == 2


# ---------------------------------------------------------------------------
# conv_schedule_search
# ---------------------------------------------------------------------------


def test_schedule_search_writes_a_copy_of_the_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(crs, "N_STEPS", 4)
    packaged = conv_cache._CACHE_PATH
    with open(packaged, "rb") as f:
        before = f.read()
    cache = tmp_path / "conv_schedules.json"
    cache.write_bytes(before)
    monkeypatch.setattr(conv_cache, "_CACHE_PATH", str(cache))
    out = tmp_path / "search.json"
    result = conv_schedule_search.main([
        "--cpu", "--rooms-x", "2", "--rooms-y", "2", "--room-cvs", "10", "--rounds", "8",
        "--seeds", "5", "--budget", "1.0", "--write-cache", "--out", str(out)])
    assert result["verdict"]["recommendation"] == "r8_s5"
    assert [r["candidate"] for r in result["rows"]] == ["auto_default", "r8_s5"]
    assert result["rows"][0]["rounds"] == 16 and result["card"] == "cpu"
    assert json.loads(out.read_text())["verdict"] == result["verdict"]
    plan = jgeometry.make_synthetic_office_plan(2, 2, room_cvs=10)
    entry = conv_cache.lookup(plan)
    assert (entry["rounds"], entry["seed"]) == (8, 5) and entry["source"] == str(out)
    assert result["cache_key"] == conv_cache.plan_fingerprint(plan)
    conv = tpresets.sb1_config(floor_plan=plan).convection
    assert (conv.rounds, conv.seed) == (8, 5)
    with open(packaged, "rb") as f:
        assert f.read() == before
    # Without a winner nothing is written: the budget admits no candidate.
    cache.write_bytes(before)
    result = conv_schedule_search.main([
        "--cpu", "--rooms-x", "2", "--rooms-y", "2", "--room-cvs", "10", "--rounds", "8",
        "--seeds", "5", "--budget", "0.0", "--write-cache"])
    assert result["verdict"]["recommendation"] == "auto_default" and "cache_key" not in result
    assert cache.read_bytes() == before


# ---------------------------------------------------------------------------
# fullscale_parity_check
# ---------------------------------------------------------------------------

PARITY_PLAN, PARITY_STEPS = (2, 3, 8), 4


@pytest.mark.parametrize("layout", ["ref", "transposed"])
def test_parity_day_meets_the_jax_script(layout):
    env = tbe.BuildingEnv(fpc.parity_config(layout, plan=PARITY_PLAN), device="cpu")
    day = fpc.parity_day(env, PARITY_STEPS, log=lambda m: None)
    # benchmarks/fullscale_parity_check.py's loop on the JAX package.
    cfg = jpresets.sb1_config(
        num_days_in_episode=1, convection_p=0.0, layout=layout,
        floor_plan=jgeometry.make_synthetic_office_plan(*PARITY_PLAN[:2],
                                                        room_cvs=PARITY_PLAN[2]))
    jenv = JEnv(dataclasses.replace(cfg, occupancy=dataclasses.replace(cfg.occupancy,
                                                                       kind="step_function")))
    assert tuple(env.geom.shape) == tuple(jenv.geom.shape)
    host = JHost(jenv)
    state, _ = jenv.reset(jax.random.PRNGKey(0))
    step = jax.jit(jenv.step)
    action = jnp.asarray(jenv.default_action(SETPOINTS))
    for _ in range(PARITY_STEPS):
        state, _ = step(state, action)
        host.step(SETPOINTS)
    np.testing.assert_array_equal(day.host.temp, host.temp)
    assert day.host.mode == host.mode
    np.testing.assert_allclose(day.state.temp[0].numpy(), np.asarray(state.temp), rtol=0,
                               atol=PARITY_STEPS * FIELD_ATOL)
    assert day.state.hvac.thermostat_mode[0].tolist() == np.asarray(
        state.hvac.thermostat_mode).tolist()
    assert day.held and all(day.modes_equal) and len(day.drifts) == PARITY_STEPS
    assert max(day.drifts) == day.report.max_drift


def test_parity_day_records_a_failed_hold(monkeypatch):
    """A tracker that fails does not end the day: the steps run on, and
    the failure is recorded with its step."""
    env = tbe.BuildingEnv(fpc.parity_config("ref", plan=PARITY_PLAN), device="cpu")
    tracker = fpc.exact_host.ParityTracker
    monkeypatch.setattr(fpc.exact_host, "ParityTracker", lambda: tracker(budget=0.0))
    day = fpc.parity_day(env, 2, log=lambda m: None)
    assert not day.held and day.error_step == 0 and "budget 0.0" in day.error
    assert len(day.drifts) == 2 and int(day.state.step_idx[0]) == 2


# ---------------------------------------------------------------------------
# scaling
# ---------------------------------------------------------------------------


def test_scaling_rows_are_one_process(tmp_path):
    out = tmp_path / "scaling.json"
    payload = scaling.main(["--cpu", "--devices", "1", "2", "--batch-per-device", "2",
                            "--steps", "2", "--repeats", "2", "--out", str(out)])
    assert json.loads(out.read_text()) == payload
    assert [r["devices"] for r in payload["results"]] == [1, 2]
    assert [r["batch"] for r in payload["results"]] == [2, 4]
    for row in payload["results"]:
        assert row["bitwise_one_process"] and len(row["slowest_rank_ms"]) == 2
        assert len(row["rank_ms"]) == row["devices"]
        assert row["per_device"] == pytest.approx(row["env_steps_per_sec"] / row["devices"],
                                                  abs=0.1)
    assert payload["summary"]["metric"] == "scaling_efficiency"
    assert (payload["summary"]["from_devices"], payload["summary"]["to_devices"]) == (1, 2)
    assert (payload["card"], payload["backend"], payload["mode"]) == ("cpu", "gloo",
                                                                      "shard_map")


def test_scaling_flags():
    args = scaling.parse_args(["--cpu", "--shard-map", "--ranks", "1", "2"])
    assert (args.devices, args.backend, args.solver) == ([1, 2], "gloo", "pallas_cheby")
    assert scaling.parse_args([]).backend == "nccl"
    with pytest.raises(SystemExit):
        scaling.parse_args(["--cpu", "--backend", "nccl"])


# ---------------------------------------------------------------------------
# sac_sb1_train
# ---------------------------------------------------------------------------

EVAL_ENVS = 2


def test_baselines_meet_the_jax_script_s_closures():
    jenv = JEnv(jpresets.two_zone_test_config())
    tenv = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    n_eval = tenv.steps_per_episode
    table = jnp.asarray(jsched.build_schedule_actions(jenv))
    act = np.asarray([0.5, -0.25], np.float32)

    # benchmarks/sac_sb1_train.py's closures, under the parity solver.
    def schedule_return(key, solver):
        env_states, _ = jax.vmap(jenv.reset)(jax.random.split(key, EVAL_ENVS))

        def body(s, _):
            a = table[jnp.clip(s.step_idx, 0, table.shape[0] - 1)]
            s, out = jenv.step_batched(s, a, solver=solver)
            return s, out.reward

        _, rewards = jax.lax.scan(body, env_states, None, length=n_eval)
        return jnp.mean(jnp.sum(rewards, axis=0))

    def constant_return(a, key, solver):
        env_states, _ = jax.vmap(jenv.reset)(jax.random.split(key, EVAL_ENVS))

        def body(s, _):
            s, out = jenv.step_batched(s, jnp.broadcast_to(a, (EVAL_ENVS, jenv.n_actions)),
                                       solver=solver)
            return s, out.reward

        _, rewards = jax.lax.scan(body, env_states, None, length=n_eval)
        return jnp.mean(jnp.sum(rewards, axis=0))

    want_s = float(jax.jit(schedule_return, static_argnums=1)(jax.random.PRNGKey(7),
                                                              "xla_jacobi"))
    want_c = float(jax.jit(constant_return, static_argnums=2)(jnp.asarray(act),
                                                              jax.random.PRNGKey(7),
                                                              "xla_jacobi"))
    ttable = tsched.build_schedule_actions(tenv)
    got_s = sac_sb1_train.schedule_return(tenv, ttable, rng.PRNGKey(7), n_eval, EVAL_ENVS,
                                          "xla_jacobi")
    got_c = sac_sb1_train.constant_return(tenv, act, rng.PRNGKey(7), n_eval, EVAL_ENVS,
                                          "xla_jacobi")
    assert n_eval == 288
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=RETURN_ATOL)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=RETURN_ATOL)
    assert got_s != got_c


def test_main_writes_every_key_of_the_jax_curve(monkeypatch, tmp_path):
    monkeypatch.setattr(sac_sb1_train, "presets", types.SimpleNamespace(
        sb1_config=lambda **kw: tpresets.two_zone_test_config()))
    out = tmp_path / "curve.json"
    result = sac_sb1_train.main([
        "--cpu", "--n-envs", "2", "--seed-steps", "4", "--chunk", "2", "--train-steps", "4",
        "--eval-every", "2", "--eval-envs", "2", "--label-suffix", "_test", "--out", str(out)])
    assert json.loads(out.read_text()) == result
    with open(os.path.join(REPO, "artifacts", "sac_sb1_12zone_curve.json")) as f:
        assert set(json.load(f)) <= set(result)
    assert result["label"] == "sb1_12zone_test" and result["card"] == "cpu"
    assert [c["env_steps"] for c in result["curve"]] == [0, 2, 4]
    assert all(np.isfinite(c["eval_return"]) for c in result["curve"])
    assert result["best_return"] == round(max(c["eval_return"] for c in result["curve"]), 4)
    assert result["parity_eval"] is None and result["best_constant"] is None

"""The study scripts of the port (sbsim_tpu_torch/benchmarks:
conv_fullscale_null, conv_designed_sweep, conv_schedule_sweep, sac_smoke,
sac_sb1_smoke, scaling_decomp) on the CPU, each held against the JAX
script's own functions, imported from benchmarks/ in-process, on
make_synthetic_office_plan(2, 2, room_cvs=10) with N_STEPS cut.

* run_exact(seed_base=...) is the JAX script's run_exact_seedbase bitwise
  (the exact host is host numpy in both packages).
* The null, designed and schedule rows are within KS_TOL / DMEAN_TOL of the
  JAX script's (the swap path: K2's plain version against the XLA Jacobi
  solve); exact_vs_exact equal (its KS to scipy's 1e-12), offsets and p_round
  equal exactly.
* rollout_fixed is within RETURN_ATOL of the JAX closure; the SAC smokes
  keep the JAX recipes (read from the JAX scripts' source) and return
  finite numbers under every printed key.
* scaling_decomp's rows are bitwise one process and its taxes are the JAX
  formulas on its rates.
"""

import ast
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from sbsim_tpu.agents import schedule_policy as jsched
from sbsim_tpu.core import geometry as jgeometry
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.envs.building_env import BuildingEnv as JEnv
from sbsim_tpu_torch.agents import schedule_policy as tsched
from sbsim_tpu_torch.benchmarks import conv_designed_sweep as cds
from sbsim_tpu_torch.benchmarks import conv_fullscale_null as null
from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
from sbsim_tpu_torch.benchmarks import conv_schedule_sweep as css
from sbsim_tpu_torch.benchmarks import sac_sb1_smoke, sac_smoke, scaling_decomp
from sbsim_tpu_torch.core import geometry as tgeometry
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.envs.building_env import BuildingEnv as TEnv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHMARKS = os.path.join(REPO, "benchmarks")
sys.path.insert(0, BENCHMARKS)
try:
    import conv_designed_sweep as jds  # noqa: E402
    import conv_fullscale_null as jnull  # noqa: E402
    import conv_rounds_sweep as jcrs  # noqa: E402
    import conv_schedule_sweep as jss  # noqa: E402
    import sac_smoke as jsac  # noqa: E402
finally:
    sys.path.remove(BENCHMARKS)

KS_TOL, DMEAN_TOL = 0.02, 0.01  # tests/test_torch_scripts.py
RETURN_ATOL = 2 * 1e-4  # tests/test_torch_train.py:130, 2 x REPLAY_ATOL
PLAN = (2, 2, 10)
STEPS = 6
PLAN_FLAGS = ["--rooms-x", "2", "--rooms-y", "2", "--room-cvs", "10"]


def _base(presets, geometry):
    """The scripts' base config (sb1, one day, step-function occupancy) on
    the small plan."""
    plan = geometry.make_synthetic_office_plan(PLAN[0], PLAN[1], room_cvs=PLAN[2])
    cfg = presets.sb1_config(num_days_in_episode=1, floor_plan=plan)
    return dataclasses.replace(cfg, occupancy=dataclasses.replace(cfg.occupancy,
                                                                  kind="step_function"))


@pytest.fixture
def cut(monkeypatch):
    """N_STEPS cut to STEPS in both packages' scripts."""
    for module in (crs, jcrs, jnull):
        monkeypatch.setattr(module, "N_STEPS", STEPS)


def _near(got: dict, want: dict) -> None:
    assert abs(got["worst_zone_ks"] - want["worst_zone_ks"]) <= KS_TOL, (got, want)
    assert abs(got["worst_zone_dmean_K"] - want["worst_zone_dmean_K"]) <= DMEAN_TOL, (got, want)


# ---------------------------------------------------------------------------
# conv_fullscale_null
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed_base", [100, 200])
def test_run_exact_is_the_jax_run_exact_seedbase_bitwise(monkeypatch, seed_base):
    monkeypatch.setattr(crs, "N_STEPS", 3)
    monkeypatch.setattr(jnull, "N_STEPS", 3)
    got = crs.run_exact(_base(tpresets, tgeometry), device="cpu", seed_base=seed_base)
    want = jnull.run_exact_seedbase(_base(jpresets, jgeometry), seed_base)
    assert got.shape == (crs.SEEDS, 29, 29)
    np.testing.assert_array_equal(got, want)


def test_null_rows_meet_the_jax_script_s(cut, monkeypatch, tmp_path):
    """The JAX script's main and the port's on the small plan: the same
    plan line and keys (plus `card`), exact_vs_exact equal, the two swap
    rows within the tolerances."""
    monkeypatch.setattr(sys, "argv", ["conv_fullscale_null.py", *PLAN_FLAGS,
                                      "--out", str(tmp_path / "jax.json")])
    jnull.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    got = null.main(["--cpu", *PLAN_FLAGS, "--out", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert set(got) == set(want) | {"card"} and got["card"] == "cpu"
    assert got["plan"] == want["plan"] == "2x2 rooms, 10 CVs/side"
    # The exact host is bitwise; the KS statistic is scipy's to 1e-12.
    assert got["exact_vs_exact"] == pytest.approx(want["exact_vs_exact"], rel=0, abs=1e-12)
    _near(got["swap_vs_swap"], want["swap_vs_swap"])
    _near(got["swap_vs_exact_auto"], want["swap_vs_exact_auto"])


def test_second_swap_draw_takes_its_own_keys(cut):
    cfg = _base(tpresets, tgeometry)
    a, _ = crs.run_swap(cfg, "cpu")
    b, _ = crs.run_swap(cfg, "cpu", key=null.SWAP_KEYS[1])
    again, _ = crs.run_swap(cfg, "cpu", key=crs.SWAP_KEY)
    np.testing.assert_array_equal(a, again)
    assert not np.array_equal(a, b)


# ---------------------------------------------------------------------------
# conv_designed_sweep, conv_schedule_sweep
# ---------------------------------------------------------------------------


def test_designs_are_the_jax_script_s():
    assert cds.CORE == jds.CORE and cds.DESIGNS == jds.DESIGNS
    assert list(cds.DESIGNS) == list(jds.DESIGNS)


def test_designed_rows_meet_the_jax_script_s(cut):
    """conv_designed_sweep.sweep against the JAX script's loop (its main
    writes over its artifact, so the loop is run here on its functions)."""
    jbase = _base(jpresets, jgeometry)
    exact = jcrs.run_exact(jbase)
    control = dataclasses.replace(jbase, convection=dataclasses.replace(
        jbase.convection, rounds=10, seed=101))
    _, ks, dmean = jcrs.score_config(control, exact)
    want = [dict(name="control_seed101_r10", worst_zone_ks=ks, worst_zone_dmean_K=dmean)]
    for name, sched in jds.DESIGNS.items():
        cfg = dataclasses.replace(jbase, convection=dataclasses.replace(
            jbase.convection, schedule=sched))
        env, ks, dmean = jcrs.score_config(cfg, exact)
        want.append(dict(name=name, schedule=[list(s) for s in sched],
                         p_round=env.convection.p_round, worst_zone_ks=ks,
                         worst_zone_dmean_K=dmean))
    tbase = _base(tpresets, tgeometry)
    got, _ = cds.sweep(tbase, crs.run_exact(tbase, "cpu"), "cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g.get("schedule") == w.get("schedule") and g.get("p_round") == w.get("p_round")
        _near(g, w)


def test_schedule_rows_meet_the_jax_script_s(cut, monkeypatch, tmp_path):
    """The JAX script's main and the port's, both reading their variants
    and output from CONV_SWEEP_VARIANTS / CONV_SWEEP_OUT, on the small
    plan: offsets and p_round equal, the scores within the tolerances."""
    plan = jgeometry.make_synthetic_office_plan(PLAN[0], PLAN[1], room_cvs=PLAN[2])
    monkeypatch.setattr(jss, "presets", types.SimpleNamespace(
        sb1_config=lambda **kw: jpresets.sb1_config(floor_plan=plan, **kw)))
    tplan = tgeometry.make_synthetic_office_plan(PLAN[0], PLAN[1], room_cvs=PLAN[2])
    base_config = crs.base_config
    monkeypatch.setattr(crs, "base_config", lambda floor_plan=None: base_config(tplan))
    monkeypatch.setenv("CONV_SWEEP_VARIANTS", "12:5,8:101")
    monkeypatch.setenv("CONV_SWEEP_OUT", str(tmp_path / "jax.json"))
    jss.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    monkeypatch.setenv("CONV_SWEEP_OUT", str(tmp_path / "port.json"))
    got = css.main(["--cpu"])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["card"] == "cpu" and len(got["rows"]) == len(want) == 2
    for g, w in zip(got["rows"], want):
        assert set(g) == set(w)
        for k in ("rounds", "schedule_seed", "offsets", "p_round"):
            assert g[k] == w[k], k
        _near(g, w)


def test_variants_and_out_read_as_the_jax_script_reads_them(monkeypatch):
    """The defaults are the JAX script's seven variants (the rows of its
    artifact, in order); the environment is read in the JAX script's
    formats; a flag wins over its variable."""
    with open(os.path.join(REPO, "artifacts", "CONV_SCHEDULES_r04.json")) as f:
        jax_rows = json.load(f)
    monkeypatch.delenv("CONV_SWEEP_VARIANTS", raising=False)
    monkeypatch.delenv("CONV_SWEEP_OUT", raising=False)
    args = css.parse_args([])
    assert args.variants == [(r["rounds"], r["schedule_seed"]) for r in jax_rows]
    assert args.out == os.path.join("artifacts", "CONV_SCHEDULES_torch.json")
    text = "12:5,12:11,8:101"
    assert css.parse_variants(text) == [tuple(map(int, v.split(":")))
                                        for v in text.split(",")]  # the JAX script's
    monkeypatch.setenv("CONV_SWEEP_VARIANTS", text)
    monkeypatch.setenv("CONV_SWEEP_OUT", "mine.json")
    args = css.parse_args([])
    assert args.variants == [(12, 5), (12, 11), (8, 101)]
    assert args.out == os.path.join("artifacts", "mine.json")
    args = css.parse_args(["--variants", "16:5", "--out", "/tmp/x.json"])
    assert args.variants == [(16, 5)] and args.out == "/tmp/x.json"


def test_default_outs_name_no_jax_artifact(monkeypatch):
    monkeypatch.delenv("CONV_SWEEP_OUT", raising=False)
    outs = [null.parse_args([]).out, cds.parse_args([]).out, css.parse_args([]).out]
    assert outs == ["artifacts/CONV_FULLSCALE_NULL_torch.json",
                    "artifacts/CONV_DESIGNED_torch.json",
                    os.path.join("artifacts", "CONV_SCHEDULES_torch.json")]
    for out in outs:
        assert "_r0" not in out and not os.path.exists(os.path.join(REPO, out))
    assert scaling_decomp.parse_args([]).out is None


# ---------------------------------------------------------------------------
# sac_smoke, sac_sb1_smoke
# ---------------------------------------------------------------------------


def _jax_recipe(script: str) -> dict:
    """The JAX script's TrainConfig keywords, its `range(...)` loop counts,
    its `% N` evaluation period and its n_eval, read from its source."""
    tree = ast.parse(open(os.path.join(BENCHMARKS, script)).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    out = {"ranges": [], "every": []}
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "TrainConfig":
            out["config"] = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "range":
            out["ranges"].append(ast.literal_eval(node.args[0]))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            out["every"].append(ast.literal_eval(node.right))
        elif (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "n_eval"):
            out["n_eval"] = ast.literal_eval(node.value)
    return out


@pytest.mark.parametrize("module,script", [(sac_smoke, "sac_smoke.py"),
                                           (sac_sb1_smoke, "sac_sb1_smoke.py")])
def test_smokes_keep_the_jax_recipes(module, script):
    jax_recipe = _jax_recipe(script)
    args = module.parse_args([])
    assert module.RECIPE == jax_recipe["config"]
    assert [args.seed_steps, args.train_steps] == jax_recipe["ranges"]
    assert [args.eval_every] == jax_recipe["every"]
    assert module.N_EVAL == jax_recipe["n_eval"]
    if module is sac_sb1_smoke:
        with pytest.raises(SystemExit):
            module.parse_args(["--seed-steps", "0"])


def test_rollout_fixed_meets_the_jax_closure():
    jenv = JEnv(jpresets.two_zone_test_config(num_days_in_episode=1))
    tenv = TEnv(tpresets.two_zone_test_config(num_days_in_episode=1), device="cpu")
    want = jsac.rollout_fixed(jenv, jsched.build_schedule_actions(jenv), sac_smoke.N_EVAL)
    got = sac_smoke.rollout_fixed(tenv, tsched.build_schedule_actions(tenv), sac_smoke.N_EVAL)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=0, atol=RETURN_ATOL)


@pytest.mark.parametrize("module,keys", [
    (sac_smoke, ["schedule_return", "untrained_return", "replay_size", "final_return"]),
    (sac_sb1_smoke, ["grid", "zones", "obs", "replay_size", "schedule_step_reward",
                     "untrained_return"]),
])
def test_smoke_main_returns_finite_numbers(monkeypatch, module, keys):
    """main at 4 train steps (evaluations cut to 12 steps): every number it
    prints is in its dict and finite; one curve row per evaluation."""
    monkeypatch.setattr(module, "N_EVAL", 12)
    result = module.main(["--cpu", "--train-steps", "4", "--seed-steps", "3",
                          "--eval-every", "2"])
    assert set(result) == {"card", "curve", *keys} and result["card"] == "cpu"
    assert result["replay_size"] == 3
    assert [c["step"] for c in result["curve"]] == [2, 4]
    numbers = [v for k, v in result.items() if k not in ("card", "curve", "grid")]
    numbers += [v for c in result["curve"] for v in c.values()]
    assert all(np.isfinite(v) for v in numbers), result


# ---------------------------------------------------------------------------
# scaling_decomp
# ---------------------------------------------------------------------------


def _jax_attribution(rates, n_dev):
    """benchmarks/scaling_decomp.py:176-194, with its row names."""
    return {
        "naive_efficiency": round(
            (rates["shardmap_ndev_big"] / n_dev) / rates["plain_1dev_b64"], 3),
        "wrapper_tax": round(1 - rates["shardmap_1dev_b64"] / rates["plain_1dev_b64"], 3),
        "core_sharing_tax": round(
            1 - (rates["plain_1dev_big"] / n_dev) / rates["plain_1dev_b64"], 3),
        "partition_tax": round(1 - rates["shardmap_ndev_big"] / rates["plain_1dev_big"], 3),
        "collective_share": round(
            (rates["shardmap_ndev_big_nopmean"] - rates["shardmap_ndev_big"])
            / rates["shardmap_ndev_big"], 3),
    }


@pytest.mark.parametrize("ranks", [1, 2])
def test_scaling_decomp_rows_are_one_process(tmp_path, ranks):
    out = tmp_path / "decomp.json"
    payload = scaling_decomp.main(["--cpu", "--ranks", str(ranks), "--batch-per-device", "2",
                                   "--steps", "2", "--repeats", "2", "--out", str(out)])
    assert json.loads(out.read_text()) == payload
    names = ["plain_1dev_b2", "shardmap_1dev_b2", "plain_1dev_big", "shardmap_ndev_big",
             "shardmap_ndev_big_nopmean"]
    assert list(payload["rows"]) == list(payload["rates_env_steps_per_s"]) == names
    assert [(r["devices"], r["batch"]) for r in payload["rows"].values()] == [
        (1, 2), (1, 2), (1, 2 * ranks), (ranks, 2 * ranks), (ranks, 2 * ranks)]
    assert all(r["bitwise_one_process"] for r in payload["rows"].values())
    assert (payload["n_devices"], payload["card"], payload["backend"]) == (ranks, "cpu", "gloo")
    rates = {k.replace("_b2", "_b64"): v for k, v in payload["rates_env_steps_per_s"].items()}
    assert payload["attribution"] == _jax_attribution(rates, ranks)


def test_scaling_decomp_refuses_more_nccl_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 cards"):
        scaling_decomp.main(["--ranks", "2", "--backend", "nccl"])
    assert scaling_decomp.parse_args(["--cpu", "--devices", "2"]).backend == "gloo"

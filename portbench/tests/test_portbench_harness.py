"""CPU tests of the port's benchmark (portbench/): the registry by name, a
dry run of each traffic kind at a tiny size through the kernels' plain
versions, the reference against the program's own tables, the frozen
arithmetic against hand counts, the import guard, the controls and planted
faults coming out as not correct, and, on a card, one short run of
office12.rollout.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import compare, faults, harness, inputs, yardstick
from portbench.drivers import rollout, train
from portbench.oracle import building, clock
from portbench.oracle import step as ostep

ROOT = harness.ROOT
CPU = torch.device("cpu")
# office12 on a 2 x 2 office of 10 x 10 rooms with one-day episodes: every
# layer of the configuration at a size a test can hold.
TINY = dict(harness.config_spec("office12"), name="tiny", num_days_in_episode=1,
            floor_plan={"n_rooms_x": 2, "n_rooms_y": 2, "room_cvs": 10, "air_margin": 3},
            zones=4, sizes={"grid": [29, 29], "zones": 4, "episode_steps": 288},
            # No searched swap schedule exists for this plan: the program
            # sizes its rounds itself (rounds 0 in its configuration).
            convection={"p": 1.0, "distance": 5, "rounds": 0, "rng": "mix32", "word_planes": 2})
ROLLOUT = dict(harness.traffic_spec("rollout"), batch=4)
TRAIN = dict(harness.traffic_spec("train"), n_envs=4, batch_size=16, replay_capacity=400,
             seed_episodes_steps=16)
SEED = 2**31 + 4321


def _cell(name: str, traffic) -> harness.Cell:
    real = harness.cell(name)
    return harness.Cell(name, 1, TINY, traffic, real.end_to_end, real.per_layer)


def _rollout(system=None, trace=False):
    actions = inputs.schedule_table(TINY, ROLLOUT)
    system = system or rollout.ProgramRollout(TINY, ROLLOUT, CPU, actions)
    return rollout.run(_cell("office12.rollout", ROLLOUT), seed=SEED, seconds=0.2, trace=trace,
                       t_start=time.perf_counter(), system=system)


def _train(system=None, trace=False, monkeypatch=None):
    # The tiny window reaches episode steps 9 and 11, not the cell's.
    monkeypatch.setattr(train, "WINDOW_COMPARED", (9, 11))
    table = inputs.schedule_table(TINY, TRAIN)
    system = system or train.ProgramTraining(TINY, TRAIN, CPU, table, SEED)
    return train.run(_cell("office12.train", TRAIN), seed=SEED, seconds=0.2, trace=trace,
                     t_start=time.perf_counter(), system=system)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_every_cell_finds_its_files_by_name():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        c = harness.cell(w["name"], bench)
        assert c.config["name"] == w["config"]
        assert c.traffic["kind"] in ("rollout", "train")
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        assert len(c.end_to_end) >= 2 and c.per_layer
        harness.driver(c.traffic["kind"])
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


def test_a_new_cell_is_new_files_and_entries(tmp_path, monkeypatch):
    """A configuration, a mix and a metric added as files, and a cell and a
    metric added as entries, are found without editing any file."""
    work = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub), work / sub)
    spec = dict(TINY, name="tiny2")
    (work / "configs" / "tiny2.json").write_text(json.dumps(spec))
    (work / "traffic" / "rollout_b6.json").write_text(json.dumps(ROLLOUT))
    (work / "metrics" / "calls.rollout.py").write_text(
        "def read(trace):\n    return None if trace is None else trace['steps']\n")
    bench = harness.benchmark()
    bench["workloads"].append({"name": "tiny2.rollout", "config": "tiny2",
                               "traffic": "rollout_b6", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls.rollout", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "env phases",
                               "moves": "rollout_env_steps_per_s",
                               "workloads": ["tiny2.rollout"]})
    for m in bench["end_to_end"]:
        if m["name"] == "rollout_env_steps_per_s":
            m["workloads"].append("tiny2.rollout")
    monkeypatch.setattr(harness, "HERE", str(work))
    c = harness.cell("tiny2.rollout", bench)
    assert c.config == spec and c.traffic == ROLLOUT
    assert [m["name"] for m in c.per_layer] == ["calls.rollout"]
    assert harness.metric_reader("calls.rollout")({"steps": 3}) == 3


# ---------------------------------------------------------------------------
# Dry runs and the result line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rollout", "train"])
@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_prints_the_contract_keys(kind, trace, monkeypatch):
    outcome = (_rollout(trace=trace) if kind == "rollout"
               else _train(trace=trace, monkeypatch=monkeypatch))
    c = harness.cell("office12.rollout" if kind == "rollout" else "office12.train")
    line = json.loads(json.dumps(harness.result_line(c, outcome, trace, "cpu")))
    assert list(line) == (["correct", "attempted", "failed", "metrics", "device"]
                          + (["breakdown"] if "breakdown" in line else []) + ["compared"])
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    # A CPU run has no device trace: the per-layer readers find nothing.
    assert set(line["metrics"]) == (set() if trace else names)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["compared"]) == set(compare.STEP_LIMITS if kind == "rollout"
                                        else compare.TRAIN_LIMITS)


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "office12.rollout",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode == 2 and out.stdout == ""


# ---------------------------------------------------------------------------
# Controls and faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["control"] + list(faults.ROLLOUT_FAULTS))
def test_rollout_control_and_faults_are_not_correct(what):
    actions = inputs.schedule_table(TINY, ROLLOUT)
    if what == "control":
        system = faults.ReferenceRollout(TINY, ROLLOUT, CPU, actions)
    else:
        system = faults.rollout_fault(rollout.ProgramRollout(TINY, ROLLOUT, CPU, actions), what)
    assert not harness.passed(_rollout(system).comparisons)


@pytest.mark.parametrize("what", ["control"] + list(faults.TRAIN_FAULTS))
def test_train_control_and_faults_are_not_correct(what, monkeypatch):
    table = inputs.schedule_table(TINY, TRAIN)
    system = train.ProgramTraining(TINY, TRAIN, CPU, table, SEED)
    if what == "control":
        system = faults.tf32_training(system)
    else:
        system = faults.train_fault(system, what)
    assert not harness.passed(_train(system, monkeypatch=monkeypatch).comparisons)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-12, 1.0 + 2.0**-11 + 2.0**-13, -3.0])
    assert faults._round_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-10, -3.0]


def test_a_program_that_departs_from_the_file_is_refused():
    spec = json.loads(json.dumps(TINY))
    spec["hvac"]["boiler_setpoint"] = 359.0
    with pytest.raises(ValueError, match="hvac"):
        rollout.ProgramRollout(spec, ROLLOUT, CPU, inputs.schedule_table(spec, ROLLOUT))


# ---------------------------------------------------------------------------
# The reference's own tables against the program's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["office12", "office126"])
def test_the_reference_grid_is_the_programs(name):
    from sbsim_tpu_torch.envs.building_env import BuildingEnv

    spec = harness.config_spec(name)
    geom = BuildingEnv(harness.env_config(spec), device="cpu").geom
    g = building.build(spec)
    for side in ("left", "right", "top", "bottom"):
        np.testing.assert_allclose(g.faces["k_" + side], getattr(geom, "k_" + side), rtol=1e-6)
        np.testing.assert_array_equal(g.faces["h_" + side], getattr(geom, "h_" + side))
    for k in ("u", "v", "diffusers", "density", "heat_capacity"):
        np.testing.assert_allclose(getattr(g, k), getattr(geom, k), rtol=1e-6)
    np.testing.assert_array_equal(g.fixed, geom.exterior_mask)
    np.testing.assert_array_equal(g.zone_ids, geom.zone_ids)


def test_the_reference_clock_is_the_programs():
    from sbsim_tpu_torch.scenario import tables, uscalendar

    day = datetime.date(2015, 1, 1)
    while day.year < 2031:
        assert clock.is_work_day(day) == uscalendar.is_work_day(day), day
        day += datetime.timedelta(days=1)
    start = datetime.datetime(2023, 1, 1, 0, 30, tzinfo=datetime.timezone.utc)
    for h in range(0, 24 * 365, 7):
        ts = start + datetime.timedelta(hours=h)
        for zone in clock.US_ZONES:
            assert clock.to_local(ts, zone) == tables.to_local(ts, zone), (ts, zone)


def test_the_reference_keys_are_the_programs():
    from sbsim_tpu_torch import rng

    keys = inputs.key_rows(SEED, 3, 5)
    for i in range(4):
        assert torch.equal(ostep.subkey(keys, i), rng.split(keys, 4)[:, i])


# ---------------------------------------------------------------------------
# Frozen arithmetic
# ---------------------------------------------------------------------------


def test_fdm_work_matches_a_hand_count():
    # 2 x 3 grid, one env, 5 iterations: bytes 4*6*4 planes per env, 5 + 2
    # shared planes, 28 per env; Jacobi 12 operations per cell update.
    shape = yardstick.SolveShape(batch=1, height=2, width=3, method="jacobi")
    assert yardstick.fdm_work(shape, 5) == (96 + 120 + 48 + 28, 360.0, 0.0)
    cheby = yardstick.SolveShape(batch=1, height=2, width=3, method="chebyshev",
                                 conv_rounds=2, word_rounds=3)
    # 15 per sub-iteration, 21 per env for J(x0) and J(x_f); int32: 7 per
    # round and 14 per hash round per cell.
    assert yardstick.fdm_work(cheby, 5) == (292, 6 * (75 + 21.0), 6 * 14 + 6 * 42.0)
    ms, by = yardstick.fdm_bound_ms(shape, 5, bw=292e3, flops=1e12)
    assert (ms, by) == (pytest.approx(1.0), "bytes")


def test_sac_update_flops_match_a_hand_count():
    actor, critic = [(3, 4)], [(5, 2)]
    a, c = 2 * 8 * 12, 2 * 8 * 10  # one forward pass over 8 rows
    assert yardstick.sac_update_flops(actor, critic, 8) == (a + 2 * c + 6 * c) + (3 * a + 4 * c)


def test_profile_window_reductions():
    w = yardstick.Window(kernels=[("fdm_a", 0, 10), ("b", 5, 20), ("c", 40, 50)],
                         labels=[("portbench.call", 0, 60)], start_us=0, end_us=60)
    assert yardstick.busy_us(w) == 30
    assert yardstick.kernel_sums(w.kernels) == {"fdm_a": (1, 10), "b": (1, 15), "c": (1, 10)}
    assert yardstick.idle_gaps(w) == [("portbench.call", 20e-6), ("portbench.call", 10e-6)]
    assert yardstick.peaks("NVIDIA H100 80GB HBM3") == ("SXM", (3.35e12, 67e12))


# ---------------------------------------------------------------------------
# What the harness and the reference import
# ---------------------------------------------------------------------------


def _loaded(modules: str):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {modules}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


def test_nothing_the_benchmark_runs_loads_jax():
    names = _loaded("portbench.run, portbench.harness, portbench.drivers.rollout, "
                    "portbench.drivers.train, portbench.faults, portbench.control, "
                    "sbsim_tpu_torch.bench, sbsim_tpu_torch.agents.train")
    assert not names & set(harness.FORBIDDEN)
    assert "sbsim_tpu_torch" in names


def test_the_reference_imports_nothing_of_the_program():
    names = _loaded("portbench.oracle.building, portbench.oracle.clock, "
                    "portbench.oracle.physics, portbench.oracle.step, portbench.oracle.sac.sac, "
                    "portbench.oracle.sac.replay, portbench.compare, portbench.inputs")
    assert "sbsim_tpu_torch" not in names and not names & set(harness.FORBIDDEN)


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["sbsim_tpu_torch", "sbsim_tpu_torch.envs", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "sbsim_tpu.envs", "flax"]) == [
        "flax", "jax.numpy", "sbsim_tpu.envs"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_office12_rollout_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "office12.rollout",
                          "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["rollout_env_steps_per_s"]["value"] > 0

"""CPU tests of the benchmark's floor126 configuration and its cell: the
file loads and the program's env built from it runs what it states, the
reference's grid is the program's, the cell finds its files and is
declared where the rollout metrics are, and the reader of
fdm_fixed_barriers.rollout reads the program's counters or nothing.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest

from portbench import harness, program_trace
from portbench.oracle import building

ROLLOUT = {"kind": "rollout", "steps": 24}


@pytest.fixture(scope="module")
def floor126():
    from sbsim_tpu_torch.envs.building_env import BuildingEnv

    spec = harness.config_spec("floor126")
    return spec, BuildingEnv(harness.env_config(spec), device="cpu")


def test_floor126_loads_and_the_program_runs_it(floor126):
    """check_env accepts the CPU env built from the file: its 466 x 721
    grid, 126 zones, 576-step episodes and every value the reference
    reads; the plan spans thread blocks, so the kernels' routes run the
    cluster bodies and the statistics come from the fold."""
    from sbsim_tpu_torch.physics import fdm_cuda

    spec, env = floor126
    harness.check_env(spec, env)
    assert spec["sizes"] == {"grid": [466, 721], "zones": 126, "episode_steps": 576}
    assert fdm_cuda.spans_blocks(env.geom.shape)
    assert env.kernel_path("pallas_cheby") == (True, False)
    assert env.kernel_path("pallas_env") == (True, False)
    params = env._conv_word_params
    assert len(env.convection.offsets) == params[0] == 16 and params[1] == spec["convection"][
        "word_planes"]


def test_the_reference_grid_is_floor126s(floor126):
    spec, env = floor126
    g, geom = building.build(spec), env.geom
    for side in ("left", "right", "top", "bottom"):
        np.testing.assert_allclose(g.faces["k_" + side], getattr(geom, "k_" + side), rtol=1e-6)
        np.testing.assert_array_equal(g.faces["h_" + side], getattr(geom, "h_" + side))
    np.testing.assert_array_equal(g.fixed, geom.exterior_mask)
    np.testing.assert_array_equal(g.zone_ids, geom.zone_ids)


def test_floor126_rollout_finds_its_files_and_metrics():
    bench = harness.benchmark()
    c = harness.cell("floor126.rollout", bench)
    assert c.traffic["kind"] == "rollout" and c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"rollout_env_steps_per_s", "setup_s"}
    layer = {m["name"] for m in c.per_layer}
    assert layer >= {"mfu.rollout", "fdm_roofline.rollout", "env_device_ms.rollout",
                     "kernels_per_step.rollout", "fdm_iters_per_step.rollout",
                     "graph_kernels_per_step.rollout"}
    assert "fdm_fixed_barriers.rollout" in layer
    assert (c.traffic["batch"], c.traffic["solver"], c.traffic["steps_per_call"]) == (
        128, "pallas_cheby", 1)
    others = [w["name"] for w in bench["workloads"] if w["name"] != "floor126.rollout"]
    assert all("fdm_fixed_barriers.rollout" not in {m["name"] for m in harness.cell(
        n, bench).per_layer} for n in others)


@pytest.mark.parametrize("counters,want", [
    ({"fdm.iterations": 13.0 * 128 * 24, "fdm.barriers": 32.0 * 128 * 24,
      "env.steps": 128 * 24}, 19.0),
    ({"fdm.iterations": 9.0 * 128 * 24, "fdm.barriers": 28.0 * 128 * 24,
      "env.steps": 128 * 24}, 19.0),
    ({"fdm.iterations": 13.0 * 128 * 24, "env.steps": 128 * 24}, None),
    ({}, None),
])
def test_fixed_barriers_read_the_programs_counters(counters, want, monkeypatch):
    """The barriers beside the iterations per solve where the program
    counted both (the same on fewer iterations), None without the barrier
    counter (a plan that fits one block, or the parent program), on an
    empty program and on a trace of another kind."""
    monkeypatch.setattr(program_trace, "snapshot", lambda: {"counters": counters})
    read = harness.metric_reader("fdm_fixed_barriers.rollout")
    assert read(ROLLOUT) == (None if want is None else pytest.approx(want))
    assert read({"kind": "train", "steps": 20}) is None and read(None) is None

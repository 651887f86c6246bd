"""Rendering, plots, profiling and the episode dashboard: the port against
the JAX package on the CPU.

* render: `_colormap`, `BuildingRenderer.render_array`, the `VisualLogger`
  frames and `BuildingImageGenerator.temperature_array` bitwise JAX's; the
  port's PNG (a zlib writer, no imaging library) decodes to the rendered
  frame, and with Pillow to the pixels of JAX's PNG; without Pillow the PIL
  Image and the GIF raise as in JAX.
* plots: `schedule_plot_data` over the sb1 day equals JAX's DataFrame;
  `EpisodeDashboard.update` accumulates what JAX's does; with matplotlib,
  `render` writes files of the same names.
* profiling: `PhaseTimer` counts, totals and report as JAX's on one clock;
  `device_trace` writes a Chrome trace on the CPU.
* the dashboard: `sbsim_tpu_torch.examples.episode_dashboard.main` on the
  CPU against the JAX script's loop (examples/episode_dashboard.py) on the
  same config: step count and timestamps exact, zone temperatures within
  FIELD_ATOL per solve (tests/test_torch_host.py).
"""

import base64
import glob
import importlib.util
import json
import os
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.io import plots as jplots
from sbsim_tpu.io import render as jrender
from sbsim_tpu.proto import building_pb2 as jbuilding
from sbsim_tpu.scenario import tables as jtables
from sbsim_tpu.utils import profiling as jprofiling
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.examples import episode_dashboard
from sbsim_tpu_torch.io import plots as tplots
from sbsim_tpu_torch.io import render as trender
from sbsim_tpu_torch.scenario import tables as ttables
from sbsim_tpu_torch.utils import profiling as tprofiling
from sbsim_tpu_torch.utils import testing as ttesting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_env.py)
DASHBOARD_STEPS = 12


def decode_png(data: bytes) -> np.ndarray:
    """chip_smoke.decode_png (8-bit RGB, filter type 0, standard library),
    which must succeed."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    pixels = chip_smoke.decode_png(data)
    assert pixels is not None
    return pixels


# ---- render ------------------------------------------------------------------------------


def _field(shape, seed):
    return np.random.default_rng(seed).uniform(276.0, 304.0, shape)


def test_colormap_and_render_array_are_jax():
    values = np.concatenate([np.linspace(-0.5, 1.5, 41), [np.nan]])
    np.testing.assert_array_equal(trender._colormap(values), jrender._colormap(values))
    walls = np.zeros((6, 7), bool)
    walls[0], walls[:, 3] = True, True
    diffusers = np.zeros((6, 7))
    diffusers[2, 5] = 1.0
    for cv_px in (1, 3):
        port = trender.BuildingRenderer(walls, cv_px=cv_px, vmin=282.0, vmax=301.0)
        jax_ = jrender.BuildingRenderer(walls, cv_px=cv_px, vmin=282.0, vmax=301.0)
        temps = _field((6, 7), cv_px)
        for kw in ({}, {"diffusers": diffusers}):
            got, want = port.render_array(temps, **kw), jax_.render_array(temps, **kw)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
        assert port.get_building_dimensions() == jax_.get_building_dimensions()


def test_visual_logger_frames_are_jax(tmp_path):
    walls = np.eye(4, 5, dtype=bool)
    port, jax_ = (trender.VisualLogger(trender.BuildingRenderer(walls), max_frames=3),
                  jrender.VisualLogger(jrender.BuildingRenderer(walls), max_frames=3))
    for i in range(4):
        temps = _field((4, 5), 10 + i)
        port.log(temps)
        jax_.log(temps)
    assert port.n_frames == jax_.n_frames == 3
    for a, b in zip(port._frames, jax_._frames, strict=True):
        np.testing.assert_array_equal(a, b)
    pytest.importorskip("PIL")
    from PIL import Image

    for logger, name in ((port, "port.gif"), (jax_, "jax.gif")):
        logger.get_video(str(tmp_path / name), fps=6, stride=2)
    with Image.open(tmp_path / "port.gif") as a, Image.open(tmp_path / "jax.gif") as b:
        assert a.n_frames == b.n_frames == 2
        np.testing.assert_array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))
    port.clear()
    with pytest.raises(ValueError, match="No frames"):
        port.get_video(str(tmp_path / "empty.gif"))


def _image_generators():
    grid = np.asarray([[0, 0, 2, 2], [1, 1, 2, 3], [1, 3, 3, 3]])
    walls = grid == 3
    ids = ["zone_id_1", "zone_id_2", "zone_x"]
    mapping = {"vav_x": "zone_x"}
    values = {("vav_room_1", "zone_air_temperature_sensor"): 291.0,
              ("vav_room_2", "zone_air_temperature_sensor"): 299.5,
              ("vav_x", "zone_air_temperature_sensor"): 302.0,
              ("vav_room_1", "supply_air_flowrate_sensor"): 1.0,
              ("vav_room_9", "zone_air_temperature_sensor"): 280.0}
    response = ttesting.observation_response(values)
    response.single_observation_responses[2].observation_valid = False
    port = trender.BuildingImageGenerator(grid, ids, walls, mapping, cv_px=2)
    jax_ = jrender.BuildingImageGenerator(grid, ids, walls, mapping, cv_px=2)
    jresponse = jbuilding.ObservationResponse.FromString(response.SerializeToString())
    return port, jax_, response, jresponse


def test_building_image_png_decodes_to_the_frame():
    port, jax_, response, jresponse = _image_generators()
    array = port.temperature_array(response)
    np.testing.assert_array_equal(array, jax_.temperature_array(jresponse))
    png = base64.b64decode(port.generate_building_image(response))
    np.testing.assert_array_equal(decode_png(png), port._renderer.render_array(array))
    pytest.importorskip("PIL")
    import io

    from PIL import Image

    jpng = base64.b64decode(jax_.generate_building_image(jresponse))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png)).convert("RGB")),
                                  np.asarray(Image.open(io.BytesIO(jpng)).convert("RGB")))


def test_without_pillow_only_the_pil_paths_raise(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    port, _, response, _ = _image_generators()
    renderer = trender.BuildingRenderer(np.zeros((3, 3), bool))
    with pytest.raises(RuntimeError, match="Pillow is not available"):
        renderer.render(np.full((3, 3), 290.0))
    logger = trender.VisualLogger(renderer)
    logger.log(np.full((3, 3), 290.0))
    with pytest.raises(RuntimeError, match="Pillow is not available"):
        logger.get_video(str(tmp_path / "x.gif"))
    assert decode_png(base64.b64decode(port.generate_building_image(response))).shape == (6, 8, 3)


def test_encode_png_refuses_other_shapes():
    with pytest.raises(ValueError, match="H, W, 3"):
        trender.encode_png(np.zeros((4, 4), np.uint8))


# ---- plots -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sb1_windows():
    tcfg, jcfg = (tpresets.sb1_config(num_days_in_episode=1),
                  jpresets.sb1_config(num_days_in_episode=1))
    got = tplots.schedule_plot_data(ttables.build_episode_tables(tcfg), tcfg.start_timestamp,
                                    tcfg.time_step_sec)
    want = jplots.schedule_plot_data(jtables.build_episode_tables(jcfg), jcfg.start_timestamp,
                                     jcfg.time_step_sec)
    return tcfg, got, want


def test_schedule_plot_data_is_jax(sb1_windows):
    _, got, want = sb1_windows
    assert got.columns == list(want.columns) == [
        "comfort_mode", "start_time", "end_time", "heating_setpoint", "cooling_setpoint"]
    assert len(got) == len(want) > 1
    for col in ("start_time", "end_time"):
        assert got[col] == list(want[col])
    for col in ("comfort_mode", "heating_setpoint", "cooling_setpoint"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(float))


def _dashboards(tcfg, windows, jwindows, tmp_path):
    kw = dict(zone_names=["a", "b"], step_sec=tcfg.time_step_sec)
    port = tplots.EpisodeDashboard(start_timestamp=tcfg.start_timestamp,
                                   schedule_windows=windows, writedir=str(tmp_path / "port"), **kw)
    jax_ = jplots.EpisodeDashboard(start_timestamp=tcfg.start_timestamp,
                                   schedule_windows=jwindows, writedir=str(tmp_path / "jax"), **kw)
    for dash in (port, jax_):
        for t in range(6):
            dash.update(t, ambient_temp=283.0 + t, zone_temps=[294.0 + 0.1 * t, 295.0],
                        boiler_thermal=5000.0, boiler_electrical=100.0 * t, ahu_fan=700.0,
                        ahu_thermal=-2000.0)
    return port, jax_


def test_dashboard_update_accumulates_as_jax(sb1_windows, tmp_path):
    tcfg, windows, jwindows = sb1_windows
    port, jax_ = _dashboards(tcfg, windows, jwindows, tmp_path)
    assert [pd.Timestamp(t) for t in port.timestamps] == jax_.timestamps
    assert port.ambient_temps == jax_.ambient_temps
    np.testing.assert_array_equal(np.stack(port.zone_temps), np.stack(jax_.zone_temps))
    assert port.energy_rates == jax_.energy_rates


def test_dashboard_render_writes_the_names_jax_writes(sb1_windows, tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    tcfg, windows, jwindows = sb1_windows
    port, jax_ = _dashboards(tcfg, windows, jwindows, tmp_path)
    for dash in (port, jax_):
        plt.close(dash.render(np.full((5, 6), 292.0), wall_mask=np.eye(5, 6)))
    names = [sorted(os.listdir(tmp_path / side)) for side in ("port", "jax")]
    assert names[0] == names[1] == ["thermal_step_2023-07-06_07-25-00.png"]
    assert plt.get_fignums() == []


def test_plot_functions_draw(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    axes = [
        tplots.plot_building_heatmap(np.full((5, 6), 290.0), wall_mask=np.eye(5, 6)),
        tplots.plot_zone_timeline(np.random.default_rng(0).normal(294, 1, (50, 2)),
                                  heating_setpoints=np.full(50, 294.0),
                                  cooling_setpoints=np.full(50, 297.0)),
        tplots.plot_reward_components({"cost": np.arange(10.0), "comfort": -np.arange(10.0)}),
    ]
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps({"step": i, "reward_mean": -1.0 / (i + 1)}) + "\n"
                            for i in range(5)))
    axes.append(tplots.plot_learning_curve(str(path)))
    assert all(ax is not None for ax in axes)
    np.testing.assert_array_equal(axes[-1].lines[0].get_ydata(), [-1.0 / (i + 1) for i in range(5)])
    plt.close("all")


# ---- profiling ---------------------------------------------------------------------------


def test_phase_timer_is_jax(monkeypatch):
    """On one stepping clock both timers count, total and report alike; a
    CPU tensor in block_on synchronizes no device."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronized"))
    timers = tprofiling.PhaseTimer(), jprofiling.PhaseTimer()
    for timer in timers:
        for name, n in (("solve", 3), ("frame", 1), ("fit", 2)):
            for _ in range(n):
                with timer.phase(name, block_on={"x": [torch.ones(2)], "y": None}):
                    time.perf_counter()
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].summary()["solve"]["calls"] == 3
    assert timers[0].report() == timers[1].report()
    assert [line.split()[0] for line in timers[0].report().splitlines()] == ["solve", "fit",
                                                                            "frame"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprofiling.device_trace(str(tmp_path)):
        with tprofiling.annotate("offline_probe"):
            torch.ones(64).cumsum(0)
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    events = json.load(open(trace))["traceEvents"]
    assert any(e.get("name") == "offline_probe" for e in events)


# ---- the dashboard -----------------------------------------------------------------------


def _jax_dashboard(monkeypatch, tmp_path, steps):
    """The JAX script's loop (examples/episode_dashboard.py, drawing at its
    last step), with its EpisodeDashboard kept."""
    made = []

    class Kept(jplots.EpisodeDashboard):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jplots, "EpisodeDashboard", Kept)
    monkeypatch.setattr(sys, "argv", ["episode_dashboard.py", "--steps", str(steps),
                                      "--render-every", str(steps), "--out", str(tmp_path)])
    spec = importlib.util.spec_from_file_location(
        "jax_episode_dashboard", os.path.join(REPO, "examples", "episode_dashboard.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main()
    (dash,) = made
    return dash


def test_dashboard_main_on_the_cpu_is_the_jax_script(monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    fields = []
    run = episode_dashboard.main(
        ["--cpu", "--steps", str(DASHBOARD_STEPS), "--render-every", str(DASHBOARD_STEPS),
         "--out", str(tmp_path / "port")],
        on_step=lambda t, state: fields.append(state.temp[0].numpy().copy()))
    want = _jax_dashboard(monkeypatch, tmp_path / "jax", DASHBOARD_STEPS)
    got = run.dashboard
    assert run.steps == DASHBOARD_STEPS == len(got.timestamps) == len(fields)
    assert [pd.Timestamp(t) for t in got.timestamps] == want.timestamps
    assert got.ambient_temps == want.ambient_temps
    zone_temps, jzone_temps = np.stack(got.zone_temps), np.stack(want.zone_temps)
    for t in range(DASHBOARD_STEPS):
        np.testing.assert_allclose(zone_temps[t], jzone_temps[t], rtol=0,
                                   atol=(t + 1) * FIELD_ATOL)
    # The rates read the field only through the zone means and the grid
    # mean, each within FIELD_ATOL per solve of JAX's.
    for name, series in got.energy_rates.items():
        np.testing.assert_allclose(series, want.energy_rates[name], rtol=1e-5, atol=1e-3,
                                   err_msg=name)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert run.windows.columns[0] == "comfort_mode"


def test_dashboard_drawing_needs_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--render-every 0"):
        episode_dashboard.main(["--cpu", "--steps", "1", "--out", str(tmp_path)])
    run = episode_dashboard.main(["--cpu", "--steps", "2", "--render-every", "0",
                                  "--out", str(tmp_path)])
    assert len(run.dashboard.timestamps) == 2 and os.listdir(tmp_path) == []

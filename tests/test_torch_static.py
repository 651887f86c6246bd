"""The port's static build equals the JAX package's, exactly.

Both sb1 configurations of the main path: the 12-zone plan and the 126-room
plan with layout="auto" (transposed to 189 x 124). Geometry, stencil
coefficients, spectral radius, convection buckets, zone-stat layout,
episode tables and observation layout must be identical; the port's
daylight-saving rule must agree with zoneinfo.
"""

import dataclasses
import datetime
import zoneinfo

import numpy as np
import pytest

from sbsim_tpu.core import geometry as jgeo
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.physics import convection as jconv
from sbsim_tpu.physics import fdm as jfdm
from sbsim_tpu.physics import gridstats as jgs
from sbsim_tpu.scenario import tables as jtables
from sbsim_tpu_torch.core import geometry as tgeo
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.physics import convection as tconv
from sbsim_tpu_torch.physics import fdm as tfdm
from sbsim_tpu_torch.physics import gridstats as tgs
from sbsim_tpu_torch.scenario import tables as ttables


def _configs(which):
    if which == "12zone":
        return (jpresets.sb1_config(num_days_in_episode=2),
                tpresets.sb1_config(num_days_in_episode=2))
    jplan = jgeo.make_synthetic_office_plan(9, 14, room_cvs=12)
    tplan = tgeo.make_synthetic_office_plan(9, 14, room_cvs=12)
    np.testing.assert_array_equal(tplan, jplan)
    return (jpresets.sb1_config(num_days_in_episode=2, floor_plan=jplan, layout="auto"),
            tpresets.sb1_config(num_days_in_episode=2, floor_plan=tplan, layout="auto"))


@pytest.fixture(scope="module", params=["12zone", "126room"])
def built(request):
    jcfg, tcfg = _configs(request.param)
    jg, tg = jbe.build_geometry(jcfg), tbe.build_geometry(tcfg)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jg=jg, tg=tg)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _plain(x):
    """Config values with each package's dataclasses as plain dicts."""
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


def test_config_fields(built):
    jcfg, tcfg = built["jcfg"], built["tcfg"]
    for f in dataclasses.fields(tcfg):
        if f.name in ("building", "weather"):
            continue  # arrays and file paths; the built geometry is compared
        assert _plain(getattr(tcfg, f.name)) == _plain(getattr(jcfg, f.name)), f.name
    assert tcfg.convection.rng == "mix32"
    assert tcfg.pallas_block_mode == "interleave"
    assert tcfg.pallas_block_envs == (8 if built["name"] == "12zone" else 4)


def test_geometry(built):
    jg, tg = built["jg"], built["tg"]
    expected = (52, 67) if built["name"] == "12zone" else (189, 124)
    assert tg.shape == jg.shape == expected
    assert tg.n_zones == jg.n_zones == (12 if built["name"] == "12zone" else 126)
    for f in dataclasses.fields(tg):
        _same(getattr(jg, f.name), getattr(tg, f.name), f.name)


def test_layout_rule():
    for shape in [(52, 67), (124, 189), (189, 124), (8, 128), (9, 129)]:
        assert tgeo.padded_grid_cost(shape) == jgeo.padded_grid_cost(shape)


def test_stencil_and_spectral_radius(built):
    jc = jfdm.stencil_coefficients(built["jg"], 300.0)
    tc = tfdm.stencil_coefficients(built["tg"], 300.0, device="cpu")
    for f in dataclasses.fields(tc):
        _same(getattr(jc, f.name), getattr(tc, f.name), f.name)
    assert tc.ring_exterior
    h = built["jcfg"].weather.convection_coefficient
    assert tfdm.estimate_spectral_radius(tc, h) == jfdm.estimate_spectral_radius(jc, h)


def test_convection_buckets(built):
    c = built["jcfg"].convection
    kw = dict(method=c.method, rounds=c.rounds, variants=c.variants, seed=c.seed,
              rng=c.rng, schedule=c.schedule)
    jb = jconv.make_convection_buckets(built["jg"], c.p, c.distance, **kw)
    tb = tconv.make_convection_buckets(built["tg"], c.p, c.distance, **kw)
    assert tb.offsets == jb.offsets
    assert (tb.enabled, tb.method, tb.p_round, tb.rng) == (
        jb.enabled, jb.method, jb.p_round, jb.rng)
    for name in ("lead_masks", "lead_words", "foll_words", "flat_indices",
                 "segment_keys"):
        _same(getattr(jb, name), getattr(tb, name), name)
    assert tb.flat_indices.dtype == np.int32 and tb.segment_keys.dtype == np.float32
    params = tconv.decision_word_params(tb)
    assert params == jconv.decision_word_params(jb)
    assert params[2] == 8  # 8-bit decision lanes at the sb1 calibration


def test_zone_stat_layout(built):
    jl = jgs.make_zone_stat_layout(built["jg"])
    tl = tgs.make_zone_stat_layout(built["tg"])
    for f in dataclasses.fields(tl):
        _same(getattr(jl, f.name), getattr(tl, f.name), f.name)


def test_episode_tables(built):
    jt = jtables.build_episode_tables(built["jcfg"])
    tt = ttables.build_episode_tables(built["tcfg"])
    for f in dataclasses.fields(tt):
        a, b = np.asarray(getattr(jt, f.name)), np.asarray(getattr(tt, f.name))
        assert a.dtype == b.dtype or a.ndim == 0, f.name
        _same(a, b, f.name)


def test_observation_layout(built):
    jenv_layout = jbe.obs_lib.build_obs_layout(
        built["jg"].zone_names, built["jcfg"].observation_normalization,
        built["jcfg"].histogram_parameters)
    tenv_layout = tbe.obs_lib.build_obs_layout(
        built["tg"].zone_names, built["tcfg"].observation_normalization,
        built["tcfg"].histogram_parameters)
    assert tenv_layout.field_names == jenv_layout.field_names
    assert tenv_layout.n_fields == 53
    for name in ("scalar_means", "scalar_stds", "scalar_zero", "vav_means",
                 "vav_stds", "vav_zero", "vav_device_order", "hist_bins",
                 "hist_n_bins"):
        _same(getattr(jenv_layout, name), getattr(tenv_layout, name), name)


@pytest.mark.parametrize("zone", ["US/Pacific", "UTC"])
def test_time_zone_rule_matches_zoneinfo_over_2023(zone):
    tz = zoneinfo.ZoneInfo(zone)
    start = datetime.datetime(2023, 1, 1, tzinfo=datetime.timezone.utc)
    step = datetime.timedelta(minutes=5)
    for i in range(365 * 24 * 12):
        ts = start + i * step
        want = ts.astimezone(tz).replace(tzinfo=None)
        assert ttables.to_local(ts, zone) == want, ts


@pytest.mark.parametrize("zone,year", [("Australia/Sydney", 2023), ("US/Pacific", 1986),
                                       ("Europe/Berlin", 1995)])
def test_unsupported_time_zone_raises(zone, year):
    """A zone outside the port's table, or a year before its rule."""
    ts = datetime.datetime(year, 7, 6, 7, tzinfo=datetime.timezone.utc)
    with pytest.raises(ValueError, match="Europe/Berlin" if year == 2023 else str(year)):
        ttables.to_local(ts, zone)

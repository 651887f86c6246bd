"""The port's CUDA kernels on the card (marked `cuda`; skipped without one).

Run on a machine with an NVIDIA Hopper GPU and nvcc, without the JAX test
configuration:

    python -m pytest --noconftest -m "cuda and not slow" tests/test_torch_cuda.py -q

(`-m "cuda and slow"` runs the two-zone SAC learning recipe, ~10 min.)

Each kernel must equal its plain PyTorch version bitwise (fields,
iteration counts, converged flags, and the zone/grid sums of the
statistics epilogue; NaN equal to NaN where an env's field holds one),
count its launches, and refuse inputs it does not take; the block kernels
K3/K4 must also equal K2/K1 env for env (K3 unless a residual is NaN). This file
imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sbsim_tpu_torch import rng
from sbsim_tpu_torch.envs import building_env, presets
from sbsim_tpu_torch.physics import convection, fdm_cuda, gridstats

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels are sm_90a CUDA)")
    return building_env.BuildingEnv(presets.sb1_config(num_days_in_episode=1))


def _inputs(env, batch, seed):
    rs = np.random.default_rng(seed)
    shape = (batch,) + env.geom.shape
    t = lambda a: torch.as_tensor(a, device=env.device)
    inp = fdm_cuda.kernel_inputs(
        t((294.0 + rs.normal(0, 2.0, shape)).astype(np.float32)),
        t(rs.uniform(0.0, 50.0, shape).astype(np.float32)),
        t(rs.uniform(270.0, 300.0, batch).astype(np.float32)),
        t(np.full(batch, 100.0, np.float32)),
        env.coeffs,
    )
    conv = fdm_cuda.ConvInputs(
        offsets=env.convection.offsets, lead=env._conv_lead, foll=env._conv_foll,
        word_params=env._conv_word_params,
        keys=t(rs.integers(0, 2**32, (batch, 2), dtype=np.uint64).astype(np.int64)),
    )
    return inp, conv


@pytest.mark.parametrize("limit", [100, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_cheby_kernel_equals_plain(env, fused, limit):
    inp, conv = _inputs(env, 16, seed=limit)
    kw = dict(threshold=0.1, iteration_limit=limit, spectral_radius=env._spectral_radius,
              check_every=4, conv=conv if fused else None)
    before = fdm_cuda.launch_counts["fdm_cheby"]
    got = fdm_cuda.fdm_cheby_cuda(inp, **kw)
    assert fdm_cuda.launch_counts["fdm_cheby"] == before + 1
    want = fdm_cuda.fdm_cheby_plain(inp, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2].all()) == (limit == 100)


def test_jacobi_kernel_launches_on_its_inputs_device(env):
    """K2 on tensors given as cuda:0, called from under another current
    device where the machine has one (the last card; cuda:0 itself on a
    one-card machine): the launch runs on cuda:0, equals its plain version,
    and leaves the current device as it was."""
    inp, conv = _inputs(env, 8, seed=11)
    assert inp.temp.device == torch.device("cuda", 0)
    other = torch.cuda.device_count() - 1
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv)
    with torch.cuda.device(other):
        got = fdm_cuda.fdm_jacobi_cuda(inp, **kw)
        assert torch.cuda.current_device() == other
    want = fdm_cuda.fdm_jacobi_plain(inp, **kw)
    torch.cuda.synchronize(0)
    assert got[0].device == inp.temp.device
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("limit", [100, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_jacobi_kernel_equals_plain(env, fused, limit):
    inp, conv = _inputs(env, 16, seed=limit + 1)
    kw = dict(threshold=0.1, iteration_limit=limit, conv=conv if fused else None)
    got = fdm_cuda.fdm_jacobi_cuda(inp, **kw)
    want = fdm_cuda.fdm_jacobi_plain(inp, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kernel", ["fdm_jacobi", "fdm_cheby"])
def test_stats_epilogue_equals_plain(env, kernel, fused):
    inp, conv = _inputs(env, 16, seed=7 + fused)
    stats = env._stats
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv if fused else None, stats=stats)
    if kernel == "fdm_cheby":
        kw.update(spectral_radius=env._spectral_radius, check_every=4)
        got, want = fdm_cuda.fdm_cheby_cuda(inp, **kw), fdm_cuda.fdm_cheby_plain(inp, **kw)
    else:
        got, want = fdm_cuda.fdm_jacobi_cuda(inp, **kw), fdm_cuda.fdm_jacobi_plain(inp, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3].zone_sums.shape == (16, env.n_zones)
    assert torch.equal(got[3].zone_sums, want[3].zone_sums)
    assert torch.equal(got[3].grid_sums, want[3].grid_sums)
    assert torch.equal(got[3].zone_sums, stats.zone_sums(got[0]))


@pytest.mark.parametrize("kernel", ["fdm_jacobi", "fdm_cheby"])
def test_stats_epilogue_in_several_passes(env, kernel):
    """Windows too large for one pass of the scratch plane (12 zones of
    30 x 40 on the 52 x 67 grid) fold in several passes, still bitwise."""
    rs = np.random.default_rng(3)
    h, w = env.geom.shape
    masks = (rs.uniform(size=(12, 30, 40)) < 0.7).astype(np.float32)
    layout = gridstats.ZoneStatLayout(
        masks=masks, sizes=masks.sum(axis=(1, 2)),
        row0=tuple(int(v) for v in rs.integers(0, h - 30 + 1, 12)),
        col0=tuple(int(v) for v in rs.integers(0, w - 40 + 1, 12)),
        window=(30, 40), grid_n=float(h * w))
    stats = gridstats.ZoneStats(layout, env.device)
    inp, conv = _inputs(env, 8, seed=5)
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv, stats=stats)
    if kernel == "fdm_cheby":
        kw.update(spectral_radius=env._spectral_radius, check_every=4)
        got, want = fdm_cuda.fdm_cheby_cuda(inp, **kw), fdm_cuda.fdm_cheby_plain(inp, **kw)
    else:
        got, want = fdm_cuda.fdm_jacobi_cuda(inp, **kw), fdm_cuda.fdm_jacobi_plain(inp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[3].zone_sums, want[3].zone_sums)
    assert torch.equal(got[3].grid_sums, want[3].grid_sums)


def test_kernel_refuses_wrong_inputs(env):
    inp, _ = _inputs(env, 2, seed=0)
    bad = fdm_cuda.KernelInputs(**{**inp.__dict__, "temp": inp.temp.double()})
    with pytest.raises(ValueError):
        fdm_cuda.fdm_jacobi_cuda(bad, threshold=0.1, iteration_limit=5)
    cpu = fdm_cuda.KernelInputs(**{**inp.__dict__, "temp": inp.temp.cpu()})
    with pytest.raises(ValueError):
        fdm_cuda.fdm_cheby_cuda(cpu, threshold=0.1, iteration_limit=5,
                                spectral_radius=0.9)


def test_env_steps_through_the_kernels(env):
    state, _ = env.reset(rng.split(rng.PRNGKey(1, device=env.device), 8))
    fdm_cuda.reset_launch_counts()
    actions = torch.zeros((8, env.n_actions), device=env.device)
    for solver in ("pallas_cheby", "pallas_env"):
        state, out = env.step_batched(state, actions, solver=solver)
    assert fdm_cuda.launch_counts == {"fdm_cheby": 1, "fdm_jacobi": 1,
                                      "fdm_cheby_block": 0, "fdm_jacobi_block": 0}
    assert env.resolve_solver(8) == "pallas_env"
    assert torch.isfinite(state.temp).all()
    # pallas_env took its statistics from the kernel: they are the fold's.
    assert torch.equal(state.zone_means, env._stats.zone_means(state.temp))
    assert torch.equal(state.grid_mean, env._stats.grid_mean(state.temp))
    assert ((out.reward >= -1) & (out.reward <= 0)).all()


def _word_plane(env, conv):
    """The threefry word plane of the same keys, as the kernels read it."""
    c = dataclasses.replace(env.convection, rng="threefry")
    words = convection.swap_decision_word(c, conv.keys, env.geom.shape)
    return dataclasses.replace(conv, words=fdm_cuda.packed_plane(words, env.device),
                               keys=None, word_params=None)


def _equal(got, want):
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    if len(want) > 3:
        assert torch.equal(got[3].zone_sums, want[3].zone_sums)
        assert torch.equal(got[3].grid_sums, want[3].grid_sums)


@pytest.mark.parametrize("conv_kind", ["none", "mix32", "words"])
@pytest.mark.parametrize("kernel", ["fdm_jacobi", "fdm_cheby"])
def test_word_plane_and_block_kernels_equal_plain_and_solo(env, kernel, conv_kind):
    """K3/K4 at E = 2 and 8 (K4 clamped to 1) on a batch of 13 (a partial
    last block) equal
    their plain versions and K2/K1 bitwise, with statistics; every kernel
    reads a word plane as its plain version does."""
    inp, conv = _inputs(env, 13, seed=11)
    conv = {"none": None, "mix32": conv, "words": _word_plane(env, conv)}[conv_kind]
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv, stats=env._stats)
    if kernel == "fdm_cheby":
        kw.update(spectral_radius=env._spectral_radius, check_every=4)
        solo, solo_plain = fdm_cuda.fdm_cheby_cuda, fdm_cuda.fdm_cheby_plain
        block, block_plain = fdm_cuda.fdm_cheby_block_cuda, fdm_cuda.fdm_cheby_block_plain
    else:
        solo, solo_plain = fdm_cuda.fdm_jacobi_cuda, fdm_cuda.fdm_jacobi_plain
        block, block_plain = fdm_cuda.fdm_jacobi_block_cuda, fdm_cuda.fdm_jacobi_block_plain
    want = solo(inp, **kw)
    _equal(want, solo_plain(inp, **kw))
    for e in (2, fdm_cuda.effective_block_envs(env.geom.shape, 8,
                                               cheby=kernel == "fdm_cheby")):
        before = fdm_cuda.launch_counts[f"{kernel}_block"]
        got = block(inp, block_envs=e, **kw)
        assert fdm_cuda.launch_counts[f"{kernel}_block"] == before + 1
        _equal(got, block_plain(inp, block_envs=e, **kw))
        _equal(got, want)
    torch.cuda.synchronize()


def test_block_kernels_refuse_more_envs_than_fit(env):
    inp, _ = _inputs(env, 4, seed=1)
    assert fdm_cuda.effective_block_envs(env.geom.shape, 16) == fdm_cuda.JACOBI_BEST_ENVS
    too_many = fdm_cuda.jacobi_max_envs(env.geom.shape) + 1
    with pytest.raises(ValueError):
        fdm_cuda.fdm_jacobi_block_cuda(inp, threshold=0.1, iteration_limit=5,
                                       block_envs=too_many)


def test_stack_env_steps_through_the_block_kernels(env):
    stack = building_env.BuildingEnv(dataclasses.replace(
        env.config, pallas_block_mode="stack"))
    state, _ = stack.reset(rng.split(rng.PRNGKey(1, device=stack.device), 11))
    fdm_cuda.reset_launch_counts()
    actions = torch.zeros((11, stack.n_actions), device=stack.device)
    for solver in ("pallas_cheby", "pallas_env"):
        state, out = stack.step_batched(state, actions, solver=solver)
        # Statistics come from the block kernels' epilogue: the fold's.
        assert torch.equal(state.zone_means, stack._stats.zone_means(state.temp))
    assert fdm_cuda.launch_counts == {"fdm_cheby": 0, "fdm_jacobi": 0,
                                      "fdm_cheby_block": 1, "fdm_jacobi_block": 1}
    assert torch.isfinite(state.temp).all()


def _counted(name, fn, *args, **kw):
    """fn's result, checking that it launched kernel `name` once."""
    before = fdm_cuda.launch_counts[name]
    out = fn(*args, **kw)
    assert fdm_cuda.launch_counts[name] == before + 1
    return out


@pytest.fixture(scope="module")
def big_env(env):
    from sbsim_tpu_torch.core import geometry
    plan = geometry.make_synthetic_office_plan(9, 14, room_cvs=12)
    return building_env.BuildingEnv(presets.sb1_config(
        num_days_in_episode=1, floor_plan=plan, layout="auto"))


def test_cheby_body_at_126_rooms(big_env):
    """K1 and K4 (E = 1) on the 189 x 124 grid, where const/denom stay in
    global memory: bitwise against the plain versions and each other."""
    assert big_env.geom.shape == (189, 124)
    assert fdm_cuda.effective_block_envs(big_env.geom.shape, 4, cheby=True) == 1
    inp, conv = _inputs(big_env, 4, seed=21)
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv,
              spectral_radius=big_env._spectral_radius, check_every=4)
    solo = _counted("fdm_cheby", fdm_cuda.fdm_cheby_cuda, inp, **kw)
    _equal(solo, fdm_cuda.fdm_cheby_plain(inp, **kw))
    got = _counted("fdm_cheby_block", fdm_cuda.fdm_cheby_block_cuda, inp, block_envs=1, **kw)
    _equal(got, fdm_cuda.fdm_cheby_block_plain(inp, block_envs=1, **kw))
    _equal(got, solo)
    torch.cuda.synchronize()


@pytest.mark.parametrize("e", [1, 2, 3, 4])
def test_cheby_block_at_each_e(env, e):
    """K4 at every E its launcher takes at 12 zones (B = 9: a partial last
    block), with statistics and mix32 swaps, equals its plain version and
    K1 env for env."""
    assert e <= fdm_cuda.cheby_max_envs(env.geom.shape)
    inp, conv = _inputs(env, 9, seed=30 + e)
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv, stats=env._stats,
              spectral_radius=env._spectral_radius, check_every=4)
    got = _counted("fdm_cheby_block", fdm_cuda.fdm_cheby_block_cuda, inp, block_envs=e, **kw)
    _equal(got, fdm_cuda.fdm_cheby_block_plain(inp, block_envs=e, **kw))
    _equal(got, fdm_cuda.fdm_cheby_cuda(inp, **kw))
    torch.cuda.synchronize()


def test_cheby_body_on_a_ragged_grid(env):
    """The 9 x 11 grid of two_zone_test_config: columns end in a run of one
    cell and a plane (396 B) is not a multiple of 16 bytes, so threads copy
    what the bulk engine cannot."""
    small = building_env.BuildingEnv(presets.two_zone_test_config())
    rs = np.random.default_rng(13)
    batch, shape = 13, small.geom.shape
    t = lambda a: torch.as_tensor(a, device=small.device)
    inp = fdm_cuda.kernel_inputs(
        t((294.0 + rs.normal(0, 2.0, (batch,) + shape)).astype(np.float32)),
        t(rs.uniform(0.0, 50.0, (batch,) + shape).astype(np.float32)),
        t(rs.uniform(270.0, 300.0, batch).astype(np.float32)),
        t(np.full(batch, 100.0, np.float32)), small.coeffs)
    buckets = dataclasses.replace(small.convection, enabled=True, rng="mix32")
    conv = fdm_cuda.ConvInputs(
        offsets=buckets.offsets, lead=fdm_cuda.packed_plane(buckets.lead_words, small.device),
        foll=fdm_cuda.packed_plane(buckets.foll_words, small.device),
        word_params=convection.decision_word_params(buckets),
        keys=t(rs.integers(0, 2**32, (batch, 2), dtype=np.uint64).astype(np.int64)))
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv,
              spectral_radius=small._spectral_radius, check_every=4)
    solo = _counted("fdm_cheby", fdm_cuda.fdm_cheby_cuda, inp, **kw)
    _equal(solo, fdm_cuda.fdm_cheby_plain(inp, **kw))
    e = fdm_cuda.cheby_max_envs(shape)
    got = _counted("fdm_cheby_block", fdm_cuda.fdm_cheby_block_cuda, inp, block_envs=e, **kw)
    _equal(got, fdm_cuda.fdm_cheby_block_plain(inp, block_envs=e, **kw))
    _equal(got, solo)
    torch.cuda.synchronize()


@pytest.mark.parametrize("e", [1, 2, 3, 4])
def test_jacobi_block_at_each_e(env, e):
    """K3 at every E its launcher takes at 12 zones (B = 9: a partial last
    block), with statistics and mix32 swaps, equals its plain version and
    K2 env for env."""
    assert e <= fdm_cuda.jacobi_max_envs(env.geom.shape)
    inp, conv = _inputs(env, 9, seed=40 + e)
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv, stats=env._stats)
    got = _counted("fdm_jacobi_block", fdm_cuda.fdm_jacobi_block_cuda, inp, block_envs=e, **kw)
    _equal(got, fdm_cuda.fdm_jacobi_block_plain(inp, block_envs=e, **kw))
    _equal(got, _counted("fdm_jacobi", fdm_cuda.fdm_jacobi_cuda, inp, **kw))
    torch.cuda.synchronize()


def test_jacobi_body_at_126_rooms(big_env):
    """K2 and K3 (E = 1) on the 189 x 124 grid, where const/denom stay in
    global memory and the decision bytes take their own plane: bitwise
    against the plain versions and each other."""
    assert not fdm_cuda.jacobi_geometry(big_env.geom.shape, 1).staged
    assert fdm_cuda.effective_block_envs(big_env.geom.shape, 4) == 1
    inp, conv = _inputs(big_env, 4, seed=22)
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv)
    solo = _counted("fdm_jacobi", fdm_cuda.fdm_jacobi_cuda, inp, **kw)
    _equal(solo, fdm_cuda.fdm_jacobi_plain(inp, **kw))
    got = _counted("fdm_jacobi_block", fdm_cuda.fdm_jacobi_block_cuda, inp, block_envs=1, **kw)
    _equal(got, fdm_cuda.fdm_jacobi_block_plain(inp, block_envs=1, **kw))
    _equal(got, solo)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kernel,e", [("fdm_jacobi", None), ("fdm_jacobi_block", 1),
                                      ("fdm_jacobi_block", 2)])
def test_nan_env_follows_each_stopping_rule(env, kernel, e):
    """One env's temp holds a NaN: K2 stops it at iteration 1, K3 runs it to
    the limit, each as its plain version does (NaN equal to NaN)."""
    inp, conv = _inputs(env, 5, seed=50)
    temp = inp.temp.clone()
    temp[1, 20, 30] = float("nan")
    inp = dataclasses.replace(inp, temp=temp)
    kw = dict(threshold=0.1, iteration_limit=20, conv=conv, stats=env._stats)
    if e is not None:
        kw.update(block_envs=e)
    got = getattr(fdm_cuda, f"{kernel}_cuda")(inp, **kw)
    want = getattr(fdm_cuda, f"{kernel}_plain")(inp, **kw)
    torch.cuda.synchronize()
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(got[:3], want[:3]):
        same(a, b)
    same(got[3].zone_sums, want[3].zone_sums)
    same(got[3].grid_sums, want[3].grid_sums)
    assert int(got[1][1]) == (1 if kernel == "fdm_jacobi" else 20)
    assert not bool(got[2][1])


def _steps_through(env, solver, batch, plain, seed):
    """3 step_batched steps from a fresh reset (with solver None, 3 steps of
    the per-env `step` at batch 1), through the kernels or, with `plain`,
    through their plain versions on the card; the launch counts, final
    state and outputs."""
    from sbsim_tpu_torch import convert

    names = ("fdm_cheby", "fdm_jacobi", "fdm_cheby_block", "fdm_jacobi_block")
    saved = {k: getattr(fdm_cuda, f"{k}_cuda") for k in names}
    if plain:
        for k in names:
            setattr(fdm_cuda, f"{k}_cuda", getattr(fdm_cuda, f"{k}_plain"))
    try:
        state, _ = env.reset(rng.split(rng.PRNGKey(seed, device=env.device), batch))
        acts = torch.as_tensor(np.random.default_rng(seed).uniform(
            -1, 1, (3, batch, env.n_actions)), dtype=torch.float32, device=env.device)
        fdm_cuda.reset_launch_counts()
        outs = []
        for a in acts:
            if solver is None:
                state, out = env.step(state, a)
            else:
                state, out = env.step_batched(state, a, solver=solver)
            outs.append(torch.cat([out.observation, out.reward[:, None]], 1))
        counts = dict(fdm_cuda.launch_counts)
    finally:
        for k, fn in saved.items():
            setattr(fdm_cuda, f"{k}_cuda", fn)
    tree = convert.env_state_to_numpy(state)
    flat = {k: v for k, v in tree.items() if k != "hvac"}
    flat.update({f"hvac.{k}": v for k, v in tree["hvac"].items()})
    return counts, flat, torch.stack(outs).cpu().numpy()


@pytest.mark.parametrize("solver,kernel", [("pallas_env", "fdm_jacobi"),
                                           ("pallas_cheby", "fdm_cheby")])
def test_windowed_env_through_the_kernels_equals_plain(env, solver, kernel):
    """episode_windows=4: each env reads its own window's tables; the
    kernels' steps equal the plain versions' bitwise."""
    windowed = building_env.BuildingEnv(dataclasses.replace(env.config, episode_windows=4))
    counts, got, got_out = _steps_through(windowed, solver, 16, plain=False, seed=6)
    assert counts[kernel] == 3 and sum(counts.values()) == 3
    _, want, want_out = _steps_through(windowed, solver, 16, plain=True, seed=6)
    assert len(np.unique(got["window"])) > 1
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    np.testing.assert_array_equal(got_out, want_out)


def test_suite_plan_through_k2_equals_plain(env):
    """The suite's (2, 6, 16) office plan (41 x 109) through K2, bitwise
    its plain version."""
    from sbsim_tpu_torch.envs import suite

    plan_env = suite.BuildingSuite(presets.building_suite(num_days_in_episode=1)).envs[2]
    assert plan_env.geom.shape == (41, 109)
    counts, got, got_out = _steps_through(plan_env, "pallas_env", 16, plain=False, seed=7)
    assert counts["fdm_jacobi"] == 3 and sum(counts.values()) == 3
    _, want, want_out = _steps_through(plan_env, "pallas_env", 16, plain=True, seed=7)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    np.testing.assert_array_equal(got_out, want_out)


@pytest.mark.parametrize("fdm_solver,kernel", [("jacobi", "fdm_jacobi"),
                                               ("chebyshev", "fdm_cheby")])
def test_per_env_step_through_the_kernel_equals_plain(env, fdm_solver, kernel):
    """BuildingEnv.step at B=1 takes the config's solver: K2 for "jacobi",
    K1 for "chebyshev", each launch bitwise its plain version."""
    one = building_env.BuildingEnv(dataclasses.replace(env.config, fdm_solver=fdm_solver))
    counts, got, got_out = _steps_through(one, None, 1, plain=False, seed=9)
    assert counts[kernel] == 3 and sum(counts.values()) == 3
    _, want, want_out = _steps_through(one, None, 1, plain=True, seed=9)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    np.testing.assert_array_equal(got_out, want_out)


def _dashboard_run(plain, steps, tmp_path):
    """episode_dashboard.main on the card for `steps` steps (drawing off),
    through K2 or, with `plain`, its plain version; the launch counts, the
    dashboard's accumulators and each step's field."""
    from sbsim_tpu_torch.examples import episode_dashboard

    saved = fdm_cuda.fdm_jacobi_cuda
    if plain:
        fdm_cuda.fdm_jacobi_cuda = fdm_cuda.fdm_jacobi_plain
    fields = []
    try:
        fdm_cuda.reset_launch_counts()
        run = episode_dashboard.main(
            ["--steps", str(steps), "--render-every", "0", "--out", str(tmp_path)],
            on_step=lambda t, state: fields.append(state.temp[0].cpu().numpy()))
        counts = dict(fdm_cuda.launch_counts)
    finally:
        fdm_cuda.fdm_jacobi_cuda = saved
    return counts, run.dashboard, np.stack(fields)


def test_dashboard_through_k2_equals_plain(env, tmp_path):
    """8 steps of the dashboard example launch K2 once per step and
    accumulate bitwise what the plain version's run does."""
    counts, dash, fields = _dashboard_run(False, 8, tmp_path)
    assert counts == {"fdm_cheby": 0, "fdm_jacobi": 8, "fdm_cheby_block": 0,
                      "fdm_jacobi_block": 0}
    plain_counts, want, want_fields = _dashboard_run(True, 8, tmp_path)
    assert not any(plain_counts.values())
    np.testing.assert_array_equal(fields, want_fields)
    np.testing.assert_array_equal(np.stack(dash.zone_temps), np.stack(want.zone_temps))
    for name, series in dash.energy_rates.items():
        np.testing.assert_array_equal(series, want.energy_rates[name], err_msg=name)
    assert dash.timestamps == want.timestamps and len(dash.timestamps) == 8


def test_parity12_through_k2_within_the_drift_budget(env):
    """24 per-env steps of the sb1 day (step-function occupancy, no
    convection) through K2 against the port's exact host: every step within
    5e-2 K with thermostat modes equal, one K2 launch per step."""
    from sbsim_tpu_torch.envs import exact_host

    cfg = presets.sb1_config(num_days_in_episode=1, convection_p=0.0)
    cfg = dataclasses.replace(cfg, occupancy=dataclasses.replace(cfg.occupancy,
                                                                 kind="step_function"))
    parity_env = building_env.BuildingEnv(cfg)
    host = exact_host.ExactHostSimulator(parity_env)
    setpoints = {"supply_water_setpoint": 340.0,
                 "supply_air_heating_temperature_setpoint": 285.0}
    state, _ = parity_env.reset(rng.PRNGKey(0, device=parity_env.device)[None])
    action = torch.as_tensor(parity_env.default_action(setpoints), device=parity_env.device)[None]
    tracker = exact_host.ParityTracker()
    fdm_cuda.reset_launch_counts()
    for i in range(24):
        state, _ = parity_env.step(state, action)
        host.step(setpoints)
        tracker.check(i, state.temp[0].cpu().numpy(), state.hvac.thermostat_mode[0].tolist(),
                      state.hvac.zone_air_temp[0].tolist(), host)
    assert fdm_cuda.launch_counts["fdm_jacobi"] == 24
    report = tracker.finish(allow_crossings=False)
    assert report.max_drift < exact_host.DRIFT_BUDGET


@pytest.mark.slow
def test_sac_improves_with_seeded_replay_on_the_card(env):
    """tests/test_sac_learning.py's two-zone recipe and its three asserts,
    the env step through K2 (chip_smoke.py --learn runs the same)."""
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.agents.train import SACTrainer, TrainConfig

    two_zone = building_env.BuildingEnv(presets.two_zone_test_config(num_days_in_episode=1))
    trainer = SACTrainer(two_zone, TrainConfig(n_envs=8, replay_capacity=20_000,
                                               batch_size=128, updates_per_env_step=2,
                                               seed_steps=0))
    state = trainer.init(rng.PRNGKey(0))
    seed = trainer.seed_with_actions(state, schedule_policy.build_schedule_actions(two_zone))
    for _ in range(100):
        state, _ = seed(state)
    returns = []
    fdm_cuda.reset_launch_counts()
    for i in range(3000):
        state, metrics = trainer.train_step(state)
        if (i + 1) % 1000 == 0:
            returns.append(float(trainer.evaluate(state.sac, rng.PRNGKey(7), n_steps=48,
                                                  n_envs=2)))
    assert fdm_cuda.launch_counts["fdm_jacobi"] == 3000 + 3 * 48
    assert np.isfinite(returns).all()
    assert returns[-1] > returns[0] - 0.05, returns
    assert float(metrics["critic_loss"]) < 1.0
    assert float(metrics["alpha"]) < 0.9

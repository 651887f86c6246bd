"""The port's CUDA kernels on the card (marked `cuda`; skipped without one).

Run on a machine with an NVIDIA Hopper GPU and nvcc, without the JAX test
configuration:

    python -m pytest --noconftest -m "cuda and not slow" tests/test_torch_cuda.py -q

(`-m "cuda and slow"` runs the two-zone SAC learning recipe, ~10 min.)

Each kernel must equal its plain PyTorch version bitwise (fields,
iteration counts, converged flags, and the zone/grid sums of the
statistics epilogue; NaN equal to NaN where an env's field holds one),
count its launches, and refuse inputs it does not take; the block kernels
K3/K4 must also equal K2/K1 env for env (K3 unless a residual is NaN). The
captured programs (graphs.py: the bench rollout, the trainer's seeding and
train steps on both sides of the update gate, evaluate, the per-env step
in each layout, the loaded policy, distributed/mesh.py's four steps on a
one-rank NCCL group and on two NCCL ranks where two cards are present,
the swap step and the learning run's rollout step) must replay bitwise
their eager calls, with no host sync
(set_sync_debug_mode("error")) and the eager calls' launches. This file
imports no JAX.
"""

import collections
import contextlib
import dataclasses
import warnings

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


def _stack_route(env, kernel, block_envs):
    """The route of the stack layout at `block_envs` envs per program for
    kernel's body ("fdm_cheby" or "fdm_jacobi")."""
    return fdm_cuda.route(env.coeffs, method="chebyshev" if kernel == "fdm_cheby" else "jacobi",
                          threshold=0.1, iteration_limit=100, block_mode="stack",
                          block_envs=block_envs)


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
                                      "fdm_cheby_block": 0, "fdm_jacobi_block": 0,
                                      "fdm_cheby_cluster": 0, "fdm_jacobi_cluster": 0}
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
    """K3/K4 at E = 2 and at the E their route runs for a request of 8
    (1) on a batch of 13 (a partial last block) equal their plain versions and K2/K1 bitwise, with statistics; every kernel
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
    route = _stack_route(env, kernel, 8)
    assert (route.kernel, route.block_envs) == (f"{kernel}_block", 1)
    for e in (2, route.block_envs):
        before = fdm_cuda.launch_counts[f"{kernel}_block"]
        got = block(inp, block_envs=e, **kw)
        assert fdm_cuda.launch_counts[f"{kernel}_block"] == before + 1
        _equal(got, block_plain(inp, block_envs=e, **kw))
        _equal(got, want)
    torch.cuda.synchronize()


def test_block_kernels_refuse_more_envs_than_fit(env):
    inp, _ = _inputs(env, 4, seed=1)
    assert _stack_route(env, "fdm_jacobi", 16).block_envs == 1
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
                                      "fdm_cheby_block": 1, "fdm_jacobi_block": 1,
                                      "fdm_cheby_cluster": 0, "fdm_jacobi_cluster": 0}
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
    assert _stack_route(big_env, "fdm_cheby", 4).block_envs == 1
    inp, conv = _inputs(big_env, 4, seed=21)
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv,
              spectral_radius=big_env._spectral_radius, check_every=4)
    solo = _counted("fdm_cheby", fdm_cuda.fdm_cheby_cuda, inp, **kw)
    _equal(solo, fdm_cuda.fdm_cheby_plain(inp, **kw))
    got = _counted("fdm_cheby_block", fdm_cuda.fdm_cheby_block_cuda, inp, block_envs=1, **kw)
    _equal(got, fdm_cuda.fdm_cheby_block_plain(inp, block_envs=1, **kw))
    _equal(got, solo)
    torch.cuda.synchronize()


def test_office_plans_keep_their_block_launch(env, big_env):
    """office12 (52 x 67) and office126 (189 x 124) fit one env per block:
    they launch the block bodies with the geometry they had before the
    cluster bodies (staged 448 threads in 2 passes; unstaged 992 in 6)."""
    assert not fdm_cuda.spans_blocks(env.geom.shape)
    assert not fdm_cuda.spans_blocks(big_env.geom.shape)
    assert fdm_cuda.run_geometry(env.geom.shape, 1) == fdm_cuda.RunGeometry(
        True, 448, 2, 56624, 13, 871, 6, 46)
    assert fdm_cuda.run_geometry(big_env.geom.shape, 1) == fdm_cuda.RunGeometry(
        False, 992, 6, 216880, 48, 5952, 8, 0)


@pytest.fixture(scope="module")
def floor_env(env):
    """floor126's plan: 9 x 14 rooms of 50 x 50 cells, 466 x 721."""
    from sbsim_tpu_torch.core import geometry
    plan = geometry.make_synthetic_office_plan(9, 14, room_cvs=50)
    return building_env.BuildingEnv(presets.sb1_config(
        num_days_in_episode=1, floor_plan=plan, layout="auto"))


CLUSTER_BODY = {"fdm_cheby": "fdm_cheby_cluster", "fdm_cheby_block": "fdm_cheby_cluster",
                "fdm_jacobi": "fdm_jacobi_cluster", "fdm_jacobi_block": "fdm_jacobi_cluster"}


def _plain_for(kernel):
    """Kernel `kernel`'s plain version in its wrapper's place; the
    wrapper's `barriers`, which only a cluster body writes, is dropped."""
    plain = getattr(fdm_cuda, f"{kernel}_plain")
    return lambda inp, barriers=None, **kw: plain(inp, **kw)


def _cluster_kw(env, kernel, conv, limit=100):
    kw = dict(threshold=0.1, iteration_limit=limit, conv=conv, stats=env._stats)
    if kernel.startswith("fdm_cheby"):
        kw.update(spectral_radius=env._spectral_radius, check_every=4)
    if kernel.endswith("_block"):
        kw.update(block_envs=1)
    return kw


def _ladder_conv(env, conv):
    """The doubling ladder's mix32 rounds on the env's plan, with the keys
    of `conv`."""
    with warnings.catch_warnings():  # its 36 core offsets, cut to 32 rounds
        warnings.simplefilter("ignore", UserWarning)
        b = convection.make_convection_buckets(env.geom, 1.0, -1, rng="mix32")
    return fdm_cuda.ConvInputs(
        offsets=b.offsets, lead=fdm_cuda.packed_plane(b.lead_words, env.device),
        foll=fdm_cuda.packed_plane(b.foll_words, env.device),
        word_params=convection.decision_word_params(b), keys=conv.keys)


@pytest.mark.parametrize("kernel", sorted(CLUSTER_BODY))
def test_cluster_bodies_at_floor126(floor_env, kernel):
    """floor126's 466 x 721 plan (335,986 cells: one env's planes far above
    a block's shared memory), B = 4: each kernel runs its cluster body (8
    CTAs of 992 threads an env), one launch, with mix32 and word-plane swap
    rounds (the plan's one group of 16 rounds in shared memory) and the
    doubling ladder's 32 rounds (twelve groups, two of them passes in global
    memory), the statistics by the fold, bitwise its plain version; a
    capped limit converges no env. Each env's barriers are its iterations'
    and the plan's (J(x_f) for Chebyshev, one between groups), and
    `fdm.swap_groups` counts the plan's groups for the launch."""
    shape = floor_env.geom.shape
    assert shape == (466, 721) and fdm_cuda.spans_blocks(shape)
    assert fdm_cuda.cluster_geometry(shape).cluster == 8
    inp, conv = _inputs(floor_env, 4, seed=41)
    assert len(fdm_cuda.swap_plan(shape, conv.offsets).groups) == 1
    ladder = _ladder_conv(floor_env, conv)
    plan = fdm_cuda.swap_plan(shape, ladder.offsets)
    assert len(plan.groups) == 12 and sum(g.tw == 0 for g in plan.groups) == 2
    for c in (conv, _word_plane(floor_env, conv), ladder):
        kw = _cluster_kw(floor_env, kernel, c)
        barriers = torch.full((4,), -1, dtype=torch.int32, device=floor_env.device)
        groups = len(fdm_cuda.swap_plan(shape, c.offsets).groups)
        before = fdm_cuda.swap_counts["swap_groups"]
        got = _counted(CLUSTER_BODY[kernel], getattr(fdm_cuda, f"{kernel}_cuda"), inp,
                       barriers=barriers, **kw)
        _equal(got, getattr(fdm_cuda, f"{kernel}_plain")(inp, **kw))
        assert bool(got[2].all())
        fixed = groups - 1 + (1 if kernel.startswith("fdm_cheby") else 0)
        assert torch.equal(barriers, got[1] + fixed)
        assert fdm_cuda.swap_counts["swap_groups"] == before + groups
    kw = _cluster_kw(floor_env, kernel, conv, limit=1 if "cheby" in kernel else 3)
    capped = getattr(fdm_cuda, f"{kernel}_cuda")(inp, **kw)
    _equal(capped, getattr(fdm_cuda, f"{kernel}_plain")(inp, **kw))
    assert not bool(capped[2].any())
    torch.cuda.synchronize()


@pytest.mark.parametrize("solver,kernel", [("pallas_cheby", "fdm_cheby_cluster"),
                                           ("pallas_env", "fdm_jacobi_cluster")])
def test_floor126_captured_step_equals_plain(floor_env, solver, kernel):
    """One captured step of floor126 at B=4 (bench.make_rollout, one step a
    call) through the cluster body replays bitwise the same step op by op
    through the plain versions, with no host sync and one launch; traced,
    the call counts each env's barriers (fdm.barriers): its iterations' and
    those its swap plan predicts, and the replay's launch and swap plan
    groups (fdm.launches, fdm.swap_groups)."""
    from sbsim_tpu_torch import bench
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.utils import profiling

    table = schedule_policy.build_schedule_actions(floor_env)
    start, _ = floor_env.reset(rng.split(rng.PRNGKey(5, device=floor_env.device), 4))
    start = start.replace(step_idx=torch.full_like(start.step_idx, 100))
    roll = bench.make_rollout(floor_env, table, 1, solver)
    names = ("fdm_cheby", "fdm_jacobi", "fdm_cheby_block", "fdm_jacobi_block")
    saved = {k: getattr(fdm_cuda, f"{k}_cuda") for k in names}
    try:
        for k in names:
            setattr(fdm_cuda, f"{k}_cuda", _plain_for(k))
        want = roll.eager(_clone(start))
    finally:
        for k, fn in saved.items():
            setattr(fdm_cuda, f"{k}_cuda", fn)
    roll(_clone(start))  # the first call captures
    got, launched = _replayed(roll, _clone(start))
    assert launched == {kernel: 1}
    assert _trees_equal(got, want)
    with profiling.tracing():
        roll(_clone(start))
        counters = profiling.snapshot()["counters"]
    # Beside one an iteration: J(x_f) (Chebyshev) and one between groups of
    # the swap plan (floor126's is one group), for each of the 4 envs.
    groups = len(fdm_cuda.swap_plan(floor_env.geom.shape, floor_env.convection.offsets).groups)
    fixed = groups - 1 + (1 if solver == "pallas_cheby" else 0)
    assert counters["fdm.iterations"] > 0
    assert counters["fdm.barriers"] - counters["fdm.iterations"] == 4 * fixed
    # The replay's launch, and its plan's groups, as an op-by-op launch counts them.
    assert counters[f"fdm.launches.{kernel}"] == 1
    assert counters["fdm.swap_groups"] == groups


def test_a_million_cell_plan_steps_bitwise_plain(env):
    """9 x 14 rooms of 90 cells (826 x 1,281 = 1,058,106 cells; 8 CTAs of
    1,024 threads an env, 33 runs a thread): one step_batched at B=1
    through K1's cluster body equals the step through the plain version."""
    from sbsim_tpu_torch.core import geometry
    plan = geometry.make_synthetic_office_plan(9, 14, room_cvs=90)
    huge = building_env.BuildingEnv(presets.sb1_config(
        num_days_in_episode=1, floor_plan=plan, layout="auto"))
    assert huge.geom.shape[0] * huge.geom.shape[1] == 1058106
    step = lambda: _steps_through(huge, "pallas_cheby", 1, plain=False, seed=13, steps=1)
    counts, got, got_out = step()
    assert counts["fdm_cheby_cluster"] == 1 and sum(counts.values()) == 1
    _, want, want_out = _steps_through(huge, "pallas_cheby", 1, plain=True, seed=13, steps=1)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    np.testing.assert_array_equal(got_out, want_out)


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
    assert _stack_route(big_env, "fdm_jacobi", 4).block_envs == 1
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


def _steps_through(env, solver, batch, plain, seed, steps=3):
    """`steps` step_batched steps from a fresh reset (with solver None, of
    the per-env `step` at batch 1), through the kernels or, with `plain`,
    through their plain versions on the card; the launch counts, final
    state and outputs."""
    from sbsim_tpu_torch import convert

    names = ("fdm_cheby", "fdm_jacobi", "fdm_cheby_block", "fdm_jacobi_block")
    saved = {k: getattr(fdm_cuda, f"{k}_cuda") for k in names}
    if plain:
        for k in names:
            setattr(fdm_cuda, f"{k}_cuda", _plain_for(k))
    try:
        state, _ = env.reset(rng.split(rng.PRNGKey(seed, device=env.device), batch))
        acts = torch.as_tensor(np.random.default_rng(seed).uniform(
            -1, 1, (steps, batch, env.n_actions)), dtype=torch.float32, device=env.device)
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
    through K2 (its per-env step captured) or, with `plain`, its plain
    version op by op (the plain loop reads back: graphs.disabled); the
    launch counts, the dashboard's accumulators and each step's field."""
    import contextlib

    from sbsim_tpu_torch import graphs
    from sbsim_tpu_torch.examples import episode_dashboard

    saved = fdm_cuda.fdm_jacobi_cuda
    if plain:
        fdm_cuda.fdm_jacobi_cuda = fdm_cuda.fdm_jacobi_plain
    fields = []
    try:
        fdm_cuda.reset_launch_counts()
        with graphs.disabled() if plain else contextlib.nullcontext():
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
                      "fdm_jacobi_block": 0, "fdm_cheby_cluster": 0, "fdm_jacobi_cluster": 0}
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


# ---------------------------------------------------------------------------
# The study scripts (sbsim_tpu_torch/benchmarks) at chip_smoke.py phase 12's
# cut, each through K2 (K1 for the decomposition), against its witnesses.
# ---------------------------------------------------------------------------


def _chip_smoke():
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


def _launched(fn, *args):
    """fn(*args) and the kernels it launched."""
    fdm_cuda.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: v for k, v in fdm_cuda.launch_counts.items() if v}


def _within(row, want, smoke):
    assert abs(row["worst_zone_ks"] - want[0]) <= smoke.WITNESS_KS_TOL, (row, want)
    assert abs(row["worst_zone_dmean_K"] - want[1]) <= smoke.WITNESS_DMEAN_TOL, (row, want)


def test_conv_fullscale_null_on_the_card(env, tmp_path):
    """The 126-room null: two swap draws through K2, exact_vs_exact the JAX
    script's row."""
    from sbsim_tpu_torch.benchmarks import conv_fullscale_null, conv_rounds_sweep

    smoke = _chip_smoke()
    result, counts = _launched(conv_fullscale_null.main, ["--out", str(tmp_path / "n.json")])
    assert counts == {"fdm_jacobi": 2 * conv_rounds_sweep.N_STEPS}
    ee = result["exact_vs_exact"]
    assert (round(ee["worst_zone_ks"], 4), round(ee["worst_zone_dmean_K"], 4)) == \
        smoke.NULL_EXACT_WITNESS
    assert np.isfinite([v for k in ("swap_vs_swap", "swap_vs_exact_auto")
                        for v in result[k].values()]).all()


@pytest.mark.parametrize("script", ["conv_designed_sweep", "conv_schedule_sweep"])
def test_schedule_sweeps_on_the_card(env, tmp_path, script):
    """The designed sweep's six rows and the seeded sweep at two variants
    through K2, each within the witness tolerances of the JAX script's."""
    import importlib

    from sbsim_tpu_torch.benchmarks import conv_rounds_sweep

    smoke = _chip_smoke()
    module = importlib.import_module(f"sbsim_tpu_torch.benchmarks.{script}")
    argv = ["--out", str(tmp_path / "s.json")]
    if script == "conv_schedule_sweep":
        argv += ["--variants", smoke.SCHEDULE_VARIANTS]
    result, counts = _launched(module.main, argv)
    assert counts == {"fdm_jacobi": len(result["rows"]) * conv_rounds_sweep.N_STEPS}
    for row in result["rows"]:
        if script == "conv_designed_sweep":
            _within(row, smoke.DESIGNED_WITNESS[row["name"]], smoke)
        else:
            _within(row, smoke.SCHEDULE_WITNESS[(row["rounds"], row["schedule_seed"])], smoke)
    assert len(result["rows"]) == (6 if script == "conv_designed_sweep" else 2)


@pytest.mark.parametrize("script", ["sac_smoke", "sac_sb1_smoke"])
def test_sac_smokes_on_the_card(env, script):
    """Each SAC smoke at the cut recipe through K2: every number finite,
    one K2 launch per env step."""
    import importlib

    smoke = _chip_smoke()
    module = importlib.import_module(f"sbsim_tpu_torch.benchmarks.{script}")
    args = module.parse_args(smoke.SMOKE_ARGS)
    result, counts = _launched(module.main, smoke.SMOKE_ARGS)
    evals = args.train_steps // args.eval_every
    evaluated = (3 + evals if script == "sac_smoke" else 1 + evals) * module.N_EVAL
    assert counts == {"fdm_jacobi": args.seed_steps + args.train_steps + evaluated}
    assert smoke._finite_numbers(result) and len(result["curve"]) == evals


def test_scaling_decomp_on_the_card(env):
    """The decomposition at 2 gloo ranks on the card: every row bitwise one
    process, K1 launches per rank (1 + repeats) x steps."""
    from sbsim_tpu_torch.benchmarks import scaling_decomp

    smoke = _chip_smoke()
    argv = smoke.DECOMP_ARGS + ["--ranks", "2", "--backend", "gloo"]
    args = scaling_decomp.parse_args(argv)
    payload = scaling_decomp.main(argv)
    assert len(payload["rows"]) == 5
    for row in payload["rows"].values():
        assert row["bitwise_one_process"]
        assert all(c["fdm_cheby"] == (1 + args.repeats) * args.steps for c in row["launches"])
    assert set(payload["attribution"]) == {"naive_efficiency", "wrapper_tax",
                                           "core_sharing_tax", "partition_tax",
                                           "collective_share"}


def test_bench_on_the_card(env, capsys):
    """The port bench at --steps 8 --max-repeats 2: pallas_cheby at B=2048,
    a passed solver check, CUDA-event timing, K1 launched once for the
    check and once per step of the warm-up and the timed calls."""
    import json

    from sbsim_tpu_torch import bench

    fdm_cuda.reset_launch_counts()
    assert bench.main(["--steps", "8", "--max-repeats", "2"]) == 0
    torch.cuda.synchronize()
    counts = {k: v for k, v in fdm_cuda.launch_counts.items() if v}
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["solver"], line["batch"], line["timing"]) == ("pallas_cheby", 2048,
                                                               "cuda_events")
    assert line["solver_check"]["passed"] and len(line["repeats"]) == 2
    assert all(np.isfinite(r) and r > 0 for r in line["repeats"])
    assert counts == {"fdm_cheby": 1 + (1 + len(line["repeats"])) * 8}


# ---------------------------------------------------------------------------
# Captured programs (graphs.py): each replay bitwise the eager call, from a
# clone of the same start, with no host sync and the eager call's launches.
# ---------------------------------------------------------------------------


def _clone(tree):
    from sbsim_tpu_torch import graphs

    return graphs.tree_map(torch.clone, tree)


def _replayed(fn, *args, draws=None):
    """fn(*args) under set_sync_debug_mode("error"), and its FDM kernel
    launches; with `draws`, its draw kernel launches must equal them."""
    torch.cuda.synchronize()
    before = dict(fdm_cuda.launch_counts)
    drawn = dict(rng.launch_counts)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if draws is not None:
        assert _moved(rng.launch_counts, drawn) == draws
    return out, _moved(fdm_cuda.launch_counts, before)


def _moved(counts, before):
    return {k: n - before[k] for k, n in counts.items() if n != before[k]}


def _trees_equal(a, b):
    from sbsim_tpu_torch import graphs

    la, lb = [], []
    assert graphs.flatten(a, la) == graphs.flatten(b, lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("solver,kernel", [("pallas_cheby", "fdm_cheby"),
                                           ("pallas_env", "fdm_jacobi")])
def test_rollout_replay_equals_eager(env, solver, kernel):
    from sbsim_tpu_torch import bench
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.utils import profiling

    table = schedule_policy.build_schedule_actions(env)
    start, _ = env.reset(rng.split(rng.PRNGKey(4, device=env.device), 64))
    start = start.replace(step_idx=torch.full_like(start.step_idx, 284))  # across the end
    roll = bench.make_rollout(env, table, 6, solver)
    want = roll.eager(_clone(start))
    roll(_clone(start))  # the first call captures
    draws = {"split": 6, "uniform": 12}  # per step: the key split, two occupancy peeks
    got, launched = _replayed(roll, _clone(start), draws=draws)
    assert launched == {kernel: 6}
    assert _trees_equal(got, want)
    (program,) = roll.programs.values()
    # One replay's launches per family of device launches (fdm, rng, swap groups).
    per_replay = dict(zip(map(id, profiling.launch_families()), program.per_replay))
    assert program.replays == 1 and per_replay == {
        id(fdm_cuda.launch_counts): {kernel: 6}, id(rng.launch_counts): draws,
        id(fdm_cuda.swap_counts): {}}


def test_trainer_replays_equal_eager_across_the_end_and_the_gate(env):
    from sbsim_tpu_torch.agents import schedule_policy, train

    trainer = train.SACTrainer(env, train.recipe_for(
        env, n_envs=8, batch_size=64, replay_capacity=800, seed_steps=6 * 8))
    state = trainer.init(rng.PRNGKey(2, device=env.device))
    state = state.replace(env_states=state.env_states.replace(
        step_idx=torch.full_like(state.env_states.step_idx, 286)))
    seed = trainer.seed_with_actions(state, schedule_policy.build_schedule_actions(env))
    step = trainer.captured_train_step()
    eager, graph = _clone(state), _clone(state)
    # 3 seeding steps (the second crosses the 288-step end), then 2 train
    # steps on each side of the gate: each program's first call captures.
    plan = [(seed, seed.eager)] * 3 + [(step, trainer.train_step)] * 4
    # Draw launches of a replay: a seeding step, a train step before the
    # gate, one after it (15: 8 splits, 3 uniforms, 3 normals, 1 randint).
    draws = [{"split": 4, "uniform": 3}] * 3 + [{"split": 6, "uniform": 3, "normal": 1}] * 2 + [
        {"split": 8, "uniform": 3, "normal": 3, "randint": 1}] * 2
    for i, (captured, op_by_op) in enumerate(plan):
        eager, want_m = op_by_op(eager)
        replay = i not in (0, 3, 5)
        if replay:
            (graph, got_m), launched = _replayed(captured, graph, draws=draws[i])
            assert launched == {"fdm_jacobi": 1}
        else:
            graph, got_m = captured(graph)
        assert graph.env_steps == eager.env_steps
        assert _trees_equal((graph.env_states, graph.last_obs, graph.replay, graph.sac,
                             graph.rng), (eager.env_states, eager.last_obs, eager.replay,
                                          eager.sac, eager.rng))
        assert _trees_equal(got_m, want_m)
    assert [bool(s.program.programs) for s in step.sides] == [True, True]
    assert seed.program.programs and (graph.env_states.step_idx == 5).all()


def test_evaluate_replay_equals_eager(env):
    from sbsim_tpu_torch.agents import train

    trainer = train.SACTrainer(env, train.recipe_for(env, n_envs=8, batch_size=64))
    sac = trainer.init(rng.PRNGKey(3, device=env.device)).sac
    key = rng.PRNGKey(7, device=env.device)
    evaluate = trainer.captured_evaluate()
    want = trainer.evaluate(sac, key, 12, 4)
    evaluate(sac, key, 12, 4)  # the first call captures
    got, launched = _replayed(evaluate, sac, key, 12, 4)
    assert launched == {"fdm_jacobi": 12} and torch.equal(got, want)


# The rest of the jitted programs: the per-env step, the loaded policy, the
# ranks' steps on a one-rank NCCL group, the scripts' loops.


@pytest.mark.parametrize("layout", ["jacobi", "chebyshev", "stack"])
def test_per_env_step_replay_equals_eager(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels are sm_90a CUDA)")
    kw = {"jacobi": {}, "chebyshev": {"fdm_solver": "chebyshev"},
          "stack": {"pallas_block_mode": "stack", "pallas_block_envs": 2}}[layout]
    env = building_env.BuildingEnv(dataclasses.replace(
        presets.sb1_config(num_days_in_episode=1), **kw))
    kernel = ("fdm_cheby" if layout == "chebyshev" else "fdm_jacobi") + (
        "_block" if layout == "stack" else "")
    start, _ = env.reset(rng.PRNGKey(5, device=env.device)[None])
    act = torch.linspace(-1.0, 1.0, env.n_actions, device=env.device)[None]
    step = env.captured_step
    want = step.eager(_clone(start), act)
    step(_clone(start), act)  # the first call captures
    got, launched = _replayed(step, _clone(start), act)
    assert launched == {kernel: 1} and _trees_equal(got, want)


def test_loaded_policy_replay_equals_eager(env, tmp_path):
    from sbsim_tpu_torch.agents import policies, sac

    learner = sac.SACLearner(env.obs_dim, env.n_actions, device=env.device)
    policies.save_policy(str(tmp_path), learner,
                         learner.init(rng.PRNGKey(6, device=env.device)), env.action_names)
    policy, _ = policies.load_policy(str(tmp_path))
    obs = torch.randn((5, 1, env.obs_dim), generator=torch.Generator().manual_seed(1))
    obs = obs.to(env.device)
    policy(obs[0])  # the first call captures
    for o in obs[1:]:
        got, _ = _replayed(policy, o)
        assert torch.equal(got, policy.program.eager(o))


def test_one_rank_nccl_mesh_steps_replay_equal_eager(env, tmp_path):
    from sbsim_tpu_torch.agents import schedule_policy, train
    from sbsim_tpu_torch.distributed import mesh as mesh_lib
    from sbsim_tpu_torch.distributed import runtime

    runtime.initialize(backend="nccl", init_method=f"file://{tmp_path}/store", world_size=1,
                       rank=0, timeout=120.0)
    try:
        mesh = mesh_lib.make_mesh()
        assert runtime.captures(mesh.group)
        trainer = train.SACTrainer(env, train.recipe_for(
            env, n_envs=8, batch_size=64, replay_capacity=800, seed_steps=5 * 8))
        table = schedule_policy.build_schedule_actions(env)
        state = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(2, device=env.device)),
                                           mesh)
        steps = [(mesh_lib.make_distributed_collect_step(trainer, mesh, table), (0,)),
                 (mesh_lib.make_distributed_train_step(trainer, mesh), (0, 2)),
                 (mesh_lib.make_shardmapped_train_step(trainer, mesh, state), (0, 2))]
        for step, captures in steps:
            eager, graph = _clone(state), _clone(state)
            for i in range(3):
                eager, want_m = step.eager(eager)
                if i in captures:
                    graph, got_m = step(graph)
                else:
                    (graph, got_m), launched = _replayed(step, graph)
                    assert launched == {"fdm_jacobi": 1}
                assert graph.env_steps == eager.env_steps
                assert _trees_equal((graph.env_states, graph.replay, graph.sac, graph.rng),
                                    (eager.env_states, eager.replay, eager.sac, eager.rng))
                assert _trees_equal(got_m, want_m)
            state = graph if step is steps[0][0] else state
        roll = mesh_lib.make_shardmapped_rollout(env, mesh, table, 4)
        start, _ = env.reset(rng.split(rng.PRNGKey(4, device=env.device), 8))
        want = roll.eager(_clone(start))
        roll(_clone(start))  # the first call captures
        got, launched = _replayed(roll, _clone(start))
        assert launched == {"fdm_jacobi": 4} and _trees_equal(got, want)
    finally:
        runtime.shutdown()


def _two_nccl_ranks(rank, world, out):
    """One of two NCCL ranks, one card each: distributed/mesh.py's train
    step (both sides of the update gate) and rollout as captured programs,
    their collectives inside the graphs, each replay bitwise the eager
    call; then runtime.shutdown, which must return (the programs go before
    the group: graphs.release). Saves the rank's actor parameters."""
    from sbsim_tpu_torch.agents import schedule_policy, train
    from sbsim_tpu_torch.distributed import mesh as mesh_lib
    from sbsim_tpu_torch.distributed import runtime

    runtime.initialize(backend="nccl", init_method=f"file://{out}/store", world_size=world,
                       rank=rank, timeout=120.0)
    try:
        device = torch.device("cuda", rank)
        env = building_env.BuildingEnv(presets.sb1_config(num_days_in_episode=1), device=device)
        mesh = mesh_lib.make_mesh()
        assert mesh.size == world and runtime.captures(mesh.group)
        trainer = train.SACTrainer(env, train.recipe_for(
            env, n_envs=8 * world, batch_size=64, replay_capacity=800, seed_steps=6 * 8 * world))
        table = schedule_policy.build_schedule_actions(env)
        state = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(2, device=device)), mesh)
        seed = mesh_lib.make_distributed_collect_step(trainer, mesh, table)
        for _ in range(3):
            state, _ = seed(state)
        step = mesh_lib.make_distributed_train_step(trainer, mesh)
        eager, graph = _clone(state), _clone(state)
        for _ in range(4):  # the gate opens at the third call: both sides captured, replayed
            eager, want_m = step.eager(eager)
            graph, got_m = step(graph)
            assert _trees_equal((graph.env_states, graph.replay, graph.sac, graph.rng),
                                (eager.env_states, eager.replay, eager.sac, eager.rng))
            assert _trees_equal(got_m, want_m)
        roll = mesh_lib.make_shardmapped_rollout(env, mesh, table, 4)
        start, _ = env.reset(rng.split(rng.PRNGKey(4, device=device), 8 * world)[
            8 * rank:8 * (rank + 1)])
        want = roll.eager(_clone(start))
        for _ in range(3):  # the first call captures, then replays
            assert _trees_equal(roll(_clone(start)), want)
        torch.save({k: v.cpu() for k, v in graph.sac.actor_params.items()},
                   f"{out}/actor{rank}.pt")
    finally:
        runtime.shutdown()


def test_two_nccl_ranks_replay_equal_eager_and_shut_down(tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (one NCCL rank per card)")
    from sbsim_tpu_torch.distributed import runtime

    runtime.spawn(_two_nccl_ranks, 2, (str(tmp_path),), timeout=300.0)
    a, b = (torch.load(tmp_path / f"actor{r}.pt") for r in range(2))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_script_programs_replay_equal_eager(env):
    from sbsim_tpu_torch import graphs
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
    from sbsim_tpu_torch.benchmarks import sac_sb1_train

    action = torch.zeros((crs.SEEDS, env.n_actions), device=env.device)
    start, _ = env.reset(rng.split(rng.PRNGKey(9, device=env.device), crs.SEEDS))
    step = crs.swap_step(env)
    want = step.eager(_clone(start), action)
    step(_clone(start), action)  # the first call captures
    got, launched = _replayed(step, _clone(start), action)
    assert launched == {"fdm_jacobi": 1} and _trees_equal(got, want)
    swap, _ = crs.run_swap(env.config, env.device)
    with graphs.disabled():
        eager_swap, _ = crs.run_swap(env.config, env.device)
    assert np.array_equal(swap, eager_swap)
    table = torch.as_tensor(schedule_policy.build_schedule_actions(env), device=env.device)
    key = rng.PRNGKey(7, device=env.device)
    step = sac_sb1_train.rollout_step(env, "pallas_env")
    want = sac_sb1_train._rollout(step.eager, env, table, key, 12, 4)
    sac_sb1_train._rollout(step, env, table, key, 12, 4)  # the first captures
    got, launched = _replayed(sac_sb1_train._rollout, step, env, table, key, 12, 4)
    assert launched == {"fdm_jacobi": 12} and _trees_equal(got, want)
    (program,) = step.programs.values()
    assert program.replays == 12 + 11


# ---------------------------------------------------------------------------
# The draw kernel (csrc/rng_kernels.cu): each draw kind bitwise its plain
# version over 2**20 words or more, and whole runs bitwise the same runs
# with every draw through the plain versions, the int64 elementwise chains
# that the card ran before the kernel.
# ---------------------------------------------------------------------------

DRAWS = ("split", "fold_in", "bits", "uniform", "normal", "randint")


def _card_keys(n, seed):
    rs = np.random.default_rng(seed)
    keys = rs.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.int64)
    keys[:4] = [(0, 0), (2**32 - 1, 2**32 - 1), (0, 2**32 - 1), (2**31, 2**31 - 1)]
    return torch.as_tensor(keys, device="cuda")


def _draw_cases(kind):
    """(keys, args) of the draw `kind`: each case 2**20 outputs or more."""
    size = lambda v, dtype=torch.int32: torch.tensor(v, dtype=dtype, device="cuda")
    return {
        "split": [(_card_keys(4096, 1), (256,)), (_card_keys(2**19, 2), (2,)),
                  (_card_keys(2**18, 3), (4,))],
        "fold_in": [(_card_keys(2**20, 4), (7,)), (_card_keys(2**20, 5), (2**32 - 1,))],
        "bits": [(_card_keys(4, 6), ((2**18,),)), (_card_keys(2048, 7), ((2, 16, 32),))],
        "uniform": [(_card_keys(2**14, 8), ((64, 1),)),
                    (_card_keys(2**13, 9), ((126, 1), -0.1, 0.1)),
                    (_card_keys(2**10, 10), ((2**10,), 2.0, 3.5))],
        "normal": [(_card_keys(4, 11), ((2**22,),)), (_card_keys(4096, 12), ((256, 3),))],
        "randint": [(_card_keys(4, 13), ((2**18,), 0, size(50_000))),
                    (_card_keys(4, 14), ((2**18,), 0, size(1))),
                    (_card_keys(4, 15), ((2**18,), size(9, torch.int64), 3)),
                    (_card_keys(2**12, 16), ((64, 4), -2**31, 2**31 - 1))],
    }[kind]


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("kind", DRAWS)
def test_draw_kernel_equals_plain(env, kind):
    """Each case one launch of the kernel, bitwise the plain version on the
    card; normal over 2**24 words reaches both tails (u within 2**-17 of
    -1 and of 1, where erfinv takes its w >= 5 branch)."""
    for keys, args in _draw_cases(kind):
        before = rng.launch_counts[kind]
        got = getattr(rng, kind)(keys, *args)
        assert rng.launch_counts[kind] == before + 1
        want = getattr(rng, f"{kind}_plain")(keys, *args)
        assert _bits_equal(got, want)
    if kind == "normal":
        keys, (shape,) = _draw_cases(kind)[0]
        mant = rng.bits(keys, shape) >> 9
        assert int(mant.min()) < 64 and int(mant.max()) >= 2**23 - 64
        assert float(rng.normal(keys, shape).abs().max()) > 4.5


def test_draw_kernel_reads_key_views_and_refuses_what_it_does_not_take(env):
    keys = _card_keys(2048, 20)
    sub = rng.split(keys, 4)
    for i in range(4):
        assert _bits_equal(rng.uniform(sub[:, i], (12, 1)), rng.uniform_plain(sub[:, i], (12, 1)))
    assert _bits_equal(rng.split(keys.T.contiguous().T, 3), rng.split_plain(keys, 3))
    with pytest.raises(ValueError, match="do not merge"):
        rng.bits(keys.view(2, 1024, 2)[:, :512], (4,))
    with pytest.raises(ValueError, match="keys' device"):
        rng.randint(keys, (4,), 0, torch.tensor(5))
    with pytest.raises(ValueError, match="one value or one per output"):
        rng.randint(keys, (4,), 0, torch.ones(4, dtype=torch.int32, device="cuda"))


def _plain_draws():
    """A context in which every draw runs its plain version, as on the card
    before the draw kernel."""

    @contextlib.contextmanager
    def ctx():
        saved = {k: getattr(rng, k) for k in DRAWS}
        for k in DRAWS:
            setattr(rng, k, getattr(rng, f"{k}_plain"))
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(rng, k, fn)

    return ctx()


def test_office12_episode_and_reset_equal_the_plain_draws(env):
    """The office12 rollout cell's program (the bench config, B=2048, one
    captured step per call): a 576-step episode, its reset and 8 steps
    more, every state field and mean reward bitwise the same run with the
    plain draws, 3 draw launches per step."""
    from sbsim_tpu_torch import bench, convert, graphs
    from sbsim_tpu_torch.agents import schedule_policy

    env12 = building_env.BuildingEnv(bench.bench_config(False))
    table = schedule_policy.build_schedule_actions(env12)
    runs = []
    for plain in (False, True):
        with _plain_draws() if plain else contextlib.nullcontext():
            roll = bench.make_rollout(env12, table, 1, "pallas_cheby")
            states, _ = env12.reset(rng.split(rng.PRNGKey(1, device=env12.device), 2048))
            means, drawn = [], collections.Counter()
            for i in range(env12.steps_per_episode + 8):
                if i == env12.steps_per_episode:
                    kept = convert.env_state_to_numpy(states)
                    states, _ = env12.reset(rng.split(rng.PRNGKey(2, device=env12.device),
                                                      2048))
                before = dict(rng.launch_counts)
                states, mean = roll(states)
                drawn.update(_moved(rng.launch_counts, before))
                means.append(mean)
            if not plain:
                calls = env12.steps_per_episode + 8
                assert drawn == {"split": calls, "uniform": 2 * calls}
            runs.append((kept, convert.env_state_to_numpy(states), torch.stack(means)))
        graphs.release()
    (k0, s0, m0), (k1, s1, m1) = runs
    assert torch.equal(m0, m1)
    for got, want in ((k0, k1), (s0, s1)):
        flat = lambda t: {**{k: v for k, v in t.items() if k != "hvac"}, **t["hvac"]}
        a, b = flat(got), flat(want)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_office12_train_run_equals_the_plain_draws(env):
    """The office12 train cell's recipe (64 envs, batch 256, replay
    50,000, seed_steps 0): 100 captured train steps, the TrainState and
    each step's metrics bitwise the same run with the plain draws."""
    from sbsim_tpu_torch import bench, graphs
    from sbsim_tpu_torch.agents import train

    env12 = building_env.BuildingEnv(bench.bench_config(False))
    runs = []
    for plain in (False, True):
        with _plain_draws() if plain else contextlib.nullcontext():
            trainer = train.SACTrainer(env12, train.recipe_for(
                env12, n_envs=64, batch_size=256, replay_capacity=50_000, seed_steps=0))
            state = trainer.init(rng.PRNGKey(3, device=env12.device))
            step = trainer.captured_train_step()
            metrics = []
            for _ in range(100):
                state, m = step(state)
                metrics.append(m)
            runs.append((state, metrics))
        graphs.release()
    (a, ma), (b, mb) = runs
    assert a.env_steps == b.env_steps
    assert _trees_equal((a.env_states, a.last_obs, a.replay, a.sac, a.rng),
                        (b.env_states, b.last_obs, b.replay, b.sac, b.rng))
    assert all(_trees_equal(x, y) for x, y in zip(ma, mb))

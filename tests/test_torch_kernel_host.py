"""The CUDA kernel source rehearsed on the CPU: csrc/fdm_kernels.cu built as
host C++ with g++ against tests/fdm_host_stub.h and bound with ctypes.

The stub runs the threads of a thread block as host threads that meet at a
std::barrier in __syncthreads, emulates warp shuffles, and turns the bulk
copies into plain copies (host build only); it is built with
-ffp-contract=off, as the card's build uses -fmad=false. Through the
port's own launch wrapper (`fdm_cuda._launch` with the host library), K1
and K4 (the one Chebyshev body) and K2 and K3 must equal their plain
PyTorch versions bitwise on the 12-zone sb1 grid (B <= 5, K4 at E = 1,
2 and 4, K3 at E = 2) and on a 9 x 11 grid whose width is not a multiple of
the run length (B <= 13, K3 at E = 1-4); an env whose field holds a NaN follows each Jacobi kernel's
stopping rule. The cluster bodies (a plan above one block's shared memory:
one cluster of CTAs per env, the host threads of all its blocks at once,
meeting at the cluster barrier) are forced on those grids by a shared-memory
budget of 0 B and must equal the same plain versions bitwise, under swap
plans of one group, of several groups with rounds too wide for any tile,
and with halo tiles larger than the grid, each env crossing the barriers
its plan predicts; a grid too large for a block runs through them, and a
launch the card cannot hold, or whose cells overflow a 32-bit index, is
refused before launch. It shows logic faults (ownership, parity, freezing,
counts, the swap rounds' decisions, tiles and halos, the bands' borders),
not races or the card's timing. The test skips where there is no g++ and
takes about a minute.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sbsim_tpu_torch.core import geometry
from sbsim_tpu_torch.envs import building_env, presets
from sbsim_tpu_torch.physics import convection, fdm_cuda

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source as host C++")
    path = str(tmp_path_factory.mktemp("fdm_host") / "fdm_kernels_host.so")
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         "-DFDM_HOST_REHEARSAL", f"-I{TESTS}", "-x", "c++", fdm_cuda.SOURCE, "-o", path],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return fdm_cuda.bind(ctypes.CDLL(path))


@pytest.fixture(scope="module")
def envs():
    sb1 = building_env.BuildingEnv(presets.sb1_config(num_days_in_episode=1), device="cpu")
    small = building_env.BuildingEnv(presets.two_zone_test_config(), device="cpu")
    rooms24 = building_env.BuildingEnv(presets.sb1_config(
        num_days_in_episode=1, floor_plan=geometry.make_synthetic_office_plan(2, 2, room_cvs=24)),
        device="cpu")
    return {"sb1": sb1, "small": small, "rooms24": rooms24}


def _inputs(env, batch, seed, conv_kind, buckets=None):
    """Seeded kernel inputs on the env's grid, and the swap convection of
    `buckets` (the env's own by default, enabled) with mix32 keys or the
    threefry word plane."""
    rs = np.random.default_rng(seed)
    shape = (batch,) + env.geom.shape
    t = torch.as_tensor
    inp = fdm_cuda.kernel_inputs(
        t((294.0 + rs.normal(0, 2.0, shape)).astype(np.float32)),
        t(rs.uniform(0.0, 50.0, shape).astype(np.float32)),
        t(rs.uniform(270.0, 300.0, batch).astype(np.float32)),
        t(np.full(batch, 100.0, np.float32)),
        env.coeffs,
    )
    if conv_kind is None:
        return inp, None
    keys = t(rs.integers(0, 2**32, (batch, 2), dtype=np.uint64).astype(np.int64))
    buckets = dataclasses.replace(buckets or env.convection, enabled=True,
                                  rng="mix32" if conv_kind == "mix32" else "threefry")
    conv = fdm_cuda.ConvInputs(
        offsets=buckets.offsets,
        lead=fdm_cuda.packed_plane(buckets.lead_words, "cpu"),
        foll=fdm_cuda.packed_plane(buckets.foll_words, "cpu"))
    if conv_kind == "mix32":
        params = convection.decision_word_params(buckets)
        return inp, dataclasses.replace(conv, word_params=params, keys=keys)
    words = convection.swap_decision_word(buckets, keys, env.geom.shape)
    return inp, dataclasses.replace(conv, words=fdm_cuda.packed_plane(words, "cpu"))


def _equal(got, want):
    """Bitwise, a NaN equal to a NaN (torch.equal takes NaN as unequal)."""
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(got[:3], want[:3]):
        same(a, b)
    assert len(got) == len(want)
    if len(want) > 3:
        same(got[3].zone_sums, want[3].zone_sums)
        same(got[3].grid_sums, want[3].grid_sums)


def _run(host_lib, name, env, inp, conv, stats, limit, e=None, budget=fdm_cuda.SMEM_BUDGET,
         check_every=4, barriers=None, tiled=None):
    """The kernel through the host library (with `budget` bytes of shared
    memory a block, 0 for the cluster bodies), and its plain version
    (`env` None: the spectral radius 0.9)."""
    kw = dict(threshold=0.1, iteration_limit=limit, conv=conv, stats=stats)
    args = [0.1, limit]
    if name.startswith("fdm_cheby"):
        rho = 0.9 if env is None else env._spectral_radius
        kw.update(spectral_radius=rho, check_every=check_every)
        args = fdm_cuda._cheby_args(0.1, limit, rho, check_every)
    if e is not None:
        kw.update(block_envs=e)
    got = fdm_cuda._launch(name, inp, conv, stats, args, e, lib=host_lib, budget=budget,
                           barriers=barriers, tiled_sweeps=tiled)
    want = getattr(fdm_cuda, f"{name}_plain")(inp, **kw)
    return got, want


def test_geometry_matches_python_mirror(host_lib):
    """Both bodies' C launch geometry equals its Python mirror."""
    out = (ctypes.c_int * 8)()
    for body in ("cheby", "jacobi"):
        geometry = getattr(fdm_cuda, f"{body}_geometry")
        for shape in ((52, 67), (189, 124), (9, 11), (7, 5), (160, 170)):
            assert (getattr(host_lib, f"fdm_{body}_max_envs")(*shape)
                    == getattr(fdm_cuda, f"{body}_max_envs")(shape))
            for e in range(1, 6):
                geo = geometry(shape, e)
                err = getattr(host_lib, f"fdm_{body}_geometry")(e, *shape, out)
                assert (err == 0) == (geo is not None)
                if geo is not None:
                    assert list(out) == [int(geo.staged), geo.threads, geo.slots, geo.smem,
                                         geo.row_blocks, geo.n_runs, geo.step_b, geo.step_x]


@pytest.mark.parametrize("shape", [(466, 721), (721, 466), (826, 1287), (189, 124), (52, 67),
                                   (9, 11), (7, 5), (1, 3)])
def test_cluster_geometry_matches_python_mirror(host_lib, shape):
    """The cluster bodies' C launch geometry equals its Python mirror, and
    the bands cover every row block once. Their swap plan for the
    distance-5 offsets and the doubling ladder takes consecutive groups over
    every round, each tile region within a CTA's shared memory, each group
    of several rounds with a tile; floor126's distance-5 offsets are one
    group."""
    out = (ctypes.c_int * 8)()
    geo = fdm_cuda.cluster_geometry(shape)
    assert host_lib.fdm_cluster_geometry(*shape, out) == 0
    assert list(out) == [geo.cluster, geo.band_blocks, geo.threads, geo.slots, geo.smem,
                         geo.row_blocks, geo.step_b, geo.step_x]
    assert 1 <= geo.cluster <= fdm_cuda.CLUSTER_MAX and geo.threads <= fdm_cuda.CLUSTER_THREADS
    assert (geo.cluster - 1) * geo.band_blocks < geo.row_blocks <= geo.cluster * geo.band_blocks
    assert geo.threads * geo.slots >= geo.band_blocks * shape[1]
    for offsets in (convection._offset_schedule(5, *shape),
                    convection._offset_schedule(-1, *shape)[:32]):
        plan = fdm_cuda.swap_plan(shape, tuple(offsets), host_lib)
        assert [g.r0 for g in plan.groups] == [0] + [g.r1 for g in plan.groups[:-1]]
        assert plan.groups[-1].r1 == len(offsets)
        for g in plan.groups:
            assert g.tw > 0 or g.r1 == g.r0 + 1
            if g.tw > 0:
                region = (g.th + 2 * g.hy) * (g.tw + 2 * g.hx)
                assert 0 < 8 * region <= plan.smem <= fdm_cuda.SMEM_BUDGET
    if shape == (466, 721):
        plan = fdm_cuda.swap_plan(shape, tuple(convection._offset_schedule(5, *shape)), host_lib)
        assert len(plan.groups) == 1


@pytest.mark.parametrize("conv_kind", [None, "mix32", "words"])
def test_cheby_body_equals_plain_sb1(host_lib, envs, conv_kind):
    """K1 and K4 (E = 1, 2 and 4, the most it takes; B = 5 leaves a partial
    block) with statistics, bitwise against the plain versions and K4
    against K1 env for env; K1 also with a capped limit."""
    env = envs["sb1"]
    inp, conv = _inputs(env, 5, seed=3, conv_kind=conv_kind)
    solo, want = _run(host_lib, "fdm_cheby", env, inp, conv, env._stats, 100)
    _equal(solo, want)
    assert bool(solo[2].all())
    for e in (1, 2, fdm_cuda.cheby_max_envs(env.geom.shape)):
        got, want = _run(host_lib, "fdm_cheby_block", env, inp, conv, env._stats, 100, e)
        _equal(got, want)
        _equal(got, solo)
    capped, want = _run(host_lib, "fdm_cheby", env, inp, conv, None, 3)
    _equal(capped, want)
    assert not bool(capped[2].any())


def test_jacobi_kernels_equal_plain_sb1(host_lib, envs):
    """K2 and K3 share the source: both still equal their plain versions."""
    env = envs["sb1"]
    inp, conv = _inputs(env, 3, seed=4, conv_kind="mix32")
    got, want = _run(host_lib, "fdm_jacobi", env, inp, conv, env._stats, 100)
    _equal(got, want)
    got, want = _run(host_lib, "fdm_jacobi_block", env, inp, conv, env._stats, 100, 2)
    _equal(got, want)


@pytest.mark.parametrize("conv_kind", [None, "mix32", "words"])
def test_jacobi_body_equals_plain(host_lib, envs, conv_kind):
    """K2 and K3 (E = 1, 2 and 4, the most it takes; B = 5 leaves a partial
    block) with statistics, bitwise against the plain versions and K3
    against K2 env for env; both also with a capped limit, where no env
    converges. On the 9 x 11 grid (64 threads a block: the host threads
    meet at every iteration's barrier), whose columns end in a short run
    and whose planes are not a multiple of 16 bytes."""
    env = envs["small"]
    inp, conv = _inputs(env, 5, seed=6, conv_kind=conv_kind)
    solo, want = _run(host_lib, "fdm_jacobi", env, inp, conv, env._stats, 100)
    _equal(solo, want)
    assert bool(solo[2].all())
    for e in (1, 2, fdm_cuda.jacobi_max_envs(env.geom.shape)):
        got, want = _run(host_lib, "fdm_jacobi_block", env, inp, conv, env._stats, 100, e)
        _equal(got, want)
        _equal(got, solo)
    for kernel, e in (("fdm_jacobi", None), ("fdm_jacobi_block", 2)):
        capped, want = _run(host_lib, kernel, env, inp, conv, None, 3, e)
        _equal(capped, want)
        assert not bool(capped[2].any())


@pytest.mark.parametrize("kernel,e", [("fdm_jacobi", None), ("fdm_jacobi_block", 1),
                                      ("fdm_jacobi_block", 2)])
def test_nan_env_follows_each_stopping_rule(host_lib, envs, kernel, e):
    """One env's temp holds a NaN: its residual is NaN from the first
    iteration, so K2 stops it at iteration 1 (the solo rule) and K3 runs it
    to the limit (the block rule), each as its plain version does; the
    other envs are untouched."""
    env = envs["sb1"]
    inp, conv = _inputs(env, 3, seed=8, conv_kind="mix32")
    temp = inp.temp.clone()
    temp[1, 20, 30] = float("nan")
    inp = dataclasses.replace(inp, temp=temp)
    got, want = _run(host_lib, kernel, env, inp, conv, env._stats, 12, e)
    _equal(got, want)
    assert int(got[1][1]) == (1 if kernel == "fdm_jacobi" else 12)
    assert not bool(got[2][1]) and bool(torch.isnan(got[0][1]).any())
    assert not bool(torch.isnan(got[0][0]).any())


def _planes(h, w, batch, seed, device="cpu", edge_fill=True):
    """Kernel inputs on an (h, w) grid without a building: random stencils
    whose denominators dominate, so Jacobi converges; with edge fill, or
    (edge_fill False) a ring exterior whose pin is folded into the
    coefficients as kernel_inputs folds it, the stencil reads wrapping."""
    rs = np.random.default_rng(seed)
    f = lambda *s: torch.as_tensor(rs.uniform(0.0, 1.0, s).astype(np.float32), device=device)
    a = [f(h, w) for _ in range(4)]
    ext = torch.zeros(h, w, device=device)
    ext[0, :] = ext[-1, :] = ext[:, 0] = ext[:, -1] = 1.0
    denom = (sum(a) + 0.5 + f(batch, h, w)).contiguous()
    const, tinf = 300.0 * f(batch, h, w), 280.0 + f(batch)
    if not edge_fill:
        pin = ext > 0
        a = [torch.where(pin, 0.0, x).contiguous() for x in a]
        denom = torch.where(pin, 1.0, denom).contiguous()
        const = torch.where(pin, tinf.view(-1, 1, 1), const).contiguous()
    return fdm_cuda.KernelInputs(
        temp=(294.0 + 4.0 * f(batch, h, w)).contiguous(), const=const, denom=denom,
        tinf=tinf, a_r=a[0], a_l=a[1], a_b=a[2], a_t=a[3], ext=ext, edge_fill=edge_fill,
        coef=fdm_cuda.packed_coef(*a))


def test_grid_too_large_for_a_block_is_refused(host_lib):
    """8 x 3,200 cells (25,600) do not fit one env's two planes, exterior
    bits and decision bytes in a block's shared memory: no longer refused,
    each kernel runs its cluster body (2 CTAs of 800 threads an env) with
    the card's budget, bitwise its plain version, and counts the launch as
    the cluster body's; 126 rooms (189 x 124) still run unstaged in a
    block."""
    h, w = 8, 3200
    assert fdm_cuda.spans_blocks((h, w)) and fdm_cuda.cluster_geometry((h, w)).cluster == 2
    inp = _planes(h, w, 2, seed=11)
    for kernel, e in (("fdm_jacobi", None), ("fdm_jacobi_block", 1), ("fdm_cheby", None),
                      ("fdm_cheby_block", 1)):
        body = "fdm_cheby_cluster" if kernel.startswith("fdm_cheby") else "fdm_jacobi_cluster"
        before = dict(fdm_cuda.launch_counts)
        args = [0.1, 40] if "jacobi" in kernel else fdm_cuda._cheby_args(0.1, 40, 0.9, 2)
        got = fdm_cuda._launch(kernel, inp, None, None, args, e, lib=host_lib)
        kw = dict(threshold=0.1, iteration_limit=40)
        if "cheby" in kernel:
            kw.update(spectral_radius=0.9, check_every=2)
        if e is not None:
            kw.update(block_envs=e)
        _equal(got, getattr(fdm_cuda, f"{kernel}_plain")(inp, **kw))
        assert fdm_cuda.launch_counts == dict(before, **{body: before[body] + 1})
    assert fdm_cuda.jacobi_geometry((189, 124), 1) is not None


def _meta(batch, h, w):
    """Kernel inputs that hold no memory: only the checks before a launch
    can see them."""
    f = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    return fdm_cuda.KernelInputs(
        temp=f(batch, h, w), const=f(batch, h, w), denom=f(batch, h, w), tinf=f(batch),
        a_r=f(h, w), a_l=f(h, w), a_b=f(h, w), a_t=f(h, w), ext=f(h, w), edge_fill=True,
        coef=f(h, w, 4))


@pytest.mark.parametrize("batch,h,w,match", [
    (12000, 466, 721, "more than the card's 80000000000 B"),
    (1, 46341, 46341, "overflow the kernels' 32-bit cell index"),
])
def test_what_the_card_cannot_hold_is_refused(host_lib, batch, h, w, match):
    """12,000 envs of floor126's 466 x 721 plan need ~96.8 GB for the
    solve's planes, more than the card's 80 GB; a 46,341 x 46,341 plan has
    more cells than a 32-bit index holds. Both are refused with the bytes
    named, before any allocation or launch, by every kernel."""
    inp = _meta(batch, h, w)
    for kernel, e in (("fdm_jacobi", None), ("fdm_jacobi_block", 1), ("fdm_cheby", None),
                      ("fdm_cheby_block", 1)):
        before = dict(fdm_cuda.launch_counts)
        with pytest.raises(ValueError, match=match):
            fdm_cuda._launch(kernel, inp, None, None, [0.1, 5], e, lib=host_lib)
        assert fdm_cuda.launch_counts == before


CLUSTER_CASES = [("fdm_cheby", None), ("fdm_cheby_block", 1), ("fdm_jacobi", None),
                 ("fdm_jacobi_block", 1)]
# Swap schedules beside the envs' own: on the 9 x 11 grid one group whose
# halo tiles (12 x 13 cells) are larger than the grid; on the 52 x 67 grid
# (bands of 8 rows, rooms of 14 crossing them) sb1's 10 rounds are two
# groups and its first 8 one; the doubling ladder's 20 rounds on 2 x 2
# rooms of 24 cells (57 x 57, bands of 8 rows) eight, the two (16, 0)
# rounds too wide for any tile, each with pairs in the rooms.
SCHEDULES = {
    "wrap": dict(distance=5, schedule=((1, 0, 0), (1, 0, 1), (2, 0, 0), (0, 1, 1))),
    "one": dict(distance=5, rounds=8, seed=101),
    "ladder": dict(distance=-1),
}


def _buckets(env, schedule):
    if schedule is None:
        return None
    return convection.make_convection_buckets(env.geom, 1.0, **SCHEDULES[schedule])


def _chunk_plan(host_lib, shape, check_every):
    """The chunk plan the library plans for a launch (fdm_cluster_chunk_plan),
    as fdm_cuda.chunk_plan gives it (None: the chunks stream)."""
    out = (ctypes.c_int * 4)()
    assert host_lib.fdm_cluster_chunk_plan(*shape, check_every, out) == 0
    return fdm_cuda.ChunkPlan(*out) if out[2] > 0 else None


def _barriers_per_solve(host_lib, kernel, shape, conv, iters, check_every):
    """The cluster barriers and the tiled sub-iterations of each env's
    solve: one an iteration, or with chunk passes one a chunk of
    `check_every` (each env's tiled sub-iterations, all but x1 = J(x0)), and
    J(x_f) (Chebyshev) and one between two groups of the swap plan."""
    groups = len(fdm_cuda.swap_plan(shape, conv.offsets, host_lib).groups) if conv else 1
    cheby = kernel.startswith("fdm_cheby")
    iters = iters.to(torch.int32)
    tiled = iters - 1 if cheby and _chunk_plan(host_lib, shape, check_every) else 0 * iters
    return iters - tiled + tiled // check_every + groups - 1 + int(cheby), tiled


def _check_cluster(host_lib, env, kernel, e, inp, conv, batch, check_every=4, limit=100,
                   converged=True):
    """The cluster body bitwise its plain version (every env converged, or
    with `converged` False none), each env's barriers and tiled
    sub-iterations those of its iterations and of the plans, and the swap
    plan's groups counted once for the launch."""
    barriers = torch.full((batch,), -1, dtype=torch.int32)
    tiled = torch.full((batch,), -1, dtype=torch.int32)
    groups = dict(fdm_cuda.swap_counts)
    got, want = _run(host_lib, kernel, env, inp, conv, None if env is None else env._stats,
                     limit, e, budget=0, barriers=barriers, tiled=tiled,
                     check_every=check_every)
    _equal(got, want)
    if converged is not None:
        assert bool(got[2].all()) if converged else not bool(got[2].any())
    shape = tuple(inp.temp.shape[1:])
    want_barriers, want_tiled = _barriers_per_solve(host_lib, kernel, shape, conv, got[1],
                                                    check_every)
    assert torch.equal(barriers, want_barriers)
    assert torch.equal(tiled, want_tiled)
    plan = fdm_cuda.swap_plan(shape, conv.offsets, host_lib).groups if conv else ()
    assert fdm_cuda.swap_counts["swap_groups"] == groups["swap_groups"] + len(plan)
    return got


@pytest.mark.parametrize("kernel,e,conv_kind,schedule", [
    pytest.param(k, e, kind, None, id=f"{k}-{e}-{kind}")
    for kind in (None, "mix32", "words") for k, e in CLUSTER_CASES] + [
    pytest.param(k, e, kind, "wrap", id=f"{k}-{e}-{kind}-wrap")
    for kind in ("mix32", "words") for k, e in CLUSTER_CASES])
def test_cluster_body_equals_plain(host_lib, envs, kernel, e, conv_kind, schedule):
    """Each kernel's cluster body, forced by a budget of 0 B, on the 9 x 11
    grid (3 CTAs of 32 threads an env: bands of one row block, the last a
    run of one cell), B = 5 with statistics (the fold of the output), and
    with a capped limit where no env converges: bitwise the plain version,
    and each env's barrier count that of the body's passes and its swap
    plan's groups; with the "wrap" schedule one group whose tile region
    wraps round the grid both ways."""
    env = envs["small"]
    inp, conv = _inputs(env, 5, seed=21, conv_kind=conv_kind, buckets=_buckets(env, schedule))
    if schedule == "wrap":
        (group,) = fdm_cuda.swap_plan(env.geom.shape, conv.offsets, host_lib).groups
        assert group.th + 2 * group.hy > 9 and group.tw + 2 * group.hx > 11
    _check_cluster(host_lib, env, kernel, e, inp, conv, 5)
    # Capped: Chebyshev at J(x0) alone, Jacobi after 3 iterations.
    limit = 1 if kernel.startswith("fdm_cheby") else 3
    capped, want = _run(host_lib, kernel, env, inp, conv, None, limit, e, budget=0)
    _equal(capped, want)
    assert not bool(capped[2].any())


@pytest.mark.parametrize("kernel,e,conv_kind,schedule", [
    pytest.param(k, e, "mix32", None, id=f"{k}-{e}") for k, e in CLUSTER_CASES] + [
    pytest.param(k, e, kind, schedule, id=f"{k}-{e}-{schedule or 'sb1'}-{kind}")
    for schedule, kind in ((None, "words"), ("one", "mix32"), ("one", "words"),
                           ("ladder", "mix32"), ("ladder", "words"))
    for k, e in CLUSTER_CASES])
def test_cluster_body_equals_plain_sb1(host_lib, envs, kernel, e, conv_kind, schedule):
    """The cluster bodies on the 12-zone sb1 grid (7 CTAs of 160 threads an
    env: bands of two row blocks over 67 columns, which the rooms cross),
    B = 2, Chebyshev sampled every sub-iteration: bitwise the plain
    versions, with mix32 rounds and the threefry word plane, under sb1's
    schedule (two groups) and its first 8 rounds (one group), and the
    doubling ladder on larger rooms (eight groups, two rounds too wide for
    any tile); each env's barriers those its plan predicts."""
    env = envs["rooms24" if schedule == "ladder" else "sb1"]
    buckets = _buckets(env, schedule)
    inp, conv = _inputs(env, 2, seed=22, conv_kind=conv_kind, buckets=buckets)
    groups = fdm_cuda.swap_plan(env.geom.shape, conv.offsets, host_lib).groups
    assert len(groups) == {None: 2, "one": 1, "ladder": 8}[schedule]
    wide = [g.r0 for g in groups if g.tw == 0]
    assert len(wide) == (2 if schedule == "ladder" else 0)
    assert all(buckets.lead_masks[r].any() for r in wide)
    _check_cluster(host_lib, env, kernel, e, inp, conv, 2, check_every=1)


CHUNK_CASES = [("fdm_cheby", None), ("fdm_cheby_block", 1)]
CHECK_EVERY = (1, 2, 4, 5)


@pytest.mark.parametrize("shape", [(466, 721), (721, 466), (826, 1287), (52, 67), (57, 57),
                                   (9, 11), (8, 3200), (7, 5), (1, 3)])
def test_chunk_plan_matches_python_mirror(host_lib, shape):
    """The chunk plan the library plans at launch equals fdm_cuda.chunk_plan
    for check_every 1-8: none at 1, else a tile of halo check_every whose
    region fits a CTA's tile memory; floor126's at 4 is six tiles of 60 x
    121 a band."""
    for ce in range(1, 9):
        plan = fdm_cuda.chunk_plan(shape, ce)
        assert _chunk_plan(host_lib, shape, ce) == plan
        assert (plan is None) if ce == 1 else plan is not None
        if plan is not None:
            r, c = plan.th + 2 * ce, plan.tw + 2 * ce
            assert plan.halo == ce and plan.smem == (
                fdm_cuda.CHUNK_CELL_BYTES * r * c + fdm_cuda.CHUNK_LINE_BYTES * (r + c))
            assert plan.smem <= fdm_cuda.TILE_BYTES
    if shape == (466, 721):
        assert fdm_cuda.chunk_plan(shape, 4) == fdm_cuda.ChunkPlan(4, 60, 121, 150109)


def _capped_iters(limit, check_every):
    """A Chebyshev count at `limit`: x1, then whole chunks while below it."""
    return 1 + check_every * -(-(limit - 1) // check_every)


@pytest.mark.parametrize("check_every", CHECK_EVERY)
@pytest.mark.parametrize("kernel,e", CHUNK_CASES)
def test_chunk_passes_equal_plain(host_lib, envs, kernel, e, check_every):
    """K1's and K4's (E = 1) cluster body on the 9 x 11 grid (3 CTAs of
    32 threads, bands of one row block), B = 5 with mix32 rounds, at
    check_every 1 (the chunks stream) and 2, 4, 5 (chunk passes, their tile
    region of 4 + 2 ce rows and 11 + 2 ce columns wider than the grid, from
    4 on taller too, so it holds cells twice round the torus): bitwise the plain version, each
    env's barriers one a chunk pass and its tiled sub-iterations all but x1
    = J(x0); capped at a limit of 3, inside the first chunk, which runs to
    its end as in the plain version (some envs converge there from 4 on)."""
    env = envs["small"]
    inp, conv = _inputs(env, 5, seed=25, conv_kind="mix32")
    plan = _chunk_plan(host_lib, env.geom.shape, check_every)
    assert (plan is None) == (check_every == 1)
    if plan is not None:  # wider than the grid; from 4 on taller too
        assert plan.tw + 2 * check_every > 11
        assert (plan.th + 2 * check_every > 9) == (check_every >= 4)
    _check_cluster(host_lib, env, kernel, e, inp, conv, 5, check_every=check_every)
    capped = _check_cluster(host_lib, env, kernel, e, inp, conv, 5, check_every=check_every,
                            limit=3, converged=None)
    assert bool((capped[1] == _capped_iters(3, check_every)).all())


@pytest.mark.parametrize("check_every", CHECK_EVERY)
@pytest.mark.parametrize("kernel,e,conv_kind", [("fdm_cheby", None, "mix32"),
                                                ("fdm_cheby", None, "words"),
                                                ("fdm_cheby_block", 1, "words")])
def test_chunk_passes_equal_plain_sb1(host_lib, envs, kernel, e, conv_kind, check_every):
    """On the 12-zone sb1 grid (7 CTAs of 160 threads, bands of 8 rows
    over 67 columns, a ring exterior whose reads wrap), B = 2, under sb1's
    mix32 rounds and the threefry word plane: each band one tile whose halo
    reaches into both neighbouring bands (round the torus at the first and
    the last), bitwise the plain version with the barriers and tiled
    sub-iterations its plans predict."""
    env = envs["sb1"]
    inp, conv = _inputs(env, 2, seed=26, conv_kind=conv_kind)
    plan = _chunk_plan(host_lib, env.geom.shape, check_every)
    assert plan is None if check_every == 1 else (plan.th, plan.tw) == (8, 67)
    _check_cluster(host_lib, env, kernel, e, inp, conv, 2, check_every=check_every)


@pytest.mark.parametrize("check_every", (2, 4, 5))
@pytest.mark.parametrize("edge_fill", [True, False], ids=["edge", "wrap"])
def test_chunk_passes_with_several_tiles_a_band(host_lib, edge_fill, check_every):
    """8 x 3,200 cells (2 CTAs of 800 threads, bands of 4 rows), B = 2, no
    rounds: each band three to five tiles whose halos cross the other band
    and, with edge fill, reach off the grid (t_inf there), or with a ring
    exterior wrap round it; K1's cluster body bitwise its plain version,
    with the barriers and tiled sub-iterations its plan predicts, converged
    or capped at the limit of 40 alike."""
    inp = _planes(8, 3200, 2, seed=27, edge_fill=edge_fill)
    plan = _chunk_plan(host_lib, (8, 3200), check_every)
    assert plan.th == 4 and 3 <= -(-3200 // plan.tw) <= 5
    _check_cluster(host_lib, None, "fdm_cheby", None, inp, None, 2, check_every=check_every,
                   limit=40, converged=None)


@pytest.mark.parametrize("check_every", (1, 4))
@pytest.mark.parametrize("kernel,e", CHUNK_CASES)
def test_nan_env_runs_to_the_limit_under_the_chebyshev_cluster_body(host_lib, envs, kernel, e,
                                                                      check_every):
    """A NaN in one env's temp: its residual is NaN at every sample, so it
    never converges and runs whole chunks to the limit, streamed or in
    chunk passes, as the plain version does; the other envs are
    untouched."""
    env = envs["small"]
    inp, conv = _inputs(env, 3, seed=28, conv_kind="mix32")
    temp = inp.temp.clone()
    temp[1, 4, 5] = float("nan")
    inp = dataclasses.replace(inp, temp=temp)
    got = _check_cluster(host_lib, env, kernel, e, inp, conv, 3, check_every=check_every,
                         limit=12, converged=None)
    assert int(got[1][1]) == _capped_iters(12, check_every)
    assert not bool(got[2][1]) and bool(torch.isnan(got[0][1]).any())
    assert not bool(torch.isnan(got[0][0]).any())


@pytest.mark.parametrize("kernel,e", [("fdm_jacobi", None), ("fdm_jacobi_block", 1)])
def test_nan_env_follows_each_stopping_rule_on_a_cluster(host_lib, envs, kernel, e):
    """A NaN in one env's temp: its cluster residual is NaN, so K2's body
    stops it at iteration 1 and K3's runs it to the limit, as the plain
    versions do; the other envs are untouched."""
    env = envs["small"]
    inp, conv = _inputs(env, 3, seed=23, conv_kind="mix32")
    temp = inp.temp.clone()
    temp[1, 4, 5] = float("nan")
    inp = dataclasses.replace(inp, temp=temp)
    got, want = _run(host_lib, kernel, env, inp, conv, env._stats, 12, e, budget=0)
    _equal(got, want)
    assert int(got[1][1]) == (1 if kernel == "fdm_jacobi" else 12)
    assert not bool(got[2][1]) and bool(torch.isnan(got[0][1]).any())
    assert not bool(torch.isnan(got[0][0]).any())


@pytest.mark.parametrize("kernel,e", [("fdm_cheby", None), ("fdm_cheby_block", 4),
                                      ("fdm_cheby_block", 3), ("fdm_jacobi", None),
                                      ("fdm_jacobi_block", 3)])
def test_ragged_grid_equals_plain(host_lib, envs, kernel, e):
    """A 9 x 11 grid: columns end in a run of 1 cell and a plane is not a
    multiple of 16 bytes, so the threads copy what the bulk engine cannot;
    B = 13 with mix32 swap rounds."""
    env = envs["small"]
    inp, conv = _inputs(env, 13, seed=5, conv_kind="mix32")
    got, want = _run(host_lib, kernel, env, inp, conv, None, 100, e)
    _equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_a_wrong_barrier_tensor_is_refused(host_lib, envs, bad):
    """The barrier counts' tensor is checked before its pointer reaches a
    kernel: int32 and one entry per env."""
    env = envs["small"]
    inp, conv = _inputs(env, 3, seed=24, conv_kind="mix32")
    barriers = (torch.zeros(3, dtype=torch.int64) if bad == "dtype"
                else torch.zeros(2, dtype=torch.int32))
    before = dict(fdm_cuda.launch_counts)
    with pytest.raises(ValueError, match="barriers must be"):
        _run(host_lib, "fdm_jacobi", env, inp, conv, None, 5, budget=0, barriers=barriers)
    assert fdm_cuda.launch_counts == before

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
stopping rule; a grid too large for a block is refused before launch. It shows logic faults (ownership, parity, freezing, counts,
the swap rounds' decision bytes), not races or the card's timing. The test
skips where there is no g++ and takes well under a minute.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

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
    return {"sb1": sb1, "small": small}


def _inputs(env, batch, seed, conv_kind):
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
    buckets = dataclasses.replace(env.convection, enabled=True,
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


def _run(host_lib, name, env, inp, conv, stats, limit, e=None):
    """The kernel through the host library, and its plain version."""
    kw = dict(threshold=0.1, iteration_limit=limit, conv=conv, stats=stats)
    args = [0.1, limit]
    if name.startswith("fdm_cheby"):
        kw.update(spectral_radius=env._spectral_radius, check_every=4)
        args = fdm_cuda._cheby_args(0.1, limit, env._spectral_radius, 4)
    if e is not None:
        kw.update(block_envs=e)
    got = fdm_cuda._launch(name, inp, conv, stats, args, e, lib=host_lib)
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


def test_grid_too_large_for_a_block_is_refused(host_lib):
    """160 x 170 cells fit two planes in shared memory but not with the
    exterior bits and the decision bytes: refused with the limit named,
    before any launch; 126 rooms (189 x 124) still run unstaged."""
    h, w = 160, 170
    f = lambda *s: torch.ones(s, dtype=torch.float32)
    inp = fdm_cuda.KernelInputs(
        temp=f(1, h, w), const=f(1, h, w), denom=f(1, h, w), tinf=f(1), a_r=f(h, w),
        a_l=f(h, w), a_b=f(h, w), a_t=f(h, w), ext=f(h, w), edge_fill=True,
        coef=f(h, w, 4))
    for kernel, e in (("fdm_jacobi", None), ("fdm_jacobi_block", 1), ("fdm_cheby", None)):
        before = dict(fdm_cuda.launch_counts)
        with pytest.raises(ValueError, match="B a block may use"):
            fdm_cuda._launch(kernel, inp, None, None, [0.1, 5], e, lib=host_lib)
        assert fdm_cuda.launch_counts == before
    assert fdm_cuda.jacobi_geometry((189, 124), 1) is not None


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

"""The launch geometry of the Chebyshev body (K1, K4) on the CPU.

`fdm_cuda.cheby_geometry` and `fdm_cuda.run_neighbours` mirror the
kernel's launcher and its run cursor (csrc/fdm_kernels.cu; the host build
in tests/test_torch_kernel_host.py checks that the C launcher agrees).
Here: at the 12-zone (52 x 67), 126-room (189 x 124) and two-zone test
grids, every cell is owned by exactly one run of one thread; the
neighbours each owned cell reads give, gathered, the Jacobi update of
`jacobi_update` (its shifts with edge fill, its rolls without) bitwise;
and the shared memory of a block stays within what a block may use.
"""

import numpy as np
import pytest
import torch

from sbsim_tpu_torch.envs import building_env, presets
from sbsim_tpu_torch.physics import fdm_cuda

SHAPES = {
    "12zone": (52, 67),
    "126room": (189, 124),
    "two_zone": None,  # the grid of presets.two_zone_test_config
}


def _shape(name):
    if SHAPES[name] is not None:
        return SHAPES[name]
    env = building_env.BuildingEnv(presets.two_zone_test_config(), device="cpu")
    return env.geom.shape


def _launches(shape):
    """Every geometry the launcher takes on this grid: E = 1 .. the max."""
    return [fdm_cuda.cheby_geometry(shape, e)
            for e in range(1, fdm_cuda.cheby_max_envs(shape) + 1)]


@pytest.mark.parametrize("name", list(SHAPES))
def test_every_cell_owned_once(name):
    shape = _shape(name)
    geos = _launches(shape)
    assert geos and all(g is not None for g in geos)
    for geo in geos:
        owner, slot, _ = fdm_cuda.run_neighbours(shape, geo, edge_fill=False)
        assert (owner >= 0).all() and (owner < geo.threads).all()
        assert slot.max() < geo.slots
        assert geo.threads % 32 == 0 and geo.threads <= 1024
        assert geo.n_runs == -(-shape[0] // fdm_cuda.RUN) * shape[1]


@pytest.mark.parametrize("edge_fill", [False, True])
@pytest.mark.parametrize("name", list(SHAPES))
def test_neighbours_give_jacobi_update(name, edge_fill):
    shape = _shape(name)
    h, w = shape
    rs = np.random.default_rng(7)
    b = 3
    f = lambda *s: torch.as_tensor(rs.uniform(0.5, 2.0, s).astype(np.float32))
    inp = fdm_cuda.KernelInputs(
        temp=f(b, h, w) * 150.0, const=f(b, h, w), denom=f(b, h, w) * 4.0,
        tinf=f(b) * 140.0, a_r=f(h, w), a_l=f(h, w), a_b=f(h, w), a_t=f(h, w),
        ext=torch.as_tensor((rs.uniform(size=(h, w)) < 0.2).astype(np.float32)),
        edge_fill=edge_fill)
    want = fdm_cuda.jacobi_update(inp.temp, inp)
    geo = fdm_cuda.cheby_geometry(shape, 1)
    _, _, nb = fdm_cuda.run_neighbours(shape, geo, edge_fill)
    x = inp.temp.reshape(b, -1)
    fill = inp.tinf.view(-1, 1)

    def read(k):
        idx = torch.as_tensor(nb[k])
        assert bool((idx >= -1).all())
        return torch.where(idx < 0, fill, x[:, idx.clamp(min=0)]).view(b, h, w)

    num = (inp.a_r * read("r") + inp.a_l * read("l") + inp.a_b * read("b")
           + inp.a_t * read("t") + inp.const)
    got = num / inp.denom
    if edge_fill:
        got = torch.where(inp.ext > 0, inp.tinf.view(-1, 1, 1), got)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(SHAPES))
def test_shared_memory_within_a_block(name):
    shape = _shape(name)
    for geo in _launches(shape):
        assert geo.smem + fdm_cuda.CHEBY_STATIC_SMEM <= fdm_cuda.SMEM_PER_BLOCK
    assert fdm_cuda.cheby_geometry(shape, fdm_cuda.cheby_max_envs(shape) + 1) is None


def test_sb1_launch_choices():
    """12 zones stage const/denom for up to 4 envs per block (the config's
    E runs at the measured best, 1); 126 rooms take one env per block
    reading them from global memory; K3 keeps its own clamp."""
    assert fdm_cuda.cheby_max_envs((52, 67)) == 4
    assert fdm_cuda.effective_block_envs((52, 67), 8, cheby=True) == 1
    assert fdm_cuda.effective_block_envs((52, 67), 8) == 8
    assert fdm_cuda.effective_block_envs((189, 124), 4, cheby=True) == 1
    one = fdm_cuda.cheby_geometry((52, 67), 1)
    assert one.staged and one.threads == 448 and one.slots == 2
    big = fdm_cuda.cheby_geometry((189, 124), 1)
    assert not big.staged and big.threads <= 1024 and big.slots == 6

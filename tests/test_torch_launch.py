"""The launch geometry of both kernel bodies (Chebyshev: K1, K4; Jacobi:
K2, K3) on the CPU.

`fdm_cuda.cheby_geometry`, `fdm_cuda.jacobi_geometry` and
`fdm_cuda.run_neighbours` mirror the kernels' launchers and their run
cursor (csrc/fdm_kernels.cu; the host build in
tests/test_torch_kernel_host.py checks that the C launchers agree). Here:
at the 12-zone (52 x 67), 126-room (189 x 124) and two-zone test grids,
for each body, every cell is owned by exactly one run of one thread; the
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


BODIES = {"cheby": (fdm_cuda.cheby_geometry, fdm_cuda.cheby_max_envs),
          "jacobi": (fdm_cuda.jacobi_geometry, fdm_cuda.jacobi_max_envs)}


def _launches(shape, body="cheby"):
    """Every geometry a body's launcher takes on this grid: E = 1 .. the
    max."""
    geometry, max_envs = BODIES[body]
    return [geometry(shape, e) for e in range(1, max_envs(shape) + 1)]


@pytest.mark.parametrize("body", ["cheby", "jacobi"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_every_cell_owned_once(name, body):
    shape = _shape(name)
    geos = _launches(shape, body)
    assert geos and all(g is not None for g in geos)
    for geo in geos:
        owner, slot, _ = fdm_cuda.run_neighbours(shape, geo, edge_fill=False)
        assert (owner >= 0).all() and (owner < geo.threads).all()
        assert slot.max() < geo.slots
        assert geo.threads % 32 == 0 and geo.threads <= 1024
        assert geo.n_runs == -(-shape[0] // fdm_cuda.RUN) * shape[1]


@pytest.mark.parametrize("body", ["cheby", "jacobi"])
@pytest.mark.parametrize("edge_fill", [False, True])
@pytest.mark.parametrize("name", list(SHAPES))
def test_neighbours_give_jacobi_update(name, edge_fill, body):
    shape = _shape(name)
    h, w = shape
    rs = np.random.default_rng(7)
    b = 3
    f = lambda *s: torch.as_tensor(rs.uniform(0.5, 2.0, s).astype(np.float32))
    temp, const, denom, tinf = f(b, h, w) * 150.0, f(b, h, w), f(b, h, w) * 4.0, f(b) * 140.0
    a = [f(h, w) for _ in range(4)]
    inp = fdm_cuda.KernelInputs(
        temp=temp, const=const, denom=denom, tinf=tinf, a_r=a[0], a_l=a[1], a_b=a[2],
        a_t=a[3], ext=torch.as_tensor((rs.uniform(size=(h, w)) < 0.2).astype(np.float32)),
        edge_fill=edge_fill, coef=fdm_cuda.packed_coef(*a))
    want = fdm_cuda.jacobi_update(inp.temp, inp)
    geo = BODIES[body][0](shape, 1)
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


@pytest.mark.parametrize("body", ["cheby", "jacobi"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_shared_memory_within_a_block(name, body):
    """Every launch fits, the static scratch included; at 126 rooms the
    one unstaged env per block carries the decision byte plane too."""
    shape = _shape(name)
    geometry, max_envs = BODIES[body]
    plane = -(-shape[0] * shape[1] // 4) * 16
    for e, geo in enumerate(_launches(shape, body), start=1):
        assert geo.smem + fdm_cuda.STATIC_SMEM <= fdm_cuda.SMEM_PER_BLOCK
        dec = 0 if geo.staged else shape[0] * shape[1]
        assert geo.smem >= e * (4 if geo.staged else 2) * plane + geo.n_runs + dec
    assert geometry(shape, max_envs(shape) + 1) is None


def test_sb1_launch_choices():
    """12 zones stage const/denom for up to 4 envs per block (the config's
    E runs at each body's measured best); 126 rooms take one env per block
    reading them from global memory."""
    assert fdm_cuda.cheby_max_envs((52, 67)) == 4
    assert fdm_cuda.jacobi_max_envs((52, 67)) == 4
    assert fdm_cuda.jacobi_max_envs((189, 124)) == 1
    assert fdm_cuda.effective_block_envs((52, 67), 8, cheby=True) == fdm_cuda.CHEBY_BEST_ENVS
    assert fdm_cuda.effective_block_envs((52, 67), 8) == fdm_cuda.JACOBI_BEST_ENVS
    assert fdm_cuda.effective_block_envs((189, 124), 4, cheby=True) == 1
    assert fdm_cuda.effective_block_envs((189, 124), 4) == 1
    assert not fdm_cuda.jacobi_geometry((189, 124), 1).staged
    one = fdm_cuda.cheby_geometry((52, 67), 1)
    assert one.staged and one.threads == 448 and one.slots == 2
    big = fdm_cuda.cheby_geometry((189, 124), 1)
    assert not big.staged and big.threads <= 1024 and big.slots == 6

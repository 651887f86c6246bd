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
and the shared memory of a block stays within what a block may use. And
the route `fdm_cuda.route` picks for sb1 envs of 12 to 132 zones, both
layouts, both convection methods and both word sources, and floor126's
plan above a block's shared memory (test_route_table).
"""

import functools

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
    """12 zones stage const/denom for up to 4 envs per block (the route
    runs E = 1, each body's measured best: test_route_table); 126 rooms
    take one env per block reading them from global memory."""
    assert fdm_cuda.cheby_max_envs((52, 67)) == 4
    assert fdm_cuda.jacobi_max_envs((52, 67)) == 4
    assert fdm_cuda.jacobi_max_envs((189, 124)) == 1
    assert not fdm_cuda.jacobi_geometry((189, 124), 1).staged
    one = fdm_cuda.cheby_geometry((52, 67), 1)
    assert one.staged and one.threads == 448 and one.slots == 2
    big = fdm_cuda.cheby_geometry((189, 124), 1)
    assert not big.staged and big.threads <= 1024 and big.slots == 6


# sb1 envs on the CPU: (floor plan (rooms x, rooms y, room cells) or None
# for the 12-zone office, EnvConfig changes, convection changes).
ROUTE_ENVS = {
    "12zone": (None, {}, {}),
    "12zone_solo": (None, dict(pallas_block_envs=1), {}),
    "12zone_stack": (None, dict(pallas_block_mode="stack"), {}),
    "12zone_threefry": (None, dict(pallas_block_mode="stack"), dict(rng="threefry")),
    "12zone_argsort": (None, dict(pallas_block_mode="stack"), dict(method="argsort")),
    "15zone": ((3, 5, 8), {}, {}),
    "126room": ((9, 14, 12), {}, {}),
    "126room_stack": ((9, 14, 12), dict(pallas_block_mode="stack"), {}),
    "126room_stack_zones": ((9, 14, 12), dict(pallas_block_mode="stack",
                                              kernel_stats_max_zones=1000), {}),
    "132room_stack_zones": ((11, 12, 6), dict(pallas_block_mode="stack",
                                              kernel_stats_max_zones=1000), {}),
    "floor126": ((9, 14, 50), {}, {}),
    "floor126_stack": ((9, 14, 50), dict(pallas_block_mode="stack", pallas_block_envs=4), {}),
}
# (env, solver): (requested E, wrapper, E, stopping rule, cluster, fuse_conv,
# kernel_stats, word source of the fused rounds).
ROUTE_TABLE = {
    ("12zone", "pallas_cheby"): (8, "fdm_cheby", 1, "chebyshev", False, True, False, "mix32"),
    ("12zone", "pallas_env"): (8, "fdm_jacobi", 1, "solo", False, True, True, "mix32"),
    ("12zone_solo", "pallas_cheby"): (1, "fdm_cheby", 1, "chebyshev", False, True, True, "mix32"),
    ("12zone_stack", "pallas_cheby"): (8, "fdm_cheby_block", 1, "chebyshev", False, True, True,
                                       "mix32"),
    ("12zone_stack", "pallas_env"): (8, "fdm_jacobi_block", 1, "block", False, True, True,
                                     "mix32"),
    ("12zone_threefry", "pallas_cheby"): (8, "fdm_cheby_block", 1, "chebyshev", False, True,
                                          True, "threefry"),
    ("12zone_threefry", "pallas_env"): (8, "fdm_jacobi_block", 1, "block", False, True, True,
                                        "threefry"),
    ("12zone_argsort", "pallas_cheby"): (8, "fdm_cheby_block", 1, "chebyshev", False, False,
                                         False, None),
    ("12zone_argsort", "pallas_env"): (8, "fdm_jacobi_block", 1, "block", False, False, False,
                                       None),
    ("15zone", "pallas_env"): (8, "fdm_jacobi", 1, "solo", False, True, False, "mix32"),
    ("126room", "pallas_cheby"): (4, "fdm_cheby", 1, "chebyshev", False, True, False, "mix32"),
    ("126room", "pallas_env"): (4, "fdm_jacobi", 1, "solo", False, True, False, "mix32"),
    ("126room_stack", "pallas_cheby"): (4, "fdm_cheby_block", 1, "chebyshev", False, True,
                                        False, "mix32"),
    ("126room_stack", "pallas_env"): (4, "fdm_jacobi_block", 1, "block", False, True, False,
                                      "mix32"),
    ("126room_stack_zones", "pallas_cheby"): (4, "fdm_cheby_block", 1, "chebyshev", False,
                                              True, True, "mix32"),
    ("132room_stack_zones", "pallas_env"): (4, "fdm_jacobi_block", 1, "block", False, True,
                                            False, "mix32"),
    ("floor126", "pallas_cheby"): (1, "fdm_cheby", 1, "chebyshev", True, True, False, "mix32"),
    ("floor126", "pallas_env"): (1, "fdm_jacobi", 1, "solo", True, True, False, "mix32"),
    ("floor126_stack", "pallas_cheby"): (4, "fdm_cheby_block", 1, "chebyshev", True, True,
                                         False, "mix32"),
    ("floor126_stack", "pallas_env"): (4, "fdm_jacobi_block", 1, "block", True, True, False,
                                       "mix32"),
}


@functools.lru_cache(maxsize=None)
def _route_env(name):
    import dataclasses

    from sbsim_tpu_torch.core import geometry

    plan, changes, conv = ROUTE_ENVS[name]
    kw = {} if plan is None else dict(
        floor_plan=geometry.make_synthetic_office_plan(*plan[:2], room_cvs=plan[2]),
        layout="auto")
    cfg = dataclasses.replace(presets.sb1_config(num_days_in_episode=1, **kw), **changes)
    cfg = dataclasses.replace(cfg, convection=dataclasses.replace(cfg.convection, **conv))
    return building_env.BuildingEnv(cfg, device="cpu")


@pytest.mark.parametrize("name,solver", list(ROUTE_TABLE))
def test_route_table(name, solver):
    """The route of each env and solver: the wrapper, the envs per thread
    block it takes (a requested E > 1 runs at 1, each body's measured best),
    its stopping rule, whether the plan spans thread blocks (the cluster
    bodies), whether the swap rounds fuse into the kernel, whether the
    statistics come from it (not the interleaved K1, not a cluster body,
    the final field in the kernel, at most kernel_stats_max_zones and 128
    zones) and where the rounds' words come from; kernel_path reads it."""
    want_e, kernel, e, rule, cluster, fuse, stats, words = ROUTE_TABLE[name, solver]
    env = _route_env(name)
    route = env.route(solver)
    assert env.config.pallas_block_envs == want_e
    assert (route.kernel, route.block_envs, route.rule, route.cluster) == (kernel, e, rule,
                                                                          cluster)
    assert cluster == fdm_cuda.spans_blocks(env.geom.shape)
    assert (route.fuse_conv, route.kernel_stats) == (fuse, stats) == env.kernel_path(solver)
    assert env.route(solver) is route
    if words is None:
        assert route.conv is None
    else:
        assert route.conv.lead is env._conv_lead and route.conv.foll is env._conv_foll
        assert (route.conv.word_params is None) == (words == "threefry")
        assert (route.words_of is env.convection) == (words == "threefry")


def test_launch_runs_on_the_inputs_device(monkeypatch):
    """_launch takes the stream and launches with the inputs' device made
    current (torch.cuda.device(inp.temp.device)), whichever device was
    current: here with the card's calls stood in for on CPU tensors."""
    env = building_env.BuildingEnv(presets.two_zone_test_config(), device="cpu")
    b, (h, w) = 2, env.geom.shape
    temp = torch.full((b, h, w), 294.0)
    inp = fdm_cuda.kernel_inputs(temp, torch.zeros_like(temp), torch.full((b,), 280.0),
                                 torch.full((b,), 100.0), env.coeffs)
    entered, seen = [], []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.append(None)

    class Stream:
        cuda_stream = 0

    class Lib:
        def fdm_jacobi_launch(self, *args):
            seen.append(list(entered))  # the guard is open while it launches
            return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: seen.append(("stream", list(entered))) or Stream())
    monkeypatch.setattr(fdm_cuda, "_check_inputs", lambda *a: temp.shape)
    monkeypatch.setattr(fdm_cuda, "_library", lambda: Lib())
    before = fdm_cuda.launch_counts["fdm_jacobi"]
    fdm_cuda._launch("fdm_jacobi", inp, None, None, [0.1, 10])
    assert seen == [("stream", [temp.device]), [temp.device]]
    assert entered == [temp.device, None]
    assert fdm_cuda.launch_counts["fdm_jacobi"] == before + 1
    fdm_cuda.launch_counts["fdm_jacobi"] = before


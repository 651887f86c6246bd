"""The draw kernel's source rehearsed on the CPU: csrc/rng_kernels.cu built
as host C++ with g++ against tests/rng_host_stub.h and bound with
`rng.bind`, launched through the port's own wrapper (`rng._launch(...,
lib=...)`) on CPU tensors.

Every draw kind must equal its plain version (the int64 twin that the CPU
runs) bitwise: keys 0 and 2**32 - 1 and words across the carries, the
call sites' shapes (split at 2, 3, 4 and n_envs; uniform at (B, 12, 1) and
(B, 126, 1) with and without bounds; normal at (256, 3); randint with a
device maxval of 1 and 50,000 and with hi <= lo), and keys read in place
through strided views. `normal` is held bitwise where the host's log1pf
equals torch.log1p (the card's log1pf is the card test's). Also the
dispatch rule (CPU keys run the plain versions, the wrapper refuses what
the kernel does not take) and the `rng.launches.*` counter. The build
takes about a second; the test skips where there is no g++.
"""

import ctypes
import ctypes.util
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sbsim_tpu_torch import graphs, rng

TESTS = os.path.dirname(os.path.abspath(__file__))
N_ENVS = (64, 2048)  # the train cell's and the rollout cells' batches


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source as host C++")
    path = str(tmp_path_factory.mktemp("rng_host") / "rng_kernels_host.so")
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
         "-DRNG_HOST_REHEARSAL", f"-I{TESTS}", "-x", "c++", rng.SOURCE, "-o", path],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return rng.bind(ctypes.CDLL(path))


def _keys(n, seed=0):
    """n keys: (0, 0), (2**32 - 1, 2**32 - 1), words at the carries, then
    random words."""
    rs = np.random.default_rng(seed)
    keys = rs.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.int64)
    edge = [(0, 0), (2**32 - 1, 2**32 - 1), (0, 2**32 - 1), (2**31, 2**31 - 1),
            (0xFFFF, 0x10000), (0x1BD11BDA, 0)]
    keys[:len(edge)] = edge[:n]
    return torch.as_tensor(keys)


def _bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("num", (2, 3, 4) + N_ENVS)
def test_split_equals_plain(host_lib, num):
    keys = _keys(9)
    _bitwise(rng._launch("split", keys, (num, 2), lib=host_lib), rng.split_plain(keys, num))


@pytest.mark.parametrize("data", [0, 1, 7, 2**31, 2**32 - 1, -1])
def test_fold_in_equals_plain(host_lib, data):
    keys = _keys(9)
    got = rng._launch("fold_in", keys, (2,), counter0=data & rng.MASK32, lib=host_lib)
    _bitwise(got, rng.fold_in_plain(keys, data))


@pytest.mark.parametrize("shape", [(1,), (12, 5), (2, 9, 11), (70_000,)])
def test_bits_equals_plain(host_lib, shape):
    """Counters up to 70,000 cross the low 16 bits' carry."""
    keys = _keys(3)
    _bitwise(rng._launch("bits", keys, shape, lib=host_lib), rng.bits_plain(keys, shape))


@pytest.mark.parametrize("shape", [(12, 1), (126, 1)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.1, 0.1), (2.0, 3.5), (-1.0, -1.0)])
def test_uniform_equals_plain(host_lib, shape, bounds):
    keys = _keys(N_ENVS[0])
    got = rng._launch("uniform", keys, shape, lo=bounds[0], hi=bounds[1], lib=host_lib)
    _bitwise(got, rng.uniform_plain(keys, shape, *bounds))


def test_normal_equals_plain_where_log1p_agrees(host_lib):
    """(256, 3) normals for each of 8 keys: bitwise wherever the host's
    log1pf and torch.log1p agree on -u * u (most words), which decides every
    other operation of the polynomial."""
    keys = _keys(8)
    got = rng._launch("normal", keys, (256, 3), lo=rng.NORMAL_LO, hi=1.0, lib=host_lib)
    want = rng.normal_plain(keys, (256, 3))
    u = rng.uniform_from_bits(rng.bits_plain(keys, (256, 3)), rng.NORMAL_LO, 1.0)
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.log1pf.argtypes, libm.log1pf.restype = [ctypes.c_float], ctypes.c_float
    arg = -u * u
    host = torch.tensor([libm.log1pf(v) for v in arg.flatten().tolist()]).view(arg.shape)
    agree = host.view(torch.int32) == torch.log1p(arg).view(torch.int32)
    assert agree.float().mean() > 0.9
    assert torch.equal(got.view(torch.int32)[agree], want.view(torch.int32)[agree])
    assert got.isfinite().all()


@pytest.mark.parametrize("maxval", [
    1, 50_000, 2**31 - 1,
    torch.tensor(1, dtype=torch.int32), torch.tensor(50_000, dtype=torch.int32),
    torch.tensor([50_000], dtype=torch.int64),
])
def test_randint_equals_plain(host_lib, maxval):
    """The replay's sample: (256,) draws below a device int32 size, or an int."""
    keys = _keys(4)
    got = rng._launch("randint", keys, (256,), bounds=(0, maxval), lib=host_lib)
    _bitwise(got, rng.randint_plain(keys, (256,), 0, maxval))


@pytest.mark.parametrize("minval,maxval", [(5, -3), (7, 7), (-2**31, 2**31 - 1),
                                           (-2**40, 2**40), (-100, 100)])
def test_randint_bounds_equal_plain(host_lib, minval, maxval):
    """hi <= lo (a span of one), the whole int32 range, bounds clamped to
    it, and a negative minval; a stratified (n_envs, k) shape."""
    keys = _keys(3)
    got = rng._launch("randint", keys, (64, 4), bounds=(minval, maxval), lib=host_lib)
    _bitwise(got, rng.randint_plain(keys, (64, 4), minval, maxval))


def test_randint_per_output_bounds_equal_plain(host_lib):
    keys = _keys(3)
    hi = torch.arange(-5, 3 * 16 - 5, dtype=torch.int64).view(3, 16)
    lo = torch.tensor(-3, dtype=torch.int32)
    got = rng._launch("randint", keys, (16,), bounds=(lo, hi), lib=host_lib)
    _bitwise(got, rng.randint_plain(keys, (16,), lo, hi))
    with pytest.raises(ValueError, match="one value or one per output"):
        rng._launch("randint", keys, (16,), bounds=(0, hi[0]), lib=host_lib)


def test_strided_key_views_are_read_in_place(host_lib):
    """The call sites' `sub[:, i]` views, keys stored transposed, a 2-D key
    batch with a step, and a single key; a batch whose axes do not merge is
    refused."""
    sub = rng.split_plain(_keys(N_ENVS[0]), 4)
    for i in range(4):
        _bitwise(rng._launch("uniform", sub[:, i], (12, 1), lib=host_lib),
                 rng.uniform_plain(sub[:, i], (12, 1)))
        _bitwise(rng._launch("split", sub[:, i], (3, 2), lib=host_lib),
                 rng.split_plain(sub[:, i], 3))
    transposed = _keys(5).T.contiguous().T
    assert transposed.stride() == (1, 5)
    _bitwise(rng._launch("bits", transposed, (7,), lib=host_lib),
             rng.bits_plain(transposed, (7,)))
    grid = _keys(30).view(3, 10, 2)[:, ::2]
    _bitwise(rng._launch("uniform", grid, (4,), lo=-2.0, hi=0.5, lib=host_lib),
             rng.uniform_plain(grid, (4,), -2.0, 0.5))
    one = _keys(3)[2]
    _bitwise(rng._launch("randint", one, (5,), bounds=(0, 9), lib=host_lib),
             rng.randint_plain(one, (5,), 0, 9))
    with pytest.raises(ValueError, match="do not merge"):
        rng._launch("bits", _keys(30).view(3, 10, 2)[:, :5], (4,), lib=host_lib)


def test_cpu_keys_run_the_plain_versions(monkeypatch):
    """The rule is read from the keys: on the CPU every draw is its plain
    version and nothing launches; the wrapper refuses keys it does not
    take."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel launched for CPU keys")

    monkeypatch.setattr(rng, "_launch", refuse)
    before = dict(rng.launch_counts)
    keys = _keys(4)
    assert rng._kernel(keys) is None
    _bitwise(rng.split(keys, 3), rng.split_plain(keys, 3))
    _bitwise(rng.fold_in(keys, 9), rng.fold_in_plain(keys, 9))
    _bitwise(rng.bits(keys, (5,)), rng.bits_plain(keys, (5,)))
    _bitwise(rng.uniform(keys, (5,), -1.0, 2.0), rng.uniform_plain(keys, (5,), -1.0, 2.0))
    _bitwise(rng.normal(keys, (5,)), rng.normal_plain(keys, (5,)))
    _bitwise(rng.randint(keys, (5,), 0, 7), rng.randint_plain(keys, (5,), 0, 7))
    assert rng.launch_counts == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="int64"):
        rng._launch("split", keys.to(torch.int32), (2, 2), lib=object())
    with pytest.raises(ValueError, match="2\\*\\*32"):
        rng.bits(keys, (2**16, 2**16))


def test_launch_counts_per_kind(host_lib):
    """`rng.launches.<kind>` (the tracing registry's set-up family) moves by
    one per launch of its kind, not for an empty draw, and not for a launch
    the library refuses; captured programs carry it beside
    `fdm.launches` and `fdm.swap_groups`, the registry's families of device
    launches."""
    from sbsim_tpu_torch.physics import fdm_cuda
    from sbsim_tpu_torch.utils import profiling

    assert profiling.family("rng.launches") is rng.launch_counts
    assert set(rng.launch_counts) == {"split", "fold_in", "bits", "uniform", "normal",
                                      "randint"}
    saved = dict(rng.launch_counts)
    rng.reset_launch_counts()
    keys = _keys(2)
    rng._launch("split", keys, (4, 2), lib=host_lib)
    rng._launch("uniform", keys, (12, 1), lib=host_lib)
    rng._launch("uniform", keys, (12, 1), lib=host_lib)
    assert rng._launch("bits", keys, (0,), lib=host_lib).shape == (2, 0)

    class Refusing:
        def rng_draw_launch(self, *args):
            return 1

    with pytest.raises(RuntimeError, match="CUDA error 1"):
        rng._launch("normal", keys, (3,), lib=Refusing())
    assert rng.launch_counts == {"split": 1, "fold_in": 0, "bits": 0, "uniform": 2,
                                 "normal": 0, "randint": 0}
    rng.launch_counts.update(saved)
    counters = graphs.capture(lambda x: x).counters
    assert {id(c) for c in counters} >= {id(fdm_cuda.launch_counts), id(fdm_cuda.swap_counts),
                                         id(rng.launch_counts)}
    assert not any(c is profiling.family("graphs") for c in counters)


def test_env_and_trainer_draw_through_the_host_kernel(host_lib, monkeypatch):
    """Every call site through the kernel: with the host build standing in
    for the card's library (`rng._kernel`), sb1 env resets and steps
    and SAC train steps on both sides of the update gate equal the same
    calls through the plain versions bitwise, with the card's launches per
    call (3 per env step; 15 per train step past the gate, 10 before it).
    `normal` stays plain here: the host's log1pf is not torch's."""
    from sbsim_tpu_torch.agents import train
    from sbsim_tpu_torch.envs import building_env, presets

    env = building_env.BuildingEnv(presets.sb1_config(num_days_in_episode=1), device="cpu")
    trainer = train.SACTrainer(env, train.recipe_for(env, n_envs=2, batch_size=4,
                                                     seed_steps=4))
    acts = torch.linspace(-1.0, 1.0, 3 * env.n_actions).view(3, 1, env.n_actions)

    def run():
        states, _ = env.reset(rng.split(rng.PRNGKey(5), 3))
        launched = []
        for a in acts:
            before = dict(rng.launch_counts)
            states, out = env.step_batched(states, a.expand(3, -1))
            launched.append(sum(rng.launch_counts.values()) - sum(before.values()))
        st = trainer.init(rng.PRNGKey(6))
        metrics = []
        for _ in range(3):
            before = dict(rng.launch_counts)
            st, m = trainer.train_step(st)
            metrics.append(m)
            launched.append(sum(rng.launch_counts.values()) - sum(before.values()))
        return (states, out, st.env_states, st.replay, st.sac, st.rng, metrics), launched

    want, plain_launched = run()
    assert plain_launched == [0] * 6
    monkeypatch.setattr(rng, "_kernel", lambda key: host_lib)
    monkeypatch.setattr(rng, "normal", rng.normal_plain)
    got, launched = run()
    assert launched == [3, 3, 3, 9, 12, 12]  # less the normals: 1 before the gate, 3 past it
    leaves_got, leaves_want = [], []
    assert graphs.flatten(got, leaves_got) == graphs.flatten(want, leaves_want)
    assert all(_bitwise(a, b) is None for a, b in zip(leaves_got, leaves_want))

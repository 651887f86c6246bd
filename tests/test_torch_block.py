"""The stack layout of the port against the JAX package, on the CPU.

* The plain versions of the block kernels (fdm_jacobi_block_plain,
  fdm_cheby_block_plain, reached through fdm_step_cuda(block_mode="stack"))
  against fdm_step_pallas(block_mode="stack", block_envs=4, interpret=True),
  i.e. _fdm_kernel_block and _fdm_cheby_kernel_block, at B=6 (the last
  block padded): iteration counts and converged flags exact, fields within
  FIELD_ATOL (XLA:CPU contracts FMAs, the port does not; see
  tests/test_torch_physics.py), statistics as tests/test_torch_train.py
  holds them (the port's fold of the JAX kernel's field equals the JAX
  kernel's sums bitwise, the port's own sums within SUM_RTOL).
* Block plain == solo plain bitwise per env, whatever E.
* threefry decision words and argsort convection: bitwise.
* The sb1 stack config through step_batched: 3 steps under pallas_cheby and
  pallas_env, one threefry step and one argsort step, against the JAX env
  with the Pallas kernels in interpret mode (the tolerances of
  tests/test_torch_env.py), and per-env batch isolation.
"""

import dataclasses
import functools

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.core import geometry as jgeo
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.physics import convection as jconv
from sbsim_tpu.physics import fdm as jfdm
from sbsim_tpu.physics import fdm_pallas
from sbsim_tpu.physics import gridstats as jgs
from sbsim_tpu_torch import convert
from sbsim_tpu_torch.core import geometry as tgeo
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.physics import convection as tconv
from sbsim_tpu_torch.physics import fdm as tfdm
from sbsim_tpu_torch.physics import fdm_cuda
from sbsim_tpu_torch.physics import gridstats as tgs

FDM_KW = dict(convergence_threshold=0.1, iteration_limit=100)
FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_physics.py)
SUM_RTOL = 2e-6  # zone sums of fields within FIELD_ATOL (tests/test_torch_train.py)
OUT_ATOL = 1e-4  # observations and rewards (tests/test_torch_env.py)
STATE_RTOL = 1e-5
STATE_ATOL = {"input_q": 1e-3}
EXACT = ("rng", "occupants", "step_idx", "window", "fdm_iterations", "fdm_converged")
B, E = 6, 4


def _sb1(lib):
    return lib.sb1_config(num_days_in_episode=1)


def _stack(cfg, **conv):
    """The config in the stack layout (keeping the preset's E), with the
    convection fields `conv` replaced."""
    return dataclasses.replace(cfg, pallas_block_mode="stack",
                               convection=dataclasses.replace(cfg.convection, **conv))


def _edge_geoms():
    def build(lib):
        return lib.geometry_rectangular(
            cv_size_cm=20.0, floor_height_cm=300.0, room_shape=(8, 6),
            building_shape=(2, 1), initial_temp=294.0,
            inside_air=lib.MaterialProperties(50.0, 700.0, 1.0),
            inside_wall=lib.MaterialProperties(2.0, 500.0, 1800.0),
            building_exterior=lib.MaterialProperties(0.05, 700.0, 1.0))

    return build(jgeo), build(tgeo)


@pytest.fixture(scope="module", params=["edge", "ring"])
def plan(request):
    if request.param == "edge":
        jg, tg = _edge_geoms()
    else:
        jg, tg = jbe.build_geometry(_sb1(jpresets)), tbe.build_geometry(_sb1(tpresets))
    jc = jfdm.stencil_coefficients(jg, 300.0)
    tc = tfdm.stencil_coefficients(tg, 300.0, device="cpu")
    rho = jfdm.estimate_spectral_radius(jc, 12.0)
    buckets = {}
    for rng in ("mix32", "threefry"):
        buckets[rng] = (jconv.make_convection_buckets(jg, p=1.0, distance=5, rng=rng),
                        tconv.make_convection_buckets(tg, p=1.0, distance=5, rng=rng))
    return dict(name=request.param, jg=jg, tg=tg, jc=jc, tc=tc, rho=rho, buckets=buckets,
                jlay=jgs.make_zone_stat_layout(jg), tlay=tgs.make_zone_stat_layout(tg))


def _inputs(shape, batch, seed):
    rs = np.random.default_rng(seed)
    spread = np.linspace(0.5, 4.0, batch).reshape(-1, 1, 1)  # per-env noise scale
    return dict(
        temp=(294.0 + spread * rs.normal(0, 1.0, (batch,) + shape)).astype(np.float32),
        q=rs.uniform(0.0, 50.0, (batch,) + shape).astype(np.float32),
        t_inf=rs.uniform(270.0, 300.0, batch).astype(np.float32),
        h=rs.uniform(5.0, 100.0, batch).astype(np.float32),
        keys=rs.integers(0, 2**32, (batch, 2), dtype=np.uint64).astype(np.uint32),
    )


def _conv_kwargs(plan, conv, keys):
    """(JAX kwargs, port kwargs) of fused convection of kind `conv`: None,
    "mix32" (words from the keys in the kernel) or "threefry" (a word plane)."""
    if conv is None:
        return {}, {}
    jb, tb = plan["buckets"][conv]
    shared = lambda b: dict(conv_offsets=b.offsets, conv_lead=b.lead_words,
                            conv_foll=b.foll_words)
    tkeys = torch.as_tensor(keys.astype(np.int64))
    if conv == "mix32":
        return (dict(shared(jb), conv_keys=jnp.asarray(keys),
                     conv_word_params=jconv.decision_word_params(jb)),
                dict(shared(tb), conv_keys=tkeys,
                     conv_word_params=tconv.decision_word_params(tb)))
    jwords = jnp.stack([jconv.swap_decision_word(jb, jnp.asarray(k), plan["jg"].shape)
                        for k in keys])
    twords = tconv.swap_decision_word(tb, tkeys, plan["tg"].shape)
    np.testing.assert_array_equal(twords.numpy(), np.asarray(jwords).astype(np.int64))
    return dict(shared(jb), conv_word=jwords), dict(shared(tb), conv_word=twords)


CASES = {
    # name: (method, check_every, fused convection, statistics)
    "jacobi": ("jacobi", 1, None, False),
    "cheby_ce1": ("chebyshev", 1, None, False),
    "cheby_ce4": ("chebyshev", 4, None, False),
    "jacobi_stats": ("jacobi", 1, None, True),
    "cheby_ce4_stats": ("chebyshev", 4, None, True),
    "jacobi_mix32": ("jacobi", 1, "mix32", True),
    "cheby_ce4_mix32": ("chebyshev", 4, "mix32", False),
    "jacobi_threefry": ("jacobi", 1, "threefry", False),
    "cheby_ce1_threefry": ("chebyshev", 1, "threefry", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_plain_matches_jax_stack_kernel(plan, case):
    method, check_every, conv, with_stats = CASES[case]
    x = _inputs(plan["jg"].shape, B, seed=sorted(CASES).index(case))
    jkw, tkw = _conv_kwargs(plan, conv, x["keys"])
    kw = dict(FDM_KW, method=method, spectral_radius=plan["rho"], check_every=check_every,
              block_mode="stack", block_envs=E)
    if with_stats:
        jkw.update(stat_layout=plan["jlay"])
        tkw.update(stat_layout=plan["tlay"])
    args = ("temp", "q", "t_inf", "h")
    jout = fdm_pallas.fdm_step_pallas(*(jnp.asarray(x[k]) for k in args), plan["jc"],
                                      interpret=True, **kw, **jkw)
    tout = fdm_cuda.fdm_step_cuda(*(torch.as_tensor(x[k]) for k in args), plan["tc"],
                                  **kw, **tkw)
    jtemp, jiters, jconv_ = (np.array(a) for a in jout[:3])
    np.testing.assert_array_equal(tout[1].numpy(), jiters)
    np.testing.assert_array_equal(tout[2].numpy(), jconv_)
    np.testing.assert_allclose(tout[0].numpy(), jtemp, atol=FIELD_ATOL, rtol=0)
    if method == "jacobi":
        assert len(np.unique(jiters)) > 1  # envs of one block freeze at different times
    if with_stats:
        z = len(plan["tlay"].row0)
        jstats = np.asarray(jout[3])
        stats = tgs.ZoneStats(plan["tlay"], "cpu")
        on_jax = fdm_cuda.fold_stats(torch.as_tensor(jtemp), stats)
        np.testing.assert_array_equal(on_jax.zone_sums.numpy(), jstats[:, 0, :z])
        np.testing.assert_array_equal(on_jax.grid_sums.numpy(), jstats[:, 1, 0])
        sums = tout[3]
        assert torch.equal(sums.zone_sums, stats.zone_sums(tout[0]))
        assert torch.equal(sums.grid_sums, stats.grid_sum(tout[0]))
        np.testing.assert_allclose(sums.zone_sums.numpy(), jstats[:, 0, :z], rtol=SUM_RTOL)
        np.testing.assert_allclose(sums.grid_sums.numpy(), jstats[:, 1, 0], rtol=SUM_RTOL)


@pytest.mark.parametrize("block_envs", [2, 4])
@pytest.mark.parametrize("method", ["jacobi", "chebyshev"])
def test_block_plain_equals_solo_plain_per_env(plan, method, block_envs):
    """On a batch of 7 (not a multiple of E), with mix32 convection and
    statistics: every env's field, count, flag and sums equal the solo
    plain version's bitwise."""
    x = _inputs(plan["jg"].shape, 7, seed=20 + block_envs)
    _, tkw = _conv_kwargs(plan, "mix32", x["keys"])
    inp = fdm_cuda.kernel_inputs(*(torch.as_tensor(x[k]) for k in ("temp", "q", "t_inf", "h")),
                                 plan["tc"])
    tb = plan["buckets"]["mix32"][1]
    conv = fdm_cuda.ConvInputs(
        offsets=tb.offsets, lead=fdm_cuda.packed_plane(tb.lead_words, "cpu"),
        foll=fdm_cuda.packed_plane(tb.foll_words, "cpu"),
        word_params=tkw["conv_word_params"], keys=tkw["conv_keys"])
    kw = dict(threshold=0.1, iteration_limit=100, conv=conv,
              stats=tgs.ZoneStats(plan["tlay"], "cpu"))
    if method == "chebyshev":
        kw.update(spectral_radius=plan["rho"], check_every=4)
        block = fdm_cuda.fdm_cheby_block_plain(inp, block_envs=block_envs, **kw)
        solo = fdm_cuda.fdm_cheby_plain(inp, **kw)
    else:
        block = fdm_cuda.fdm_jacobi_block_plain(inp, block_envs=block_envs, **kw)
        solo = fdm_cuda.fdm_jacobi_plain(inp, **kw)
    for a, b in zip(block[:3], solo[:3]):
        assert torch.equal(a, b)
    assert torch.equal(block[3].zone_sums, solo[3].zone_sums)
    assert torch.equal(block[3].grid_sums, solo[3].grid_sums)
    # And each env alone gives the same.
    one = fdm_cuda.KernelInputs(**{
        **inp.__dict__, **{k: getattr(inp, k)[5:6] for k in ("temp", "const", "denom", "tinf")}})
    kw["conv"] = dataclasses.replace(conv, keys=conv.keys[5:6])
    fn = fdm_cuda.fdm_cheby_block_plain if method == "chebyshev" else fdm_cuda.fdm_jacobi_block_plain
    alone = fn(one, block_envs=block_envs, **kw)
    assert torch.equal(alone[0][0], block[0][5]) and int(alone[1][0]) == int(block[1][5])


def test_capped_block_solve_reports_unconverged(plan):
    x = _inputs(plan["jg"].shape, 5, seed=30)
    x["t_inf"][:] = 270.0
    args = ("temp", "q", "t_inf", "h")
    for method in ("jacobi", "chebyshev"):
        kw = dict(convergence_threshold=0.1, iteration_limit=3, method=method,
                  spectral_radius=plan["rho"], check_every=4, block_mode="stack", block_envs=2)
        _, jit_, jconv_ = fdm_pallas.fdm_step_pallas(
            *(jnp.asarray(x[k]) for k in args), plan["jc"], interpret=True, **kw)
        _, tit, tconv_ = fdm_cuda.fdm_step_cuda(*(torch.as_tensor(x[k]) for k in args),
                                                plan["tc"], **kw)
        assert not np.asarray(jconv_).any()
        np.testing.assert_array_equal(tconv_.numpy(), np.asarray(jconv_))
        np.testing.assert_array_equal(tit.numpy(), np.asarray(jit_))


# ---------------------------------------------------------------------------
# threefry words and argsort convection
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sb1_geoms():
    return jbe.build_geometry(_sb1(jpresets)), tbe.build_geometry(_sb1(tpresets))


@pytest.mark.parametrize("rounds", [0, 6])  # 4-bit lanes (auto), 8-bit lanes
def test_threefry_words_bitwise(sb1_geoms, rounds):
    jg, tg = sb1_geoms
    jb = jconv.make_convection_buckets(jg, 1.0, 5, rounds=rounds, rng="threefry")
    tb = tconv.make_convection_buckets(tg, 1.0, 5, rounds=rounds, rng="threefry")
    assert tconv.decision_word_params(tb) is None is jconv.decision_word_params(jb)
    lane_bits = tconv._word_layout(tb)[2]
    assert lane_bits == (4 if rounds == 0 else 8)
    keys = jax.random.split(jax.random.PRNGKey(rounds + 1), 5)
    want = np.stack([np.asarray(jconv.swap_decision_word(jb, k, jg.shape)) for k in keys])
    tkeys = torch.as_tensor(np.asarray(keys).astype(np.int64))
    got = tconv.swap_decision_word(tb, tkeys, tg.shape)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for i in range(2):  # one key at a time
        one = tconv.swap_decision_word(tb, tkeys[i:i + 1], tg.shape)
        np.testing.assert_array_equal(one[0].numpy(), want[i].astype(np.int64))
    # The swap rounds of those words (the unfused path) equal JAX's.
    temp = (294.0 + np.random.default_rng(rounds).normal(0, 2.0, (5,) + jg.shape)).astype(
        np.float32)
    jout = jax.vmap(lambda t, k: jconv.apply_convection(t, jb, k))(jnp.asarray(temp), keys)
    tout = tconv.apply_convection(torch.as_tensor(temp), tb, tkeys)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("distance", [5, -1])
def test_argsort_convection_bitwise(sb1_geoms, distance):
    jg, tg = sb1_geoms
    jb = jconv.make_convection_buckets(jg, 1.0, distance, method="argsort")
    tb = tconv.make_convection_buckets(tg, 1.0, distance, method="argsort")
    np.testing.assert_array_equal(tb.flat_indices, np.asarray(jb.flat_indices))
    np.testing.assert_array_equal(tb.segment_keys, np.asarray(jb.segment_keys))
    assert tb.flat_indices.dtype == np.int32 and tb.segment_keys.dtype == np.float32
    temp = (294.0 + np.random.default_rng(2).normal(0, 2.0, (3,) + jg.shape)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(distance + 7), 3)
    jout = np.asarray(jax.vmap(lambda t, k: jconv.apply_convection(t, jb, k))(
        jnp.asarray(temp), keys))
    tout = tconv.apply_convection(torch.as_tensor(temp), tb,
                                  torch.as_tensor(np.asarray(keys).astype(np.int64)))
    np.testing.assert_array_equal(tout.numpy(), jout)
    assert (jout != temp).mean() > 0.5
    # A permutation within the rooms: room cells keep their multiset.
    room = tg.zone_ids < tg.n_zones
    np.testing.assert_array_equal(tout.numpy()[:, ~room], temp[:, ~room])
    np.testing.assert_array_equal(np.sort(tout.numpy()[:, room], 1), np.sort(temp[:, room], 1))


# ---------------------------------------------------------------------------
# The sb1 stack config through step_batched
# ---------------------------------------------------------------------------


def _tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _compare_states(jtree, ttree, temp_atol):
    tflat = dict(_flat(ttree))
    for name, want in _flat(jtree):
        got = tflat[name]
        assert got.shape == want.shape, name
        if name in EXACT or want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name == "temp":
            np.testing.assert_allclose(got, want, atol=temp_atol, rtol=0, err_msg=name)
        else:
            atol = STATE_ATOL.get(name, STATE_RTOL * max(1.0, float(np.abs(want).max())))
            np.testing.assert_allclose(got, want, atol=atol, rtol=STATE_RTOL, err_msg=name)


def _env_pair(**conv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fdm_pallas, "fdm_step_pallas",
                   functools.partial(fdm_pallas.fdm_step_pallas, interpret=True))
        jcfg = _stack(jpresets.sb1_config(num_days_in_episode=2), **conv)
        jenv = jbe.BuildingEnv(jcfg)
        tenv = tbe.BuildingEnv(_stack(tpresets.sb1_config(num_days_in_episode=2), **conv),
                               device="cpu")
        jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(3), 4))
    assert tenv.config.pallas_block_mode == "stack" and tenv.config.pallas_block_envs == 8
    return jenv, tenv, jstate


@pytest.fixture(scope="module")
def stack_envs():
    return _env_pair()


def _steps(jenv, tenv, jstate, solver, steps, monkeypatch):
    monkeypatch.setattr(fdm_pallas, "fdm_step_pallas",
                        functools.partial(fdm_pallas.fdm_step_pallas, interpret=True))
    actions = np.random.default_rng(0).uniform(-1, 1, (steps, 4, 2)).astype(np.float32)
    free = convert.env_state_from_numpy(_tree(jstate), "cpu")
    fdm_cuda.reset_launch_counts()
    for i in range(steps):
        carried = convert.env_state_from_numpy(_tree(jstate), "cpu")
        tstate, tout = tenv.step_batched(carried, torch.as_tensor(actions[i]), solver=solver)
        jstate, jout = jenv.step_batched(jstate, jnp.asarray(actions[i]), solver=solver)
        jtree = _tree(jstate)
        _compare_states(jtree, convert.env_state_to_numpy(tstate), FIELD_ATOL)
        for name in ("observation", "reward", "done"):
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                atol=OUT_ATOL, rtol=0, err_msg=name)
        free, fout = tenv.step_batched(free, torch.as_tensor(actions[i]), solver=solver)
        _compare_states(jtree, convert.env_state_to_numpy(free), (i + 1) * FIELD_ATOL)
        np.testing.assert_allclose(fout.reward.numpy(), np.asarray(jout.reward),
                                   atol=OUT_ATOL, rtol=0)
    assert (np.asarray(jstate.fdm_iterations) > 0).all()
    assert fdm_cuda.launch_counts == dict.fromkeys(fdm_cuda.launch_counts, 0)


@pytest.mark.parametrize("solver", ["pallas_cheby", "pallas_env"])
def test_stack_three_steps_match_jax(stack_envs, solver, monkeypatch):
    _steps(*stack_envs, solver, 3, monkeypatch)


@pytest.mark.parametrize("kind", ["threefry", "argsort"])
def test_stack_step_with_threefry_and_argsort_matches_jax(kind, monkeypatch):
    conv = dict(rng="threefry") if kind == "threefry" else dict(method="argsort")
    jenv, tenv, jstate = _env_pair(**conv)
    solver = "pallas_cheby" if kind == "threefry" else "pallas_env"
    # The threefry words are passed into the kernel (fused, statistics in
    # the kernel); argsort mixes after it (statistics from the fold).
    seen = []
    real = fdm_cuda.Route.run

    def spy(route, inp, conv=None, stats=None, barriers=None):
        seen.append((conv is not None and conv.words is not None, stats is not None))
        return real(route, inp, conv, stats, barriers)

    monkeypatch.setattr(fdm_cuda.Route, "run", spy)
    _steps(jenv, tenv, jstate, solver, 1, monkeypatch)
    assert seen[0] == ((True, True) if kind == "threefry" else (False, False))


@pytest.mark.parametrize("solver", ["pallas_cheby", "pallas_env"])
def test_stack_env_result_does_not_depend_on_its_batch(stack_envs, solver):
    _, tenv, jstate = stack_envs
    tree = _tree(jstate)
    full = convert.env_state_from_numpy(tree, "cpu")
    solo = convert.env_state_from_numpy(jax.tree.map(lambda a: a[2:3], tree), "cpu")
    action = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (4, 2)).astype(np.float32))
    for _ in range(2):
        full, fout = tenv.step_batched(full, action, solver=solver)
        solo, sout = tenv.step_batched(solo, action[2:3], solver=solver)
    ft, st = convert.env_state_to_numpy(full), convert.env_state_to_numpy(solo)
    for (name, a), (_, b) in zip(_flat(ft), _flat(st)):
        np.testing.assert_array_equal(a[2:3], b, err_msg=name)
    np.testing.assert_array_equal(fout.observation[2:3].numpy(), sout.observation.numpy())

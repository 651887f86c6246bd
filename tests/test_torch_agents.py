"""The port's SAC agents against the JAX package, on the CPU.

The same parameters (the JAX learner's, carried over with
sbsim_tpu_torch.convert) and the same seeded numpy batches go through
flax/optax and the port:

  * forward passes of the actor and the twin critic: 1e-5 relative (XLA
    contracts the matmuls' multiply-adds differently from PyTorch's CPU
    GEMM);
  * one SACLearner.update: losses and metrics to 1e-5 relative, every new
    parameter, target parameter and Adam moment to 1e-6 absolute, counts
    exact; with global-norm clipping and with the min_alpha floor too;
  * the replay rings: inserts and samples exactly;
  * the threefry draws: randint and uniform(minval, maxval) bitwise,
    normal within 4 float32 ulps (XLA fuses the erfinv polynomial's
    multiply-adds).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.agents import exploration as jexpl
from sbsim_tpu.agents import networks as jnet
from sbsim_tpu.agents import replay as jreplay
from sbsim_tpu.agents import sac as jsac
from sbsim_tpu_torch import convert, rng
from sbsim_tpu_torch.agents import exploration as texpl
from sbsim_tpu_torch.agents import networks as tnet
from sbsim_tpu_torch.agents import policies as tpolicies
from sbsim_tpu_torch.agents import replay as treplay
from sbsim_tpu_torch.agents import sac as tsac

OBS, ACT, BATCH = 9, 3, 16
FWD_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6


def _tree(x):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(x))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _batch(seed, n=BATCH):
    rs = np.random.default_rng(seed)
    f = lambda *s: rs.normal(0, 1, s).astype(np.float32)
    obs, next_obs = f(n, OBS), f(n, OBS)
    obs[:, 0] += 290.0  # a raw-magnitude field, as sb1 emits (the LayerNorm's reason)
    return dict(obs=obs, action=np.tanh(f(n, ACT)), reward=-np.abs(f(n)),
                discount=np.where(rs.uniform(size=n) < 0.1, 0.0, 0.99).astype(np.float32),
                next_obs=next_obs)


def _learners(config_kw):
    jl = jsac.SACLearner(OBS, ACT, jsac.SACConfig(**config_kw))
    tl = tsac.SACLearner(OBS, ACT, tsac.SACConfig(**config_kw), device="cpu")
    jstate = jl.init(jax.random.PRNGKey(7))
    return jl, tl, jstate


def _key(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


# ---------------------------------------------------------------------------
# RNG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(-0.1, 0.1), (0.0, 1.0), (-3.0, 7.5)])
def test_uniform_range_is_bitwise(lo, hi):
    for seed in (0, 11):
        jk, tk = _key(seed)
        want = np.asarray(jax.random.uniform(jk, (64, 37), minval=lo, maxval=hi))
        np.testing.assert_array_equal(rng.uniform(tk, (64, 37), lo, hi).numpy(), want)


@pytest.mark.parametrize("maxval", [1, 7, 781, 65537, 2**31 - 1])
def test_randint_is_bitwise(maxval):
    for seed in (3, 4):
        jk, tk = _key(seed)
        want = np.asarray(jax.random.randint(jk, (64, 4), 0, jnp.maximum(maxval, 1)))
        got = rng.randint(tk, (64, 4), 0, torch.tensor(maxval, dtype=torch.int32))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_normal_within_four_ulps():
    jk, tk = _key(5)
    want = np.asarray(jax.random.normal(jk, (200_000,)))
    got = rng.normal(tk, (200_000,)).numpy()
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= 4 * ulp)
    assert np.mean(got == want) > 0.9


def test_random_walk_matches_jax():
    jk, tk = _key(2)
    prev = np.random.default_rng(1).uniform(-1, 1, (8, ACT)).astype(np.float32)
    want, _ = jexpl.random_walk_policy(ACT, 0.1)(jnp.asarray(prev), jk)
    got, _ = texpl.random_walk_policy(ACT, 0.1)(torch.as_tensor(prev), tk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


def test_forward_passes_match_flax():
    jl, tl, jstate = _learners({})
    tstate = convert.sac_state_from_numpy(_tree(jstate), tl)
    b = _batch(0)
    mean, log_std = jl.actor.apply(jstate.actor_params, b["obs"])
    tmean, tlog_std = tl.actor_apply(tstate.actor_params, torch.as_tensor(b["obs"]))
    np.testing.assert_allclose(tmean.detach().numpy(), mean, rtol=FWD_RTOL, atol=1e-6)
    np.testing.assert_allclose(tlog_std.detach().numpy(), log_std, rtol=FWD_RTOL, atol=1e-6)
    q1, q2 = jl.critic.apply(jstate.critic_params, b["obs"], b["action"])
    tq1, tq2 = tl.critic_apply(tstate.critic_params, torch.as_tensor(b["obs"]),
                               torch.as_tensor(b["action"]))
    np.testing.assert_allclose(tq1.detach().numpy(), q1, rtol=FWD_RTOL, atol=1e-6)
    np.testing.assert_allclose(tq2.detach().numpy(), q2, rtol=FWD_RTOL, atol=1e-6)
    # The sampled action and its log-prob from the same key.
    jk, tk = _key(9)
    a, logp = jnet.sample_action(mean, log_std, jk)
    ta, tlogp = tnet.sample_action(tmean, tlog_std, tk)
    np.testing.assert_allclose(ta.detach().numpy(), a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tlogp.detach().numpy(), logp, rtol=1e-4, atol=1e-4)


def test_layer_norm_is_flax_not_torch():
    x = torch.as_tensor(_batch(1)["obs"])
    ln = tnet.LayerNorm(OBS)
    ours = ln(x).detach().numpy()
    flax_out = jax.numpy.asarray(
        jnet.nn.LayerNorm().apply({"params": {"scale": np.ones(OBS, np.float32),
                                              "bias": np.zeros(OBS, np.float32)}},
                                  x.numpy()))
    np.testing.assert_allclose(ours, flax_out, rtol=1e-5, atol=1e-5)


def test_param_conversion_round_trips():
    jl, tl, jstate = _learners({"gradient_clipping": 1.0})
    tree = _tree(jstate)
    back = dict(_flat(convert.sac_state_to_numpy(convert.sac_state_from_numpy(tree, tl), tl)))
    for name, a in _flat(tree):
        np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_port_init_is_glorot_and_seeded():
    tl = tsac.SACLearner(OBS, ACT, device="cpu")
    a, b = tl.init(rng.PRNGKey(0)), tl.init(rng.PRNGKey(0))
    c = tl.init(rng.PRNGKey(1))
    w = a.actor_params["body.layers.0.weight"]
    assert torch.equal(w, b.actor_params["body.layers.0.weight"])
    assert not torch.equal(w, c.actor_params["body.layers.0.weight"])
    limit = np.sqrt(6.0 / (OBS + 128))
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
    assert all(float(v.abs().max()) == 0 for k, v in a.critic_params.items()
               if k.endswith("bias") and "norm" not in k)
    assert float(a.log_alpha) == 0.0


# ---------------------------------------------------------------------------
# One update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config_kw", [
    {},
    {"gradient_clipping": 0.05},
    {"min_alpha": 0.9999, "alpha_lr": 0.1},
    {"mean_reg": 0.01, "gradient_clipping": 1e6},
], ids=["default", "clipped", "min_alpha", "mean_reg"])
def test_one_update_matches_optax(config_kw):
    jl, tl, jstate = _learners(config_kw)
    # A state one update in, so the Adam moments and counts are not zero.
    b0, b1 = _batch(10), _batch(11)
    jstate, _ = jl.update(jstate, jreplay.Transition(**b0), jax.random.PRNGKey(1))
    tstate = convert.sac_state_from_numpy(_tree(jstate), tl)
    jk, tk = _key(2)
    jnew, jm = jl.update(jstate, jreplay.Transition(**b1), jk)
    tbatch = treplay.Transition(**{k: torch.as_tensor(v) for k, v in b1.items()})
    tnew, tm = tl.update(tstate, tbatch, tk)
    for name, want in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(want), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
    got = dict(_flat(convert.sac_state_to_numpy(tnew, tl)))
    for name, want in _flat(_tree(jnew)):
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want, rtol=0, atol=PARAM_ATOL, err_msg=name)
    if config_kw.get("min_alpha"):
        # The floor holds: the step of lr 0.1 would take alpha below it.
        assert float(tm["alpha"]) == pytest.approx(config_kw["min_alpha"], rel=1e-6)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def _transitions(seed, lead):
    rs = np.random.default_rng(seed)
    f = lambda *s: rs.normal(0, 1, lead + s).astype(np.float32)
    return dict(obs=f(OBS), action=f(ACT), reward=f(), discount=f(), next_obs=f(OBS))


def test_sharded_replay_insert_and_sample_equal_jax():
    n_envs, cap = 4, 5
    js = jreplay.init_sharded_replay(n_envs, cap, OBS, ACT)
    ts = treplay.init_sharded_replay(n_envs, cap, OBS, ACT, device="cpu")
    for step in range(7):  # wraps the ring
        b = _transitions(step, (n_envs,))
        js = jreplay.add_batch_sharded(js, jreplay.Transition(**b))
        ts = treplay.add_batch_sharded(ts, treplay.Transition(
            **{k: torch.as_tensor(v) for k, v in b.items()}))
        assert int(ts.size) == int(js.size) and int(ts.insert_index) == int(js.insert_index)
        jk, tk = _key(100 + step)
        want = jreplay.sample_sharded(js, jk, 8)
        got = treplay.sample_sharded(ts, tk, 8)
        for name in ("obs", "action", "reward", "discount", "next_obs"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(ts.data.obs.numpy(), np.asarray(js.data.obs))
    with pytest.raises(ValueError):
        treplay.sample_sharded(ts, rng.PRNGKey(0), 6)


def test_flat_replay_insert_and_sample_equal_jax():
    js = jreplay.init_replay(10, OBS, ACT)
    ts = treplay.init_replay(10, OBS, ACT, device="cpu")
    for step in range(4):
        b = _transitions(step, (3,))
        js = jreplay.add_batch(js, jreplay.Transition(**b))
        ts = treplay.add_batch(ts, treplay.Transition(
            **{k: torch.as_tensor(v) for k, v in b.items()}))
        jk, tk = _key(step)
        want, got = jreplay.sample(js, jk, 6), treplay.sample(ts, tk, 6)
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(want.obs))
        np.testing.assert_array_equal(got.reward.numpy(), np.asarray(want.reward))
    assert int(ts.size) == int(js.size) == 10
    assert int(ts.insert_index) == int(js.insert_index) == 2


# ---------------------------------------------------------------------------
# Policy export
# ---------------------------------------------------------------------------


def test_save_and_load_policy(tmp_path):
    tl = tsac.SACLearner(OBS, ACT, device="cpu")
    state = tl.init(rng.PRNGKey(4))
    tpolicies.save_policy(str(tmp_path), tl, state, ["a", "b", "c"])
    policy, meta = tpolicies.load_policy(str(tmp_path), device="cpu")
    assert meta["action_names"] == ["a", "b", "c"] and meta["obs_dim"] == OBS
    obs = torch.as_tensor(_batch(3)["obs"])
    np.testing.assert_array_equal(policy(obs).numpy(), tl.act_greedy(state, obs).numpy())
    assert (tmp_path / "policy_metadata.json").exists()

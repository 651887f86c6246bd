"""The long-trajectory and episode-end gate: the port against the JAX
package through the end of an episode, on the CPU.

two_zone_test_config(num_days_in_episode=1): 9 x 11 grid, 288 steps per
episode, B=2, solver xla_jacobi, the schedule baseline's actions.

* 300 env steps from one reset, each package on its own trajectory: the
  max |dT| of every step within DRIFT_ATOL (the budget of
  tests/test_device_vs_host.py); `done` (first at step 288), step_idx,
  window, occupants, thermostat modes and iteration counts exact;
  observations and rewards within OUT_ATOL.
* SACTrainer.seed_with_actions for 290 collect steps at n_envs=2 from the
  same converted TrainState (randomized occupancy): every env resets at
  step 288 through `_maybe_reset`; the state right after is bitwise the
  JAX one; after step 290 keys, step_idx, occupants, replay cursors and
  counts are exact, fields within DRIFT_ATOL, the replay ring within
  OUT_ATOL.

Each solve differs from jitted JAX by a few float32 ulps (XLA contracts
multiply-adds; tests/test_torch_env.py). The drift does not grow with the
steps: it peaks at 9.2e-5 K (step 28) and is 3.1e-5 K at step 300, and no
thermostat threshold or iteration count flips on these runs.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.agents import schedule_policy as jsched
from sbsim_tpu.agents import train as jtrain
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu_torch import convert
from sbsim_tpu_torch.agents import schedule_policy as tsched
from sbsim_tpu_torch.agents import train as ttrain
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets

B = 2
STEPS = 300
EPISODE = 288
DRIFT_ATOL = 5e-2  # K (tests/test_device_vs_host.py)
OUT_ATOL = 1e-4
EXACT = ("rng", "occupants", "step_idx", "window", "hvac.thermostat_mode", "fdm_iterations",
         "fdm_converged")


def _tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _config(lib, occupancy_kind):
    return lib.two_zone_test_config(num_days_in_episode=1, occupancy_kind=occupancy_kind)


@pytest.mark.parametrize("occupancy_kind", ["step_function", "randomized"])
def test_300_steps_through_the_episode_end(occupancy_kind):
    jenv = jbe.BuildingEnv(_config(jpresets, occupancy_kind))
    tenv = tbe.BuildingEnv(_config(tpresets, occupancy_kind), device="cpu")
    assert tenv.steps_per_episode == EPISODE
    table = jsched.build_schedule_actions(jenv)
    np.testing.assert_array_equal(tsched.build_schedule_actions(tenv), table)
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(4), B))
    tstate = convert.env_state_from_numpy(_tree(jstate), "cpu")
    step = jax.jit(lambda s, a: jenv.step_batched(s, a, solver="xla_jacobi"))
    done_at, drift = None, []
    for i in range(STEPS):
        action = table[min(i, len(table) - 1)][None].repeat(B, 0)
        jstate, jout = step(jstate, jnp.asarray(action))
        tstate, tout = tenv.step_batched(tstate, torch.as_tensor(action), solver="xla_jacobi")
        got = dict(_flat(convert.env_state_to_numpy(tstate)))
        want = dict(_flat(_tree(jstate)))
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"step {i + 1} {name}")
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
        drift.append(float(np.abs(got["temp"] - want["temp"]).max()))
        assert drift[-1] < DRIFT_ATOL, f"step {i + 1}: max |dT| {drift[-1]}"
        for name in ("observation", "reward"):
            np.testing.assert_allclose(getattr(tout, name).numpy(),
                                       np.asarray(getattr(jout, name)), atol=OUT_ATOL,
                                       rtol=0, err_msg=f"step {i + 1} {name}")
        if done_at is None and bool(np.asarray(jout.done).any()):
            done_at = i + 1
            assert np.asarray(jout.done).all()
    assert done_at == EPISODE
    assert max(drift) > 0.0


def test_seeding_across_the_episode_end():
    kind = "randomized"
    jenv = jbe.BuildingEnv(_config(jpresets, kind))
    tenv = tbe.BuildingEnv(_config(tpresets, kind), device="cpu")
    kw = dict(n_envs=B, batch_size=4, replay_capacity=2 * (EPISODE + 8), seed_steps=0,
              env_solver="xla_jacobi")
    jt = jtrain.SACTrainer(jenv, jtrain.recipe_for(jenv, **kw))
    tt = ttrain.SACTrainer(tenv, ttrain.recipe_for(tenv, **kw))
    jstate = jax.jit(jt.init)(jax.random.PRNGKey(9))
    tstate = convert.train_state_from_numpy(_tree(jstate), tt)
    table = jsched.build_schedule_actions(jenv)
    jstep = jax.jit(jt.seed_with_actions(jstate, table))
    tstep = tt.seed_with_actions(tstate, tsched.build_schedule_actions(tenv))
    resets = []
    real_reset = tt._maybe_reset

    def spy(env_states, obs, done, key, *hooks):
        resets.append(bool(done.any()))
        return real_reset(env_states, obs, done, key, *hooks)

    tt._maybe_reset = spy
    for i in range(EPISODE + 2):
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        np.testing.assert_allclose(float(tm["reward_mean"]), float(jm["reward_mean"]),
                                   atol=OUT_ATOL, rtol=0)
        if i + 1 == EPISODE:
            # Every env finished and was reset: the fresh states are bitwise
            # the JAX package's.
            assert tstate.env_states.step_idx.tolist() == [0] * B
            want = dict(_flat(_tree(jstate.env_states)))
            for name, got in _flat(convert.env_state_to_numpy(tstate.env_states)):
                np.testing.assert_array_equal(got, want[name], err_msg=f"reset {name}")
            np.testing.assert_allclose(tstate.last_obs.numpy(), np.asarray(jstate.last_obs),
                                       atol=OUT_ATOL, rtol=0)
    assert resets == [i + 1 == EPISODE for i in range(EPISODE + 2)]
    got = dict(_flat(convert.train_state_to_numpy(tstate, tt)))
    want = dict(_flat(_tree(jstate)))
    assert got["env_states.step_idx"].tolist() == [2] * B
    for name in ("rng", "env_steps", "replay.insert_index", "replay.size", "env_states.rng",
                 "env_states.step_idx", "env_states.occupants", "env_states.window"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["env_states.temp"], want["env_states.temp"],
                               atol=DRIFT_ATOL, rtol=0)
    for field in ("obs", "action", "reward", "discount", "next_obs"):
        k = f"replay.data.{field}"
        np.testing.assert_allclose(got[k], want[k], atol=OUT_ATOL, rtol=0, err_msg=k)
    # The transition that ended each episode carries discount 0.
    discount = got["replay.data.discount"]
    assert (discount[:, EPISODE - 1] == 0).all() and (discount[:, :EPISODE - 1] > 0).all()

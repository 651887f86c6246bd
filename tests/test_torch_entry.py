"""The port's entry points and the modules they need, against the JAX
package on the CPU.

* scenario/tables.to_local: every zone of TIME_ZONES against `zoneinfo`,
  hourly over 2003 and 2023, and every 5 minutes within 3 h of each
  daylight-saving change from 1990 (or the zone's rule's first year) to
  2037; each of those changes is one in `zoneinfo` too (exact).
* rng.fold_in and rng.randint on a batch of keys: bitwise
  jax.random.fold_in and jax.vmap(jax.random.randint).
* BuildingSuite: reset and 2 steps (use_pallas=False: xla_jacobi) on two
  small plans against the JAX suite: keys, windows, step counts and
  iteration counts exact, fields within FIELD_ATOL, merged outputs within
  OUT_ATOL; building_suite's three plans have JAX's grid shapes.
* io/checkpoint: save/restore round trip bitwise, a resumed run equal to
  an uninterrupted one, max_to_keep, a template mismatch refused, and a
  port checkpoint loaded into the JAX TrainState through
  flax.serialization.from_state_dict equal to train_state_to_numpy.
* io/metrics: the JSONL round trip, one host copy per record, TensorBoard
  export through torch.utils.tensorboard or, where that does not import,
  off with one warning.
* examples/train_sac.main on the small building, on the CPU.
"""

import dataclasses
import datetime
import json
import os
import sys
import types
import zoneinfo

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbsim_tpu.agents import train as jtrain
from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu.envs import suite as jsuite
from sbsim_tpu_torch import convert, rng
from sbsim_tpu_torch.agents import train as ttrain
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.envs import suite as tsuite
from sbsim_tpu_torch.io import checkpoint as tckpt
from sbsim_tpu_torch.io import metrics as tmetrics
from sbsim_tpu_torch.scenario import tables as ttables

FIELD_ATOL = 2e-4  # K, one solve (tests/test_torch_env.py)
OUT_ATOL = 1e-4
UTC = datetime.timezone.utc

# ---------------------------------------------------------------------------
# Time zones
# ---------------------------------------------------------------------------


def _local(ts, tz):
    return ts.astimezone(tz).replace(tzinfo=None)


@pytest.mark.parametrize("zone", sorted(ttables.TIME_ZONES))
def test_time_zone_table_matches_zoneinfo(zone):
    tz = zoneinfo.ZoneInfo(zone)
    hour = datetime.timedelta(hours=1)
    for year in (2003, 2023):
        start = datetime.datetime(year, 1, 1, tzinfo=UTC)
        for i in range(366 * 24):
            ts = start + i * hour
            assert ttables.to_local(ts, zone) == _local(ts, tz), ts
    std, rule = ttables.TIME_ZONES[zone]
    if rule is None:
        return
    first, daylight = ttables._RULES[rule]
    five = datetime.timedelta(minutes=5)
    for year in range(max(1990, first), 2038):
        for change in daylight(year, datetime.timedelta(minutes=std)):
            at = change.replace(tzinfo=UTC)
            assert (at - five).astimezone(tz).utcoffset() != at.astimezone(tz).utcoffset(), at
            for k in range(-36, 37):
                ts = at + k * five
                assert ttables.to_local(ts, zone) == _local(ts, tz), ts


def test_local_midnight_for_every_zone():
    for zone in ttables.TIME_ZONES:
        tz = zoneinfo.ZoneInfo(zone)
        for day in (datetime.datetime(2023, 3, 26), datetime.datetime(2023, 10, 29),
                    datetime.datetime(2023, 3, 12), datetime.datetime(2023, 11, 5),
                    datetime.datetime(2023, 7, 1)):
            want = day.replace(tzinfo=tz).astimezone(UTC)
            assert ttables._local_midnight_utc(day, zone) == want, (zone, day)


# ---------------------------------------------------------------------------
# rng
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", [0, 1, 2, 12345, 2**31 - 1])
def test_fold_in_is_bitwise(data):
    keys = jax.random.split(jax.random.PRNGKey(17), 5)
    want = np.stack([np.asarray(jax.random.fold_in(k, data)) for k in keys])
    got = rng.fold_in(torch.as_tensor(np.asarray(keys).astype(np.int64)), data)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    one = rng.fold_in(rng.PRNGKey(17), data)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jax.random.fold_in(jax.random.PRNGKey(17), data)))


@pytest.mark.parametrize("shape, maxval", [((), 4), ((), 1), ((3,), 7), ((2, 5), 1000)])
def test_batched_randint_is_bitwise(shape, maxval):
    keys = jax.random.split(jax.random.PRNGKey(23), 64)
    want = jax.vmap(lambda k: jax.random.randint(k, shape, 0, maxval))(keys)
    got = rng.randint(torch.as_tensor(np.asarray(keys).astype(np.int64)), shape, 0, maxval)
    assert got.shape == (64,) + shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Suite
# ---------------------------------------------------------------------------


def _small_suite_configs(lib):
    """tests/test_suite_and_render.py:small_suite_configs on either package."""
    base = lib.two_zone_test_config()
    plan2 = np.full((10, 10), 2.0)
    plan2[1:9, 1:9] = 1.0
    plan2[2:8, 2:5] = 0.0
    plan2[2:8, 6:8] = 0.0
    cfg2 = dataclasses.replace(
        base, building=dataclasses.replace(base.building, floor_plan=plan2))
    return [base, cfg2]


def _tree(state):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def _states_close(jstate, tstate, label):
    want = dict(_flat(_tree(jstate)))
    for name, got in _flat(convert.env_state_to_numpy(tstate)):
        w = want[name]
        assert got.shape == w.shape, f"{label} {name}"
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(got, w, err_msg=f"{label} {name}")
        elif name == "temp":
            np.testing.assert_allclose(got, w, atol=FIELD_ATOL, rtol=0,
                                       err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-3,
                                       err_msg=f"{label} {name}")


def test_suite_matches_jax():
    per = 3
    js = jsuite.BuildingSuite(_small_suite_configs(jpresets))
    ts = tsuite.BuildingSuite(_small_suite_configs(tpresets), device="cpu")
    assert ts.n_buildings == 2 and ts.obs_dim == js.obs_dim
    jstates, jobs = js.reset(jax.random.PRNGKey(0), envs_per_building=per)
    tstates, tobs = ts.reset(rng.PRNGKey(0), envs_per_building=per)
    assert tobs.shape == (2 * per, ts.obs_dim)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=OUT_ATOL, rtol=0)
    for i in range(2):
        _states_close(jstates[i], tstates[i], f"reset building {i}")
    actions = np.random.default_rng(4).uniform(-1, 1, (2, 2 * per, ts.n_actions))
    jstep = jax.jit(lambda s, a: js.step(s, a, use_pallas=False))
    for k, a in enumerate(actions.astype(np.float32)):
        jstates, jout = jstep(jstates, jnp.asarray(a))
        tstates, tout = ts.step(tstates, torch.as_tensor(a), use_pallas=False)
        for i in range(2):
            _states_close(jstates[i], tstates[i], f"step {k} building {i}")
        for field in ("observation", "reward", "done"):
            np.testing.assert_allclose(getattr(tout, field).numpy(),
                                       np.asarray(getattr(jout, field)),
                                       atol=OUT_ATOL, rtol=0, err_msg=field)
        for f in dataclasses.fields(tout.reward_breakdown):
            got = getattr(tout.reward_breakdown, f.name).numpy()
            want = np.asarray(getattr(jout.reward_breakdown, f.name))
            assert got.shape == want.shape == (2 * per,), f.name
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=OUT_ATOL, err_msg=f.name)
    assert tstates[0].temp.shape[1:] != tstates[1].temp.shape[1:]


def test_suite_refuses_mismatched_action_space():
    base = tpresets.two_zone_test_config()
    narrowed = dataclasses.replace(base, action_normalizers={
        "supply_water_setpoint": base.action_normalizers["supply_water_setpoint"]})
    with pytest.raises(ValueError, match="action space"):
        tsuite.BuildingSuite([base, narrowed], device="cpu")


def test_building_suite_plans_have_jax_grid_shapes():
    jconfigs = jpresets.building_suite(num_days_in_episode=1)
    tconfigs = tpresets.building_suite(num_days_in_episode=1)
    assert len(tconfigs) == 3
    shapes = []
    for jc, tc in zip(jconfigs, tconfigs):
        np.testing.assert_array_equal(tc.building.floor_plan, jc.building.floor_plan)
        for part in ("weather", "convection", "schedule", "occupancy"):
            assert (dataclasses.asdict(getattr(tc, part))
                    == dataclasses.asdict(getattr(jc, part))), part
        shape = tbe.build_geometry(tc).shape
        assert shape == jbe.build_geometry(jc).shape
        shapes.append(shape)
    assert shapes == [(52, 67), (59, 46), (41, 109)]


# ---------------------------------------------------------------------------
# Checkpoint and metrics
# ---------------------------------------------------------------------------


def _trainer():
    env = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    return ttrain.SACTrainer(env, ttrain.recipe_for(
        env, n_envs=2, batch_size=4, replay_capacity=64, seed_steps=0))


def _equal_states(a, b, trainer):
    ta = dict(_flat(convert.train_state_to_numpy(a, trainer)))
    tb = dict(_flat(convert.train_state_to_numpy(b, trainer)))
    assert ta.keys() == tb.keys()
    for name, value in ta.items():
        assert value.dtype == tb[name].dtype, name
        np.testing.assert_array_equal(value, tb[name], err_msg=name)


def test_checkpoint_round_trip_and_resume(tmp_path):
    trainer = _trainer()
    state = trainer.init(rng.PRNGKey(0))
    ckpt = tckpt.TrainCheckpointer(str(tmp_path / "ckpt"), trainer, max_to_keep=2)
    assert ckpt.latest_step() is None
    for step in range(1, 5):
        state, _ = trainer.train_step(state)
        if step % 2 == 0:
            ckpt.save(step, state)
    assert ckpt.latest_step() == 4 and ckpt.steps() == [2, 4]
    template = trainer.init(rng.PRNGKey(1))
    _equal_states(ckpt.restore(template), state, trainer)
    # A run resumed from step 2 equals the uninterrupted one at step 4.
    resumed = ckpt.restore(template, step=2)
    for _ in range(2):
        resumed, _ = trainer.train_step(resumed)
    _equal_states(resumed, state, trainer)
    ckpt.save(6, resumed)
    assert ckpt.steps() == [4, 6]
    assert not [n for n in os.listdir(tmp_path / "ckpt") if n.endswith(".tmp")]
    # A template of another structure is refused.
    other = ttrain.SACTrainer(trainer.env, ttrain.recipe_for(
        trainer.env, n_envs=4, batch_size=4, replay_capacity=64, seed_steps=0))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(other.init(rng.PRNGKey(1)))
    ckpt.close()
    with pytest.raises(FileNotFoundError):
        tckpt.TrainCheckpointer(str(tmp_path / "empty"), trainer).restore(template)


def test_port_checkpoint_loads_into_the_jax_train_state(tmp_path):
    trainer = _trainer()
    state = trainer.init(rng.PRNGKey(3))
    for _ in range(2):
        state, _ = trainer.train_step(state)
    ckpt = tckpt.TrainCheckpointer(str(tmp_path), trainer)
    ckpt.save(2, state)
    jenv = jbe.BuildingEnv(jpresets.two_zone_test_config())
    jt = jtrain.SACTrainer(jenv, jtrain.recipe_for(
        jenv, n_envs=2, batch_size=4, replay_capacity=64, seed_steps=0))
    template = jax.jit(jt.init)(jax.random.PRNGKey(0))
    restored = flax.serialization.from_state_dict(template, ckpt.read(2))
    got = dict(_flat(_tree(restored)))
    want = dict(_flat(convert.train_state_to_numpy(state, trainer)))
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert int(restored.env_steps) == state.env_steps


def test_metrics_jsonl_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "metrics.jsonl")
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t: copies.append(1) or real_cpu(t))
    acc = tmetrics.MetricsAccumulator(path, reporting_interval=2)
    acc.record({"reward": torch.tensor(-0.5), "loss": torch.tensor(1.0)})
    assert len(copies) == 1
    acc.record({"reward": -0.3, "loss": torch.tensor(0.6)})
    acc.record({"reward": torch.tensor(-0.1), "loss": 0.2})
    acc.close()
    cols = tmetrics.load_metrics(path)
    assert list(cols) == ["step", "time", "reward", "loss"]
    np.testing.assert_array_equal(cols["step"], [2, 3])
    assert cols["reward"][0] == pytest.approx(-0.4)
    assert cols["loss"][1] == pytest.approx(0.2)
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == 2


def test_metrics_tensorboard_export_or_one_warning(tmp_path, monkeypatch):
    scalars = []

    class Writer:
        def __init__(self, logdir):
            self.logdir = logdir

        def add_scalar(self, key, value, global_step):
            scalars.append((key, value, global_step))

        def flush(self):
            pass

        def close(self):
            scalars.append("closed")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    acc = tmetrics.MetricsAccumulator(tensorboard_dir=str(tmp_path), reporting_interval=1)
    acc.record({"alpha": torch.tensor(0.5)})
    acc.close()
    assert scalars == [("alpha", 0.5, 1), "closed"]
    # Where torch.utils.tensorboard does not import, export is off with a warning.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.warns(RuntimeWarning, match="TensorBoard export is off"):
        acc = tmetrics.MetricsAccumulator(tensorboard_dir=str(tmp_path))
    acc.record({"alpha": 0.5})
    acc.close()


# ---------------------------------------------------------------------------
# examples/train_sac.py
# ---------------------------------------------------------------------------


def test_train_sac_small_on_the_cpu(tmp_path, monkeypatch):
    from sbsim_tpu_torch.examples import train_sac

    # TensorBoard off (its import takes tens of seconds where it pulls in
    # TensorFlow); the accumulator warns once.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = tmp_path / "run"
    with pytest.warns(RuntimeWarning, match="TensorBoard"):
        run = train_sac.main([
            "--small", "--cpu", "--n_envs", "2", "--batch_size", "4",
            "--replay_capacity", "64", "--seed_episodes_steps", "6", "--train_steps", "4",
            "--eval_every", "2", "--eval_steps", "2", "--num_days_in_episode", "1",
            "--output_dir", str(out)])
    assert run.env.device.type == "cpu"
    assert run.state.env_steps == 2 * (3 + 4)
    assert int(run.state.replay.size) == 7
    assert np.isfinite(run.baseline_reward) and np.isfinite(run.final_return)
    ckpt = tckpt.TrainCheckpointer(str(out / "ckpt"), run.trainer)
    assert ckpt.steps() == [2, 4]
    _equal_states(ckpt.restore(run.state), run.state, run.trainer)
    # The JSONL file holds one row per 100 records: the final flush's.
    cols = tmetrics.load_metrics(str(out / "train_metrics.jsonl"))
    np.testing.assert_array_equal(cols["step"], [4])
    assert all(np.isfinite(v).all() for v in cols.values())


def test_train_sac_needs_a_card_without_cpu(monkeypatch, tmp_path):
    from sbsim_tpu_torch.examples import train_sac

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_sac.main(["--small", "--output_dir", str(tmp_path)])

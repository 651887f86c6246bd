"""The sb1 day's threshold crossing is the JAX package's own.

Over the sb1 day (step-function occupancy, no convection) the port's
per-env step on the CPU (K2's plain version) and the exact host disagree
on zone 0's thermostat mode at step 192: zone 0 sits at its 294 K heating
setpoint, and the device path's float32 drift of a few mK puts it on the
other side. The JAX package's per-env step run op by op
(`jax.disable_jit()`, so XLA contracts no multiply-add into an FMA) takes
the same path: its field is the port's bitwise at every step, and it
switches zone 0 to heating at step 192 as the port does, while the host
does not. This is the evidence behind exact_host.ParityTracker's recovery
window on that day (tests/test_torch_exact_host.py, chip_smoke.py phase 9
(a) and (b)); the jitted JAX package passes the strict gate of
tests/test_device_vs_host.py only through XLA's FMA contraction.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sbsim_tpu.envs import building_env as jbe
from sbsim_tpu.envs import presets as jpresets
from sbsim_tpu_torch import rng
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import exact_host as teh
from sbsim_tpu_torch.envs import presets as tpresets

SETPOINTS = {"supply_water_setpoint": 340.0,
             "supply_air_heating_temperature_setpoint": 285.0}
CROSSING_STEP = 192
MODE_HEAT = teh.MODE_HEAT


def _config(presets):
    cfg = presets.sb1_config(num_days_in_episode=1, convection_p=0.0)
    return dataclasses.replace(cfg, occupancy=dataclasses.replace(cfg.occupancy,
                                                                  kind="step_function"))


def test_sb1_crossing_is_the_jax_package_s_own_op_by_op():
    jenv = jbe.BuildingEnv(_config(jpresets))
    tenv = tbe.BuildingEnv(_config(tpresets), device="cpu")
    host = teh.ExactHostSimulator(tenv)
    tracker = teh.ParityTracker()
    tstate, _ = tenv.reset(rng.PRNGKey(0)[None])
    taction = torch.as_tensor(tenv.default_action(SETPOINTS))[None]
    with jax.disable_jit():
        jstate, _ = jenv.reset(jax.random.PRNGKey(0))
        jaction = jnp.asarray(jenv.default_action(SETPOINTS))
        for i in range(CROSSING_STEP + 1):
            jstate, _ = jenv.step(jstate, jaction)
            tstate, _ = tenv.step(tstate, taction)
            host.step(SETPOINTS)
            temp = tstate.temp[0].numpy()
            np.testing.assert_array_equal(temp, np.asarray(jstate.temp), err_msg=f"step {i}")
            np.testing.assert_array_equal(tstate.hvac.zone_air_temp[0].numpy(),
                                          np.asarray(jstate.hvac.zone_air_temp),
                                          err_msg=f"step {i}")
            modes = tstate.hvac.thermostat_mode[0].tolist()
            assert modes == np.asarray(jstate.hvac.thermostat_mode).tolist(), i
            if i < CROSSING_STEP:
                assert modes == host.mode, i
            tracker.check(i, temp, modes, tstate.hvac.zone_air_temp[0].tolist(), host)
    assert modes[0] == MODE_HEAT and host.mode[0] != MODE_HEAT
    assert modes[1:] == host.mode[1:]
    ((step, zones, margin),) = tracker.report.crossings
    assert (step, zones) == (CROSSING_STEP, (0,)) and margin < 1e-2

"""The 126-room parity day against a float64 exact host, on the CPU.

`fullscale_parity_check.parity_day` holds the port's 126-room day (K2's
plain version here, bitwise K2 on the card) against the float32 exact host
(`ExactHostSimulator` over `reference_impl.tf_jacobi_step`, float32 as the
reference's TF simulator). Zone 28 crosses its heating setpoint at step 143
on the port and not on that host (`chip_smoke.PARITY126_WITNESS`), and the
jitted JAX package, whose multiply-adds XLA contracts, holds the day. This
file asks a float64 host which float32 path is nearer the exact day: one
`ExactHostSimulator` runs with a float64 copy of `tf_jacobi_step`
monkeypatched in for its own steps, so its temperatures stay float64 all
day, beside the float32 host and the port, in the transposed layout
("auto", 189 x 124) of the full-scale bench:

* the float32 host leaves the float64 host at step 143, zone 28 only:
  where the port leaves the float32 host;
* the port keeps its thermostat modes identical to the float64 host's
  through step 172 and first differs at step 173, zone 84;
* through step 142 the port's largest |dT| to the float64 host (1.114e-3
  K; 1.285e-3 K through step 172) stays below the float32 host's own
  (5.155e-3 K).

In the afternoon most zones sit at the setpoint, where no two float32
paths keep identical modes: the port is the float32 path nearest the
float64 day. Run as a script, the file prints the same comparison over the
whole day for a layout:

    PYTHONPATH=. python tests/test_torch_parity126.py [auto|ref] [STEPS]
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from sbsim_tpu_torch import rng
from sbsim_tpu_torch.benchmarks import fullscale_parity_check as fpc
from sbsim_tpu_torch.envs.building_env import BuildingEnv
from sbsim_tpu_torch.envs.exact_host import ExactHostSimulator
from sbsim_tpu_torch.physics import reference_impl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (step, zones) of the port's first mode difference from the float64 host.
PORT_F64_WITNESS = (173, [84])
PAIRS = (("f32", "f64"), ("port", "f64"), ("port", "f32"))


def tf_jacobi_step_f64(geom, temp_estimates, temp_minus, input_q, ambient_temperature,
                       convection_coefficient, time_step_sec):
    """reference_impl.tf_jacobi_step with every array and scalar in float64
    (the same op order)."""
    f64 = np.float64
    x = np.asarray(temp_estimates).astype(f64)
    t_minus = np.asarray(temp_minus).astype(f64)
    q = np.asarray(input_q).astype(f64)
    rho = np.asarray(geom.density).astype(f64)
    cp = np.asarray(geom.heat_capacity).astype(f64)
    z = f64(geom.floor_height_m)
    dt = f64(time_step_sec)
    t_inf = f64(ambient_temperature)
    h = f64(convection_coefficient)
    u = np.asarray(geom.u).astype(f64)
    v = np.asarray(geom.v).astype(f64)
    uz = z * u
    vz = z * v
    k1_div_u = np.asarray(geom.k_left).astype(f64) / u
    k3_div_u = np.asarray(geom.k_right).astype(f64) / u
    k2_div_v = np.asarray(geom.k_bottom).astype(f64) / v
    k4_div_v = np.asarray(geom.k_top).astype(f64) / v
    h_l = h * np.asarray(geom.h_left).astype(f64)
    h_r = h * np.asarray(geom.h_right).astype(f64)
    h_t = h * np.asarray(geom.h_top).astype(f64)
    h_b = h * np.asarray(geom.h_bottom).astype(f64)
    t_left = np.pad(x, ((0, 0), (0, 1)), constant_values=t_inf)[:, 1:]
    t_right = np.pad(x, ((0, 0), (1, 0)), constant_values=t_inf)[:, :-1]
    t_above = np.pad(x, ((1, 0), (0, 0)), constant_values=t_inf)[:-1, :]
    t_below = np.pad(x, ((0, 1), (0, 0)), constant_values=t_inf)[1:, :]
    dt1 = vz * (k1_div_u + k3_div_u + h_l + h_r)
    dt2 = uz * (k2_div_v + k4_div_v + h_b + h_t)
    dt3 = rho * u * v * cp * z * cp / dt
    denom = dt1 + dt2 + dt3
    nt1 = vz * (k1_div_u * t_left + k3_div_u * t_right + h_l * t_inf + h_r * t_inf)
    nt2 = uz * (k2_div_v * t_below + k4_div_v * t_above + h_b * t_inf + h_t * t_inf)
    nt3 = rho * u * v * cp * z * cp * t_minus / dt
    numer = nt1 + nt2 + nt3 + q
    x_new = numer / denom
    x_new = np.where(np.asarray(geom.exterior_mask), t_inf, x_new)
    return x_new, float(np.max(np.abs(x_new - x)))


@contextlib.contextmanager
def float64_solve():
    """Within the block, the exact host's FDM solve runs in float64."""
    saved = reference_impl.tf_jacobi_step
    reference_impl.tf_jacobi_step = tf_jacobi_step_f64
    try:
        yield
    finally:
        reference_impl.tf_jacobi_step = saved


def run_day(layout: str, steps: int) -> dict:
    """`steps` steps of parity_day's contract with the port (K2's plain
    version on the CPU), the float32 host and the float64 host side by
    side; each path's modes per step and each pair's max |dT| per step."""
    env = BuildingEnv(fpc.parity_config(layout), device="cpu")
    host32, host64 = ExactHostSimulator(env), ExactHostSimulator(env)
    state, _ = env.reset(rng.PRNGKey(0)[None])
    action = torch.as_tensor(env.default_action(fpc.SETPOINTS))[None]
    modes = {"port": [], "f32": [], "f64": []}
    drifts = {pair: [] for pair in PAIRS}
    for _ in range(steps):
        state, _ = env.step(state, action)
        host32.step(fpc.SETPOINTS)
        with float64_solve():
            host64.step(fpc.SETPOINTS)
        temps = {"port": state.temp[0].numpy().astype(np.float64),
                 "f32": host32.temp.astype(np.float64), "f64": host64.temp}
        modes["port"].append(state.hvac.thermostat_mode[0].tolist())
        modes["f32"].append(list(host32.mode))
        modes["f64"].append(list(host64.mode))
        for a, b in PAIRS:
            drifts[(a, b)].append(float(np.max(np.abs(temps[a] - temps[b]))))
    return {"modes": modes, "drifts": drifts, "dtypes": (host32.temp.dtype, host64.temp.dtype),
            "zones": env.n_zones}


def first_difference(day: dict, a: str, b: str):
    """(step, zones) of the first step where a's and b's modes differ, or
    None."""
    for i, (ma, mb) in enumerate(zip(day["modes"][a], day["modes"][b])):
        if ma != mb:
            return i, [z for z, (x, y) in enumerate(zip(ma, mb)) if x != y]
    return None


@pytest.fixture(scope="module")
def day():
    return run_day("auto", PORT_F64_WITNESS[0] + 1)


def _parity126_witness():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke.PARITY126_WITNESS


def test_float32_host_leaves_the_float64_host_where_the_port_leaves_it(day):
    """The float32 host and its float64 twin first differ in mode at step
    143, zone 28 only: PARITY126_WITNESS, where the port and the float32
    host part."""
    assert day["dtypes"] == (np.float32, np.float64) and day["zones"] == 126
    step, zones = _parity126_witness()
    assert first_difference(day, "f32", "f64") == (step, list(zones))
    assert first_difference(day, "port", "f32") == (step, list(zones))


def test_port_holds_the_float64_host_longer(day):
    """The port's modes equal the float64 host's through step 172; its
    first difference is PORT_F64_WITNESS."""
    step, _ = PORT_F64_WITNESS
    assert day["modes"]["port"][:step] == day["modes"]["f64"][:step]
    assert first_difference(day, "port", "f64") == PORT_F64_WITNESS


def test_port_drifts_less_from_float64_than_the_float32_host(day):
    """Up to step 142, the last step before the float32 host's crossing,
    the port's max |dT| to the float64 host stays below the float32 host's
    own max |dT| to it."""
    before = _parity126_witness()[0]
    port = max(day["drifts"][("port", "f64")][:before])
    f32 = max(day["drifts"][("f32", "f64")][:before])
    assert port < f32


if __name__ == "__main__":
    layout = sys.argv[1] if len(sys.argv) > 1 else "auto"
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else fpc.STEPS
    result = run_day(layout, steps)
    print(f"layout {layout}, {steps} steps; pair: first mode difference (step, zones), steps "
          "with modes differing, max |dT| before it (K), |dT| at the last step (K)")
    for a, b in PAIRS:
        first = first_difference(result, a, b)
        end = first[0] if first else steps
        differ = sum(x != y for x, y in zip(result["modes"][a], result["modes"][b]))
        drifts = result["drifts"][(a, b)]
        print(f"{a} vs {b}: {first}, {differ}, {max(drifts[:end]):.4g}, {drifts[-1]:.4g}")

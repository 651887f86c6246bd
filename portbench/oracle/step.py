"""One control step of a batch of buildings, worked out again in float64
PyTorch from the state before it and the action taken (sbsim's
environment.py:1228-1360 order, with the float64 device formulas of
sbsim_tpu_torch/envs/exact_host.py, the port's reference-faithful host
simulator): the thermostats and VAVs, the air handler and boiler, the
diffuser heat, the implicit FDM solve, the boiler's ramp, the 3C regret
reward, and each env's next key (threefry-2x32, Salmon et al. 2011, split
as jax.random splits: subkey i = threefry(key, (0, i))).

The in-room convection shuffle and the occupants' draws are random: the
reference does not draw them. A shuffle permutes the cells of each room,
so the solve is compared room by room on sorted values and cell by cell
elsewhere; the occupants the program drew are read from the state after
the step, and every change between the two states is checked against the
arrival and departure windows."""

from __future__ import annotations

import math
import types
from typing import Dict

import torch

from portbench.oracle import physics

CP_AIR, CP_WATER = 1006.0, 4180.0  # J/kg/K
WATER_DENSITY, GRAVITY = 1000.0, 9.8
GAS_CO2, KWH_PER_KFT3_GAS, JOULES_PER_KWH = 53.12, 293.07107, 3.6e6
# The boiler's tank (boiler.py:275-333 of sbsim).
TANK_LENGTH, TANK_RADIUS, INSULATION, INSULATION_K, TANK_H, TANK_WATER = (
    2.0, 0.5, 0.06, 0.067, 5.6, 1.5)
MODE_OFF, MODE_HEAT, MODE_COOL, MODE_PASSIVE_COOL = 0, 1, 2, 3
MASK = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 tensors of uint32 values."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & MASK)
    v0, v1 = (x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for block in range(5):
        for r in rot[block % 2]:
            v0 = (v0 + v1) & MASK
            v1 = _rotl(v1, r) ^ v0
        v0 = (v0 + ks[(block + 1) % 3]) & MASK
        v1 = (v1 + ks[(block + 2) % 3] + block + 1) & MASK
    return v0, v1


def subkey(keys: torch.Tensor, i: int) -> torch.Tensor:
    """Subkey i of (B, 2) keys."""
    k0, k1 = keys[:, 0].to(torch.int64), keys[:, 1].to(torch.int64)
    a, b = threefry(k0, k1, torch.zeros_like(k0), torch.full_like(k0, i))
    return torch.stack([a, b], dim=1)


class Building:
    """The configuration's building on a device: its grid, stencil and clock."""

    def __init__(self, spec: Dict, grid, clk, device):
        self.spec, self.grid, self.device = spec, grid, device
        self.dt = float(spec["time_step_sec"])
        self.stencil = physics.Stencil(grid, self.dt, device)
        from portbench.oracle import clock as clock_lib

        self.clock = clock_lib.tensors(clk, device)
        self.clock_np = clk
        z = torch.as_tensor(grid.zone_ids, device=device).view(-1)
        self.zone_of = z
        self.in_zone = z < grid.n_zones
        self.zone_size = torch.bincount(z[self.in_zone], minlength=grid.n_zones).double()
        self.diffusers = torch.as_tensor(grid.diffusers, device=device)
        self.n_steps = int(spec["num_days_in_episode"] * 24 * 3600 / self.dt)
        self.solver = spec["solver"]

    def at(self, name: str, t: torch.Tensor) -> torch.Tensor:
        table = self.clock[name]
        return table[t.clamp(0, table.shape[0] - 1)]

    def zone_means(self, temp: torch.Tensor) -> torch.Tensor:
        flat = temp.double().reshape(temp.shape[0], -1)[:, self.in_zone]
        sums = torch.zeros(temp.shape[0], self.grid.n_zones, dtype=torch.float64,
                           device=temp.device)
        sums.index_add_(1, self.zone_of[self.in_zone], flat)
        return sums / self.zone_size

    def room_sorted(self, temp: torch.Tensor) -> torch.Tensor:
        """Each room's cells sorted by value, rooms in order, (B, cells)."""
        flat = temp.double().reshape(temp.shape[0], -1)[:, self.in_zone]
        zone = self.zone_of[self.in_zone].double()
        order = torch.argsort(zone * 1.0e4 + flat, dim=1)
        return torch.gather(flat, 1, order)

    def outside_rooms(self, temp: torch.Tensor) -> torch.Tensor:
        return temp.double().reshape(temp.shape[0], -1)[:, ~self.in_zone]

    def solve(self, temp, input_q, t, rho: float = 0.0):
        s = self.solver
        return physics.solve(self.stencil, temp, input_q, self.at("ambient", t),
                             self.at("convection", t), s["convergence_threshold"],
                             s["iteration_limit"], rho)


def native_actions(spec, action: torch.Tensor) -> Dict[str, torch.Tensor]:
    a = action.double().clamp(-1.0, 1.0)
    out = {}
    for i, entry in enumerate(spec["actions"]):
        lo, hi = entry["native"]
        out[entry["field"]] = (a[:, i] + 1.0) / 2.0 * (hi - lo) + lo
    return out


def step(b: Building, s, action: torch.Tensor, after=None,
         rho: float = 0.0) -> Dict[str, torch.Tensor]:
    """What the step from state `s` (the program's leaves, any precision)
    under `action` gives, in float64. With `after`, the program's state
    after the step, the reward is worked out over its occupants (the
    program's draws), zone means and grid mean, each stage from the same
    inputs as the program's; without it, over nobody's moves and the
    reference's own solve. Keys are the state's leaves (the
    HVAC's under `hvac.`), `room_sorted` / `outside_rooms` of the new
    field, and `iterations` of the solve."""
    hv = b.spec["hvac"]
    f = lambda x: x.double()
    t = s.step_idx.to(torch.int64)
    zone_t = f(s.zone_means)
    h = s.hvac
    comfort = b.at("comfort", t)
    heat_sp, cool_sp = b.at("heating_setpoint", t)[:, None], b.at("cooling_setpoint", t)[:, None]
    mid = 0.5 * (cool_sp - heat_sp) + heat_sp
    mode = h.thermostat_mode.to(torch.int64)
    default = torch.full_like(mode, MODE_OFF)
    default = torch.where((zone_t > mid) & (mode == MODE_COOL), MODE_COOL, default)
    default = torch.where((zone_t < mid) & (mode == MODE_HEAT), MODE_HEAT, default)
    default = torch.where(zone_t > cool_sp, MODE_COOL, default)
    default = torch.where(zone_t < heat_sp, MODE_HEAT, default)
    eco = torch.where(h.prev_comfort[:, None] | ((mode == MODE_PASSIVE_COOL) & (zone_t > heat_sp)),
                      MODE_PASSIVE_COOL, default)
    mode = torch.where(comfort[:, None], default, eco)
    active = (mode == MODE_HEAT) | (mode == MODE_COOL)
    damper = torch.where(active, 1.0, 0.1).double()
    valve = torch.where(mode == MODE_HEAT, 1.0, 0.0).double()

    native = native_actions(b.spec, action)
    boiler_sp = native.get("supply_water_setpoint", f(h.boiler_setpoint))
    has_action = h.boiler_has_action | ("supply_water_setpoint" in native)
    ahu_heat = native.get("supply_air_heating_temperature_setpoint", f(h.ahu_heating_setpoint))
    ahu_cool = native.get("supply_air_cooling_temperature_setpoint", f(h.ahu_cooling_setpoint))

    r = hv["ahu_recirculation"]
    amb = b.at("ambient", t)
    mixed = r * f(s.grid_mean) + (1.0 - r) * amb
    supply = torch.minimum(torch.maximum(mixed, ahu_heat), ahu_cool)
    air = damper * hv["vav_max_air_flow_rate"]
    water = valve * hv["vav_reheat_max_water_flow_rate"]
    zone_supply = (supply[:, None] * (CP_AIR * air - CP_WATER * water)
                   + boiler_sp[:, None] * CP_WATER * water) / air / CP_AIR
    q_zone = torch.where(air > 0, air * CP_AIR * (zone_supply - zone_t), 0.0)
    ahu_flow = torch.clamp(torch.where(air > 0, air, 0.0).sum(1), max=hv["ahu_max_air_flow_rate"])
    boiler_flow = water.sum(1)
    return_water = (valve * zone_supply).sum(1) / (valve.sum(1) + 1e-6)
    zone_q = torch.cat([q_zone, torch.zeros_like(q_zone[:, :1])], dim=1)
    input_q = b.diffusers * zone_q[:, b.zone_of].view(-1, *b.grid.shape)

    new_temp, iters = b.solve(s.temp, s.input_q, t, rho)
    zone_next = b.zone_means(new_temp)
    grid_next = new_temp.mean(dim=(-2, -1))

    # The boiler's measured supply temperature ramps toward its setpoint.
    dur = torch.where(has_action, b.dt, f(h.boiler_last_step_duration))
    begin = f(h.boiler_current_temp)
    up = torch.minimum(begin + hv["boiler_heating_rate"] * dur / 60.0, boiler_sp)
    down = torch.maximum(begin - hv["boiler_cooling_rate"] * dur / 60.0, boiler_sp)
    current = torch.where(boiler_sp > begin, up, torch.where(boiler_sp < begin, down, boiler_sp))
    tank_change = current - begin

    # The 3C regret at t + 1 over the occupants the program drew.
    t1 = t + 1
    if after is None:
        occupancy, zone_r, grid_r = s.occupants.double().sum(-1), zone_next, grid_next
    else:
        occupancy = after.occupants.double().sum(-1)
        zone_r, grid_r = f(after.zone_means), f(after.grid_mean)
    amb1 = b.at("ambient", t1)
    mixed1 = r * grid_r + (1.0 - r) * amb1
    supply1 = torch.minimum(torch.maximum(mixed1, ahu_heat), ahu_cool)
    blower = ahu_flow * hv["ahu_fan_differential_pressure"] / hv["ahu_fan_efficiency"] * (2.0 - r)
    ac = ahu_flow * CP_AIR * (supply1 - mixed1)
    pump = (boiler_flow * WATER_DENSITY * GRAVITY * hv["boiler_pump_differential_head"]
            / hv["boiler_pump_efficiency"])
    supply_water = torch.maximum(boiler_sp, return_water)
    r2 = TANK_RADIUS + INSULATION
    dissipation = (2.0 * math.pi * TANK_LENGTH * (supply_water - amb1)) / (
        math.log(r2 / TANK_RADIUS) / INSULATION_K + 1.0 / (TANK_H * r2))
    tank = torch.where(dur > 0, CP_WATER * TANK_WATER * tank_change / dur.clamp(min=1e-9), 0.0)
    gas = CP_WATER * boiler_flow * (supply_water - return_water) + dissipation + tank
    reward = regret(b, t1, zone_r, occupancy, blower + ac.abs() + pump, gas)

    return {
        "temp": new_temp, "temp.room_sorted": b.room_sorted(new_temp), "temp.outside_rooms": b.outside_rooms(new_temp),
        "input_q": input_q, "zone_means": zone_next, "grid_mean": grid_next,
        "hvac.damper": damper, "hvac.reheat_valve": valve, "hvac.thermostat_mode": mode,
        "hvac.zone_air_temp": zone_t, "hvac.prev_comfort": comfort,
        "hvac.ahu_air_flow_rate": ahu_flow,
        "hvac.ahu_cooling_request_count": (air > 0).sum(1),
        "hvac.ahu_heating_setpoint": ahu_heat, "hvac.ahu_cooling_setpoint": ahu_cool,
        "hvac.boiler_setpoint": boiler_sp, "hvac.boiler_current_temp": current,
        "hvac.boiler_return_water_temp": return_water, "hvac.boiler_total_flow_rate": boiler_flow,
        "hvac.boiler_heating_request_count": (water > 0).sum(1),
        "hvac.boiler_tank_temp_change": tank_change, "hvac.boiler_last_step_duration": dur,
        "hvac.boiler_has_action": torch.ones_like(h.boiler_has_action),
        "step_idx": t1, "window": s.window.to(torch.int64), "rng": subkey(s.rng, 0),
        "fdm_converged": iters < b.solver["iteration_limit"],
        "reward": reward, "iterations": iters,
    }


def regret(b: Building, t, zone_temp, occupancy, elec_rate, gas_rate) -> torch.Tensor:
    """The normalized 3C regret of each env over the step starting at t
    (setpoint_energy_carbon_regret.py:142-291 of sbsim)."""
    rw, dt = b.spec["reward"], b.dt
    heat, cool = b.at("heating_setpoint", t)[:, None], b.at("cooling_setpoint", t)[:, None]
    k, d, top = rw["productivity_decay_stiffness"], rw["productivity_midpoint_delta"], \
        rw["max_productivity_personhour_usd"]
    below = top / (1.0 + torch.exp(-k * (zone_temp - (heat - d))))
    above = top * (1.0 - 1.0 / (1.0 + torch.exp(-k * (zone_temp - (cool + d)))))
    per_hour = torch.where(zone_temp < heat, below, torch.where(zone_temp > cool, above, top))
    productivity = (per_hour * occupancy * dt / 3600.0).sum(1)
    people = occupancy.sum(1)
    best = top * people * dt / 3600.0
    worst = rw["min_productivity_personhour_usd"] * people * dt / 3600.0
    got = torch.maximum(productivity, worst)
    prod_regret = torch.where(people > 0, (got - worst) / (best - worst).clamp(min=1e-12) - 1.0,
                              0.0)
    e_max, g_max = rw["max_electricity_rate"], rw["max_natural_gas_rate"]
    elec = torch.minimum(elec_rate, torch.full_like(elec_rate, e_max)).abs()
    gas = torch.minimum(gas_rate, torch.full_like(gas_rate, g_max)).clamp(min=0.0)
    price, carbon, gas_price = b.at("elec_price", t), b.at("elec_carbon", t), b.at("gas_price", t)
    gas_co2 = GAS_CO2 / KWH_PER_KFT3_GAS / JOULES_PER_KWH
    cost = (price * elec + gas_price * gas) / (price * e_max + gas_price * g_max)
    co2 = (carbon * elec + gas_co2 * gas) / (carbon * e_max + gas_co2 * g_max)
    w = (rw["productivity_weight"], rw["energy_cost_weight"], rw["carbon_emission_weight"])
    return (prod_regret * w[0] - cost * w[1] - co2 * w[2]) / sum(w)


def illegal_moves(b: Building, s, occupants_next) -> torch.Tensor:
    """Occupants of each env whose change over the step no window allows:
    away on a workday's arrival hours (at t or t + 1) before arriving,
    after the earliest departure hour before leaving; nobody at work on a
    day off."""
    occ = b.spec["occupancy"]
    t = s.step_idx.to(torch.int64)
    hours = [b.at("local_hour", t + i)[:, None, None] for i in (0, 1)]
    workday1 = b.at("workday_local", t + 1)[:, None, None]
    arrive_ok = sum(((h >= occ["earliest_expected_arrival_hour"])
                     & (h <= occ["latest_expected_arrival_hour"])).int() for h in hours) > 0
    depart_ok = sum((h >= occ["earliest_expected_departure_hour"]).int() for h in hours) > 0
    was, now = s.occupants, occupants_next
    bad = (~was & now & ~arrive_ok) | (was & ~now & ~depart_ok & workday1) | (now & ~workday1)
    return bad.sum(dim=(1, 2))


def reset_state(b: Building, keys: torch.Tensor):
    """A fresh episode's state for (B, 2) keys (environment.py:1165 of
    sbsim), with the program's leaf names: the initial temperature
    everywhere, no diffuser heat, the devices at their defaults with the
    boiler's ramp started, nobody in."""
    hv, n = b.spec["hvac"], keys.shape[0]
    z, dev = b.grid.n_zones, keys.device
    full = lambda v, *shape: torch.full((n,) + shape, float(v), dtype=torch.float64, device=dev)
    ints = lambda *shape: torch.zeros((n,) + shape, dtype=torch.int64, device=dev)
    flags = lambda v: torch.full((n,), v, dtype=torch.bool, device=dev)
    hvac = types.SimpleNamespace(
        damper=full(0.1, z), reheat_valve=full(0.0, z), thermostat_mode=ints(z),
        zone_air_temp=full(0.0, z), prev_comfort=flags(False), ahu_air_flow_rate=full(0.0),
        ahu_cooling_request_count=ints(), ahu_heating_setpoint=full(hv["ahu_heating_setpoint"]),
        ahu_cooling_setpoint=full(hv["ahu_cooling_setpoint"]),
        boiler_setpoint=full(hv["boiler_setpoint"]),
        boiler_current_temp=full(hv["boiler_setpoint"]), boiler_return_water_temp=full(0.0),
        boiler_total_flow_rate=full(0.0), boiler_heating_request_count=ints(),
        boiler_tank_temp_change=full(0.0), boiler_last_step_duration=full(0.0),
        boiler_has_action=flags(True))
    return types.SimpleNamespace(
        temp=full(b.grid.initial_temp, *b.grid.shape), input_q=full(0.0, *b.grid.shape),
        zone_means=full(b.grid.initial_temp, z), grid_mean=full(b.grid.initial_temp),
        hvac=hvac, occupants=torch.zeros(n, z, b.spec["occupancy"]["zone_assignment"],
                                         dtype=torch.bool, device=dev),
        step_idx=ints(), window=ints(), rng=subkey(keys, 0), fdm_converged=flags(True),
        fdm_iterations=ints())


def next_state(ref: Dict[str, torch.Tensor], occupants: torch.Tensor):
    """The state a reference step gives (the occupants as given)."""
    hvac = types.SimpleNamespace(**{k[5:]: v for k, v in ref.items() if k.startswith("hvac.")})
    return types.SimpleNamespace(
        temp=ref["temp"], input_q=ref["input_q"], zone_means=ref["zone_means"],
        grid_mean=ref["grid_mean"], hvac=hvac, occupants=occupants, step_idx=ref["step_idx"],
        window=ref["window"], rng=ref["rng"], fdm_converged=ref["fdm_converged"],
        fdm_iterations=ref["iterations"])


def illegal_at_reset(b: Building, occupants: torch.Tensor) -> torch.Tensor:
    """Occupants of each fresh env at work that the reset's one draw, at
    local hour reset_local_hour, could not have sent: any outside a
    workday's arrival hours."""
    occ, c = b.spec["occupancy"], b.clock_np
    can = c.reset_workday and (occ["earliest_expected_arrival_hour"] <= c.reset_local_hour
                               <= occ["latest_expected_arrival_hour"])
    return torch.zeros(occupants.shape[0], dtype=torch.int64, device=occupants.device) if can \
        else occupants.sum(dim=(1, 2))

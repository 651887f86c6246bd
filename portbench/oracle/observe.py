"""The agent's observation, worked out again from a state (sbsim's
environment.py:709-813 and 916-956): the air handler's and the boiler's
measurements in sorted order, each (value - mean) / std where the
configuration's table gives a variance (0 where it is zero, the raw value
where it gives none); per VAV measurement either a clipped histogram over
the zones (counts over the zone count) or per-device values in sorted
device order; the time of day and day of week as cos / sin of the UTC
timestamp's angle; comfort now and in an hour; the occupant count."""

from __future__ import annotations

import math
from typing import Dict

import torch

AHU = ("cooling_request_count", "differential_pressure_setpoint",
       "discharge_fan_speed_percentage_command", "outside_air_flowrate_sensor",
       "outside_air_temperature_sensor", "supply_air_cooling_temperature_setpoint",
       "supply_air_flowrate_sensor", "supply_air_heating_temperature_setpoint",
       "supply_fan_speed_percentage_command")
BOILER = ("heating_request_count", "supply_water_setpoint", "supply_water_temperature_sensor")
VAV = ("supply_air_damper_percentage_command", "supply_air_flowrate_setpoint",
       "zone_air_temperature_sensor")
# Fields that are not the occupant count, which the reference bounds.
OCCUPANTS = -1


def _normed(table, name: str, value: torch.Tensor) -> torch.Tensor:
    if name not in table:
        return value
    mean, var = table[name]
    return (value - mean) / math.sqrt(var) if var > 0 else torch.zeros_like(value)


def measurements(b, s, t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The devices' native readings of state `s` at step t (float64)."""
    hv, h = b.spec["hvac"], s.hvac
    f = lambda x: x.double()
    flow = f(h.ahu_air_flow_rate)
    fan = flow / hv["ahu_max_air_flow_rate"]
    full = lambda v: torch.full_like(flow, float(v))
    zones = f(h.zone_air_temp)
    return {
        "cooling_request_count": f(h.ahu_cooling_request_count),
        "differential_pressure_setpoint": full(hv["ahu_fan_differential_pressure"]),
        "discharge_fan_speed_percentage_command": fan,
        "outside_air_flowrate_sensor": (1.0 - hv["ahu_recirculation"]) * flow,
        "outside_air_temperature_sensor": b.at("ambient", t),
        "supply_air_cooling_temperature_setpoint": f(h.ahu_cooling_setpoint),
        "supply_air_flowrate_sensor": flow,
        "supply_air_heating_temperature_setpoint": f(h.ahu_heating_setpoint),
        "supply_fan_speed_percentage_command": fan,
        "heating_request_count": f(h.boiler_heating_request_count),
        "supply_water_setpoint": f(h.boiler_setpoint),
        "supply_water_temperature_sensor": f(h.boiler_current_temp),
        "supply_air_damper_percentage_command": f(h.damper),
        "supply_air_flowrate_setpoint": torch.full_like(zones, hv["vav_max_air_flow_rate"]),
        "zone_air_temperature_sensor": zones,
    }


def observation(b, s, t: torch.Tensor, occupants: torch.Tensor) -> torch.Tensor:
    """(B, fields) float64: the observation of state `s` at step t with
    `occupants` (B,) people in, its last field the occupant count."""
    cfg = b.spec["observation"]
    table = cfg["normalization"]
    m = measurements(b, s, t)
    ahu = [n for n in AHU if cfg["ahu_observes_outside_air"] or n != "outside_air_temperature_sensor"]
    cols = [_normed(table, n, m[n])[:, None] for n in ahu + list(BOILER)]
    passthrough = []
    for n in VAV:
        v = _normed(table, n, m[n])
        edges = cfg["histograms"].get(n)
        if edges is None:
            passthrough.append(v)
            continue
        e = torch.tensor(edges, dtype=torch.float64, device=v.device)
        idx = (v.clamp(e[0], e[-1])[..., None] >= e[1:]).sum(-1)
        counts = (idx[..., None] == torch.arange(len(edges), device=v.device)).sum(-2).double()
        cols.append(counts / counts.sum(-1, keepdim=True))
    if passthrough:
        order = sorted(range(b.grid.n_zones), key=lambda z: f"vav_room_{z + 1}")
        cols.append(torch.stack(passthrough, -1)[:, order].reshape(len(t), -1))
    for name, n in (("hod", cfg["hod_features"]), ("dow", cfg["dow_features"])):
        rad = b.at(name + "_rad", t)[:, None] + 2.0 * math.pi * torch.arange(
            n, dtype=torch.float64, device=t.device) / n
        cols += [torch.cos(rad), torch.sin(rad)]
    c = cfg["occupancy_normalization_constant"]
    cols += [b.at("comfort", t).double()[:, None], b.at("comfort_soon", t).double()[:, None],
             ((occupants.double().trunc() - c) / (c + 1.0))[:, None]]
    return torch.cat(cols, dim=1)


def occupants_between(b, s, occupants_next) -> tuple:
    """(least, most) people the observation after the step can count: its
    probe comes between the step's two draws, so each occupant is as at
    the start or as at the end, or, where the step leaves the arrival hours
    for the departure hours, away at both and in between."""
    occ = b.spec["occupancy"]
    t = s.step_idx.to(torch.int64)
    h0, h1 = (b.at("local_hour", t + i)[:, None, None] for i in (0, 1))
    workday = b.at("workday_local", t)[:, None, None]
    was, now = s.occupants, occupants_next
    round_trip = (workday & (h0 >= occ["earliest_expected_arrival_hour"])
                  & (h0 <= occ["latest_expected_arrival_hour"])
                  & (h1 >= occ["earliest_expected_departure_hour"]) & ~was & ~now)
    least = (was & now & workday).sum(dim=(1, 2))
    most = (was | now | round_trip).sum(dim=(1, 2))
    return least, most

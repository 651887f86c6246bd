"""Proto host boundary: the BaseBuilding contract over the device env.

Port of sbsim_tpu/envs/host_adapter.py. `SimulatedBuilding` implements the
reference's building abstraction (models/base_building.py:27-95):
`request_observations` / `request_action` / `wait_time` / `reset` /
`devices` / `zones` / `reward_info`, speaking the wire-compatible protos.
This is the interop surface through which a policy written against a
*real* building drives the simulator (and vice versa); the device step
never touches protos.

The building is one env of the BuildingEnv, held as a batch of one on the
env's device, stepped by `BuildingEnv.captured_step` (`step` as a captured
program, the JAX adapter's `jax.jit(env.step)`: K2, or K1 for a Chebyshev
config, on the card). The action is made from the pending setpoints on the
host before the step, and the observation and reward breakdown are read
back after it, outside the program. Each call that reads the state makes
one host copy of what it reads; the step count and the scenario tables
are kept on the host.

`RejectionSimulatedBuilding` reproduces the fault-injection decorator that
refuses the first N action requests
(rejection_simulator_building.py:34-124) - the environment converts the
raised RuntimeError into an action-rejection reward.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sbsim_tpu_torch import rng as rng_lib
from sbsim_tpu_torch.envs import observation as obs_lib
from sbsim_tpu_torch.envs import reward as reward_lib
from sbsim_tpu_torch.envs.building_env import BuildingEnv
from sbsim_tpu_torch.hvac import devices as hvac_ops
from sbsim_tpu_torch.interfaces import BaseBuilding
from sbsim_tpu_torch.proto import building_pb2, reward_pb2
from sbsim_tpu_torch.scenario import occupancy as occupancy_lib
from sbsim_tpu_torch.scenario import weather as weather_lib
from sbsim_tpu_torch.utils.conversions import as_utc, pandas_to_proto_timestamp

DeviceInfo = building_pb2.DeviceInfo
ValueType = building_pb2.DeviceInfo.ValueType
ActionResponseType = building_pb2.SingleActionResponse.ActionResponseType


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors on one device -> flat float32 numpy arrays, in one
    device-to-host copy."""
    flat = torch.cat([v.reshape(-1).to(torch.float32) for v in tensors.values()]).cpu().numpy()
    out, i = {}, 0
    for name, v in tensors.items():
        out[name] = flat[i:i + v.numel()]
        i += v.numel()
    return out


class SimulatedBuilding(BaseBuilding):
    """Single-env, host-driven facade over BuildingEnv."""

    def __init__(self, env: BuildingEnv, seed: int = 0):
        if env.config.episode_windows > 1:
            # The JAX adapter indexes the (W, T) window tables by the step
            # alone and ignores the window's start time; the port refuses.
            raise ValueError(
                "SimulatedBuilding runs one episode window; this config has "
                f"episode_windows={env.config.episode_windows}"
            )
        self._env = env
        self._key = rng_lib.PRNGKey(seed, device=env.device)
        self._start = as_utc(weather_lib.parse_timestamp(env.config.start_timestamp))
        self._dt = datetime.timedelta(seconds=env.config.time_step_sec)
        tables = env.tables
        self._comfort = np.asarray(tables.comfort)
        self._step_occupancy = np.asarray(tables.step_occupancy)
        self._heating_setpoint = np.asarray(tables.heating_setpoint)
        self._cooling_setpoint = np.asarray(tables.cooling_setpoint)
        zone_ids = np.asarray(env.geom.zone_ids).reshape(-1)
        self._zone_cells = [np.flatnonzero(zone_ids == z) for z in range(env.n_zones)]
        self._vav_max_flow = env.hvac_params.vav_max_air_flow_rate.cpu().numpy()
        self._pending_setpoints: Dict[str, float] = {}
        self._last_breakdown = None
        self._build_device_infos()
        self.reset()

    # ------------------------------------------------------------------
    # Metadata
    # ------------------------------------------------------------------

    def _build_device_infos(self) -> None:
        env = self._env
        cfg = env.config
        self._device_infos: List[DeviceInfo] = []

        boiler = DeviceInfo(device_id="boiler", device_type=DeviceInfo.DeviceType.BLR)
        for m in obs_lib.BOILER_MEASUREMENTS:
            boiler.observable_fields[m] = ValueType.VALUE_CONTINUOUS
        boiler.action_fields["supply_water_setpoint"] = ValueType.VALUE_CONTINUOUS
        self._device_infos.append(boiler)

        ahu = DeviceInfo(device_id="air_handler", device_type=DeviceInfo.DeviceType.AHU)
        for m in obs_lib.AHU_MEASUREMENTS:
            if m == "outside_air_temperature_sensor" and not cfg.hvac.ahu_observes_outside_air:
                continue
            ahu.observable_fields[m] = ValueType.VALUE_CONTINUOUS
        ahu.action_fields["supply_air_heating_temperature_setpoint"] = ValueType.VALUE_CONTINUOUS
        ahu.action_fields["supply_air_cooling_temperature_setpoint"] = ValueType.VALUE_CONTINUOUS
        self._device_infos.append(ahu)

        self._zone_infos: List[building_pb2.ZoneInfo] = []
        for name, ext_id in zip(env.geom.zone_names, env.geom.zone_ext_ids):
            vav = DeviceInfo(device_id=f"vav_{name}", zone_id=ext_id,
                             device_type=DeviceInfo.DeviceType.VAV)
            for m in obs_lib.VAV_MEASUREMENTS:
                vav.observable_fields[m] = ValueType.VALUE_CONTINUOUS
            vav.action_fields["supply_air_damper_percentage_command"] = ValueType.VALUE_CONTINUOUS
            self._device_infos.append(vav)
            self._zone_infos.append(building_pb2.ZoneInfo(
                zone_id=ext_id,
                building_id="US-SIM-001",
                zone_description="Simulated zone",
                devices=[f"vav_{name}"],
                zone_type=building_pb2.ZoneInfo.ROOM,
                floor=0,
            ))
        self._vav_zone_index = {f"vav_{name}": z for z, name in enumerate(env.geom.zone_names)}
        self._valid_fields = {d.device_id: set(d.action_fields) for d in self._device_infos}

    @property
    def devices(self) -> Sequence[DeviceInfo]:
        return self._device_infos

    @property
    def zones(self) -> Sequence[building_pb2.ZoneInfo]:
        return self._zone_infos

    @property
    def time_step_sec(self) -> float:
        return self._env.config.time_step_sec

    @property
    def current_timestamp(self) -> datetime.datetime:
        """Episode start + completed steps x the time step, in UTC."""
        return self._start + self._step_idx * self._dt

    def is_comfort_mode(self, current_time: datetime.datetime) -> bool:
        t = int((as_utc(current_time) - self._start).total_seconds()
                // self._env.config.time_step_sec)
        return bool(self._comfort[self._table_step(t)])

    def _table_step(self, t: int) -> int:
        """Step t clamped into the tables, as the env's reads (and a jnp
        gather) clamp it: past the episode's end they read its last step."""
        return max(0, min(t, self._step_occupancy.shape[0] - 1))

    @property
    def num_occupants(self) -> int:
        if self._env.occupancy_params.kind == "randomized":
            total = float(occupancy_lib.zone_occupancy(self._state.occupants).sum())
        else:
            t = self._table_step(self._step_idx - 1)
            total = float(self._step_occupancy[t]) * self._env.n_zones
        return int(total)

    # ------------------------------------------------------------------
    # Control protocol
    # ------------------------------------------------------------------

    def reset(self) -> None:
        keys = rng_lib.split(self._key)
        self._key = keys[0]
        self._state, obs = self._env.reset(keys[1:])
        self._step_idx = 0
        self._last_obs_vector = obs[0].cpu().numpy()
        self._pending_setpoints = {}
        self._last_breakdown = None

    def request_observations(
        self, observation_request: building_pb2.ObservationRequest
    ) -> building_pb2.ObservationResponse:
        """Answers with current native sensor values
        (simulator_building.py:151-202)."""
        ahu_values, boiler_values, vav_values = self._env.device_values(
            self._state, self._state.step_idx.to(torch.int64))
        groups = (ahu_values, boiler_values, vav_values)
        host = _to_host({f"{g}/{m}": v for g, values in enumerate(groups)
                         for m, v in values.items()})
        ahu, boiler, vav = ({m: host[f"{g}/{m}"] for m in values}
                            for g, values in enumerate(groups))
        now = pandas_to_proto_timestamp(self.current_timestamp)
        response = building_pb2.ObservationResponse(timestamp=now)
        response.request.CopyFrom(observation_request)
        for sreq in observation_request.single_observation_requests:
            sres = response.single_observation_responses.add()
            sres.single_observation_request.CopyFrom(sreq)
            sres.timestamp.CopyFrom(now)
            sres.observation_valid = True
            value: Optional[float] = None
            if sreq.device_id == "air_handler":
                v = ahu.get(sreq.measurement_name)
                value = None if v is None else float(v[0])
            elif sreq.device_id == "boiler":
                v = boiler.get(sreq.measurement_name)
                value = None if v is None else float(v[0])
            elif sreq.device_id in self._vav_zone_index:
                v = vav.get(sreq.measurement_name)
                value = None if v is None else float(v[self._vav_zone_index[sreq.device_id]])
            if value is None:
                sres.observation_valid = False
            else:
                sres.continuous_value = value
        return response

    def default_observation_request(self) -> building_pb2.ObservationRequest:
        """All devices/fields, sorted (environment.py:543-553)."""
        request = building_pb2.ObservationRequest()
        for device in sorted(self._device_infos, key=lambda d: d.device_id):
            for m in sorted(device.observable_fields):
                request.single_observation_requests.add(
                    device_id=device.device_id, measurement_name=m)
        return request

    def request_action(
        self, action_request: building_pb2.ActionRequest
    ) -> building_pb2.ActionResponse:
        """Buffers agent setpoints; they apply on the next wait_time().

        Mirrors simulator_building.py:204-263 response semantics (the
        default-thermostat phase runs inside the device step in the same
        order as the reference).
        """
        response = building_pb2.ActionResponse(
            timestamp=pandas_to_proto_timestamp(self.current_timestamp))
        response.request.CopyFrom(action_request)
        for sreq in action_request.single_action_requests:
            sres = response.single_action_responses.add()
            sres.request.CopyFrom(sreq)
            if sreq.device_id not in self._valid_fields:
                sres.response_type = ActionResponseType.REJECTED_INVALID_DEVICE
                continue
            if sreq.setpoint_name not in self._valid_fields[sreq.device_id]:
                sres.response_type = ActionResponseType.REJECTED_NOT_ENABLED_OR_AVAILABLE
                continue
            # The float32 value the proto holds, as the reference reads it.
            self._pending_setpoints[sreq.setpoint_name] = sreq.continuous_value
            sres.response_type = ActionResponseType.ACCEPTED
        return response

    def wait_time(self) -> None:
        """Advances the simulation by one time step."""
        env = self._env
        hvac = self._state.hvac
        defaults = {k: float(v[0]) for k, v in _to_host({
            "supply_water_setpoint": hvac.boiler_setpoint,
            "supply_air_heating_temperature_setpoint": hvac.ahu_heating_setpoint,
            "supply_air_cooling_temperature_setpoint": hvac.ahu_cooling_setpoint,
        }).items()}
        action = np.zeros((1, env.n_actions), np.float32)
        for i, (_, field, n) in enumerate(env.action_entries):
            native = self._pending_setpoints.get(field, defaults[field])
            native = min(max(native, n.min_native_value), n.max_native_value)
            ratio = (native - n.min_native_value) / (n.max_native_value - n.min_native_value)
            action[0, i] = ratio * 2.0 - 1.0
        self._state, out = env.captured_step(self._state,
                                             torch.as_tensor(action, device=env.device))
        self._step_idx += 1
        names = [f.name for f in dataclasses.fields(out.reward_breakdown)]
        host = _to_host({"observation": out.observation[0],
                         **{k: getattr(out.reward_breakdown, k)[0] for k in names}})
        self._last_obs_vector = host["observation"]
        self._last_breakdown = reward_lib.RewardBreakdown(**{k: host[k][0] for k in names})
        self._pending_setpoints = {}

    @property
    def reward_info(self) -> reward_pb2.RewardInfo:
        """RewardInfo proto from the current post-step state
        (simulator_flexible_floor_plan.py:285-313)."""
        env = self._env
        t = self._table_step(self._step_idx)
        start = self.current_timestamp
        info = reward_pb2.RewardInfo(
            start_timestamp=pandas_to_proto_timestamp(start),
            end_timestamp=pandas_to_proto_timestamp(start + self._dt))
        state, params = self._state, env.hvac_params
        hvac = state.hvac
        ambient = env._tab["ambient_temp"][0, t:t + 1]
        device = {
            "temp": state.temp[0],
            "flow": hvac.ahu_air_flow_rate,
            "blower": hvac_ops.ahu_blower_power(hvac, params),
            # The AHU's recirculation temperature is the mean of the whole
            # field here, as in the JAX adapter.
            "ac": hvac_ops.ahu_thermal_energy_rate(hvac, state.temp.mean(), ambient, params),
            "gas": hvac_ops.boiler_thermal_energy_rate(hvac, ambient, params),
            "pump": hvac_ops.boiler_pump_power(hvac, params),
        }
        randomized = env.occupancy_params.kind == "randomized"
        if randomized:
            device["occ"] = occupancy_lib.zone_occupancy(state.occupants)[0]
        host = _to_host(device)
        temps = host["temp"]
        occ = host["occ"] if randomized else np.full(env.n_zones, float(self._step_occupancy[t]))
        heat_sp = float(self._heating_setpoint[t])
        cool_sp = float(self._cooling_setpoint[t])
        flow = float(host["flow"][0])
        for z, ext_id in enumerate(env.geom.zone_ext_ids):
            zinfo = info.zone_reward_infos[ext_id]
            zinfo.heating_setpoint_temperature = heat_sp
            zinfo.cooling_setpoint_temperature = cool_sp
            zinfo.zone_air_temperature = float(temps[self._zone_cells[z]].mean())
            zinfo.air_flow_rate_setpoint = float(self._vav_max_flow[z])
            zinfo.air_flow_rate = flow
            zinfo.average_occupancy = float(occ[z])
        ahu_info = info.air_handler_reward_infos["air_handler"]
        ahu_info.blower_electrical_energy_rate = float(host["blower"][0])
        ahu_info.air_conditioning_electrical_energy_rate = float(host["ac"][0])
        boiler_info = info.boiler_reward_infos["boiler"]
        boiler_info.natural_gas_heating_energy_rate = float(host["gas"][0])
        boiler_info.pump_electrical_energy_rate = float(host["pump"][0])
        return info


class RejectionSimulatedBuilding:
    """Raises on the first N action requests (fault injection;
    rejection_simulator_building.py:34-124). All else delegates."""

    def __init__(self, base: SimulatedBuilding, num_rejections: int):
        self._base = base
        self._num_rejections = num_rejections
        self._request_count = 0

    def request_action(self, action_request):
        self._request_count += 1
        if self._request_count <= self._num_rejections:
            raise RuntimeError(
                "Action request rejected: building not yet enabled "
                f"({self._request_count}/{self._num_rejections})"
            )
        return self._base.request_action(action_request)

    def __getattr__(self, name):
        return getattr(self._base, name)

"""Single-env, host-driven RL environment with metrics recording.

Port of sbsim_tpu/envs/host_environment.py, the gym-style counterpart of
the reference's TF-Agents `Environment` (environment.py:352-1403) for host
loops: drives any BaseBuilding-contract building (the simulated
SimulatedBuilding, its rejection decorator, or a real building endpoint)
through the proto protocol, records proto shards + metrics per episode, and
converts action rejections into the -inf rejection reward
(environment.py:52, 1266-1309).

Batched training uses envs/building_env.py directly; this wrapper exists
for the interop/fault-injection/metrics surface and for stepping a real
building with a trained policy.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np

from sbsim_tpu_torch.envs.building_env import BuildingEnv
from sbsim_tpu_torch.io import records as records_lib
from sbsim_tpu_torch.proto import building_pb2, reward_pb2
from sbsim_tpu_torch.utils import profiling

ACTION_REJECTION_REWARD: float = -np.inf

StepType = int
FIRST, MID, LAST = 0, 1, 2


def _init_metrics() -> dict:
    """Empty per-step timeseries store (plot_utils.py:441-454)."""
    return {
        "timestamps": [],
        "ambient_temps": [],
        "avg_temps_timeseries": {},  # zone_id -> [K per step]
        "boiler_gas_energy_rates": [],
        "boiler_pump_energy_rates": [],
        "air_handler_blower_energy_rates": [],
        "air_handler_ac_energy_rates": [],
        "rewards": [],
        "productivity_rewards": [],
        "electricity_energy_costs": [],
        "natural_gas_energy_costs": [],
        "carbon_emitted": [],
        "occupancy": [],
    }


@dataclasses.dataclass
class TimeStep:
    step_type: StepType
    reward: float
    discount: float
    observation: np.ndarray

    def is_last(self) -> bool:
        return self.step_type == LAST


def native_action_request(env: BuildingEnv, action: np.ndarray) -> building_pb2.ActionRequest:
    """ActionRequest of the native setpoints of a normalized [-1, 1] action
    vector (bounded_action_normalizer.py:73-98), in doubles as the proto
    receives them."""
    request = building_pb2.ActionRequest()
    for i, (device, field, normalizer) in enumerate(env.action_entries):
        native = (
            (float(np.clip(action[i], -1.0, 1.0)) + 1.0)
            / 2.0
            * (normalizer.max_native_value - normalizer.min_native_value)
            + normalizer.min_native_value
        )
        request.single_action_requests.add(
            device_id=device, setpoint_name=field, continuous_value=native)
    return request


class HostEnvironment:
    """reset()/step() host loop over a building implementing the proto
    protocol."""

    def __init__(
        self,
        building,  # SimulatedBuilding or decorator with the same surface
        env: BuildingEnv,
        metrics_path: Optional[str] = None,
        label: str = "episode_metrics",
    ):
        self._building = building
        self._env = env
        self._metrics_path = metrics_path
        self._label = label
        self._writer: Optional[records_lib.RecordWriter] = None
        self._episode_count = 0
        self._step_count = 0
        self._episode_ended = False
        self._metrics = _init_metrics()

    @property
    def metrics(self) -> dict:
        """In-memory per-step timeseries for notebook plotting, cleared each
        reset (plot_utils.init_metrics/update_metrics, consumed at
        environment.py:436)."""
        return self._metrics

    @property
    def action_names(self):
        return self._env.action_names

    @property
    def observation_dim(self) -> int:
        return self._env.obs_dim

    @property
    def steps_per_episode(self) -> int:
        return self._env.steps_per_episode

    def _start_metrics_writer(self) -> None:
        self._writer = None
        if self._metrics_path:
            now = datetime.datetime.now(datetime.timezone.utc)
            self._writer = records_lib.RecordWriter(
                os.path.join(self._metrics_path, f"{self._label}_{now:%y%m%d_%H%M%S}"))
            self._writer.write_device_infos(self._building.devices)
            self._writer.write_zone_infos(self._building.zones)

    def reset(self) -> TimeStep:
        self._building.reset()
        self._episode_count += 1
        self._step_count = 0
        self._episode_ended = False
        self._metrics = _init_metrics()
        self._start_metrics_writer()
        return TimeStep(FIRST, 0.0, 1.0, np.asarray(self._building._last_obs_vector))

    def _update_metrics(self, obs_response, breakdown, info, reward: float) -> None:
        """Appends one step of plotting timeseries (plot_utils.py:456-488)."""
        m = self._metrics
        m["timestamps"].append(self._building.current_timestamp)
        ambient = np.nan
        for single in obs_response.single_observation_responses:
            req = single.single_observation_request
            if (req.measurement_name == "outside_air_temperature_sensor"
                    and single.observation_valid):
                ambient = single.continuous_value
                break
        m["ambient_temps"].append(ambient)
        for zone_id, zone in info.zone_reward_infos.items():
            m["avg_temps_timeseries"].setdefault(zone_id, []).append(zone.zone_air_temperature)
        boilers = info.boiler_reward_infos.values()
        ahus = info.air_handler_reward_infos.values()
        m["boiler_gas_energy_rates"].append(sum(b.natural_gas_heating_energy_rate for b in boilers))
        m["boiler_pump_energy_rates"].append(sum(b.pump_electrical_energy_rate for b in boilers))
        m["air_handler_blower_energy_rates"].append(
            sum(a.blower_electrical_energy_rate for a in ahus))
        m["air_handler_ac_energy_rates"].append(
            sum(a.air_conditioning_electrical_energy_rate for a in ahus))
        m["rewards"].append(reward)
        m["productivity_rewards"].append(float(breakdown.productivity_reward))
        m["electricity_energy_costs"].append(float(breakdown.electricity_energy_cost))
        m["natural_gas_energy_costs"].append(float(breakdown.natural_gas_energy_cost))
        m["carbon_emitted"].append(float(breakdown.carbon_emitted))
        m["occupancy"].append(float(breakdown.total_occupancy))

    def step(self, action: np.ndarray) -> TimeStep:
        """Applies a normalized [-1, 1] action vector for one control step.
        Traced, the span `sbsim.host.step` with the children
        `sbsim.host.request` (the action request made and decoded by the
        building), `sbsim.host.env` (the env step), `sbsim.host.observe`
        (the observation response) and `sbsim.host.record` (metrics and
        shards)."""
        if self._episode_ended:
            return self.reset()
        with profiling.span("sbsim.host.step"):
            return self._step(action)

    def _step(self, action: np.ndarray) -> TimeStep:
        with profiling.span("sbsim.host.request"):
            request = native_action_request(self._env, action)
            try:
                response = self._building.request_action(request)
                action_accepted = all(
                    r.response_type == building_pb2.SingleActionResponse.ACCEPTED
                    for r in response.single_action_responses)
            except RuntimeError:
                # Building refused control (e.g. RejectionSimulatedBuilding):
                # the -inf rejection reward (environment.py:1270-1309).
                response = None
                action_accepted = False

            if self._writer is not None and response is not None:
                self._writer.write_action_response(response, self._building.current_timestamp)

        with profiling.span("sbsim.host.env"):
            self._building.wait_time()

        with profiling.span("sbsim.host.observe"):
            obs_response = self._building.request_observations(
                self._building.default_observation_request())
            if self._writer is not None:
                self._writer.write_observation_response(
                    obs_response, self._building.current_timestamp)

            obs = np.asarray(self._building._last_obs_vector)
            breakdown = self._building._last_breakdown
            reward = float(breakdown.agent_reward_value)
            if not action_accepted:
                reward = ACTION_REJECTION_REWARD

        with profiling.span("sbsim.host.record"):
            info = self._building.reward_info
            self._update_metrics(obs_response, breakdown, info, reward)

            if self._writer is not None:
                timestamp = self._building.current_timestamp
                self._writer.write_reward_info(info, timestamp)
                # The breakdown's fields are RewardResponse fields.
                self._writer.write_reward_response(
                    reward_pb2.RewardResponse(**{f.name: float(getattr(breakdown, f.name))
                                                 for f in dataclasses.fields(breakdown)}),
                    timestamp)

        self._step_count += 1
        self._episode_ended = self._step_count >= self.steps_per_episode
        if self._episode_ended:
            return TimeStep(LAST, reward, 0.0, obs)
        return TimeStep(MID, reward, self._env.config.discount_factor, obs)

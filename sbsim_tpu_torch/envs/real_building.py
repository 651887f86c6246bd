"""Controlling a real building: protos in, normalized observations out.

Port of sbsim_tpu/envs/real_building.py. The device env computes
observations from simulator state; a *real* building only offers the proto
protocol. This module assembles the same flat observation vector from an
ObservationResponse (device/measurement values -> z-score -> histogram
reduction -> auxiliary time features), with missing-sensor imputation -
the host-side mirror of environment.py:873-985 - so a policy trained in
simulation drives a real endpoint unchanged.
"""

from __future__ import annotations

import datetime
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sbsim_tpu_torch.envs import observation as obs_lib
from sbsim_tpu_torch.envs.building_env import BuildingEnv
from sbsim_tpu_torch.envs.host_environment import native_action_request
from sbsim_tpu_torch.proto import building_pb2
from sbsim_tpu_torch.utils import conversions, profiling, telemetry


def response_to_value_map(
    response: building_pb2.ObservationResponse,
) -> Dict[Tuple[str, str], float]:
    return {
        (r.single_observation_request.device_id,
         r.single_observation_request.measurement_name): r.continuous_value
        for r in response.single_observation_responses
        if r.observation_valid
    }


def assemble_observation_from_values(
    env: BuildingEnv,
    values: Mapping[Tuple[str, str], float],
    *,
    timestamp: datetime.datetime,
    comfort_now: bool,
    comfort_soon: bool,
    num_occupants: float,
) -> np.ndarray:
    """Builds the flat normalized observation vector (obs_dim,) from native
    sensor values keyed by (device_id, measurement_name). The values go to
    the env's device in one copy, as a batch of one, and the observation
    comes back in one."""
    zone_names = env.geom.zone_names
    n_zones = len(zone_names)

    def get(device, measurement, default=0.0):
        return float(values.get((device, measurement), default))

    hod_rad = conversions.get_radian_time(timestamp, conversions.TimeIntervalEnum.HOUR_OF_DAY)
    dow_rad = conversions.get_radian_time(timestamp, conversions.TimeIntervalEnum.DAY_OF_WEEK)
    c = float(env.config.occupancy_normalization_constant)
    scalars = (
        [get(obs_lib.AHU_DEVICE_ID, m) for m in obs_lib.AHU_MEASUREMENTS]
        + [get(obs_lib.BOILER_DEVICE_ID, m) for m in obs_lib.BOILER_MEASUREMENTS]
        + [hod_rad, dow_rad, float(comfort_now), float(comfort_soon),
           (int(num_occupants) - c) / (c + 1.0)]
    )
    zones = [get(f"vav_{name}", m) for m in obs_lib.VAV_MEASUREMENTS for name in zone_names]
    packed = torch.as_tensor(np.asarray(scalars + zones, np.float32), device=env.device)
    n_ahu, n_boiler = len(obs_lib.AHU_MEASUREMENTS), len(obs_lib.BOILER_MEASUREMENTS)
    one = lambda i: packed[i:i + 1]
    aux = n_ahu + n_boiler
    vav = packed[len(scalars):].reshape(len(obs_lib.VAV_MEASUREMENTS), 1, n_zones)
    obs = obs_lib.assemble_observation(
        env.obs_layout,
        ahu_values={m: one(i) for i, m in enumerate(obs_lib.AHU_MEASUREMENTS)},
        boiler_values={m: one(n_ahu + i) for i, m in enumerate(obs_lib.BOILER_MEASUREMENTS)},
        vav_values={m: vav[i] for i, m in enumerate(obs_lib.VAV_MEASUREMENTS)},
        hod_rad=one(aux),
        dow_rad=one(aux + 1),
        comfort_now=one(aux + 2) != 0,
        comfort_soon=one(aux + 3) != 0,
        num_occupants=one(aux + 4),
    )
    return obs[0].cpu().numpy()


class RealBuildingController:
    """Drives any BaseBuilding-protocol endpoint with a policy.

    `building` needs request_observations / request_action / wait_time /
    is_comfort_mode / num_occupants / current_timestamp - either a real
    endpoint speaking the wire protocol or the simulated adapter.
    """

    def __init__(
        self,
        building,
        env: BuildingEnv,
        policy,  # (1, obs_dim) observations -> (1, n_actions) normalized actions
    ):
        self._building = building
        self._env = env
        self._policy = policy
        self._last_response: Optional[building_pb2.ObservationResponse] = None

    def observe(self) -> np.ndarray:
        request = self._building.default_observation_request()
        response = self._building.request_observations(request)
        response = telemetry.impute_missing_observations(response, self._last_response)
        self._last_response = response
        now = self._building.current_timestamp
        return assemble_observation_from_values(
            self._env,
            response_to_value_map(response),
            timestamp=now,
            comfort_now=self._building.is_comfort_mode(now),
            comfort_soon=self._building.is_comfort_mode(now + datetime.timedelta(minutes=60)),
            num_occupants=self._building.num_occupants,
        )

    def control_step(self) -> np.ndarray:
        """One closed-loop step: observe -> policy -> action -> wait.

        Returns the normalized action applied. Traced, the span
        `sbsim.host.step` with the children `sbsim.host.observe`,
        `sbsim.host.policy`, `sbsim.host.request` and `sbsim.host.env`.
        """
        with profiling.span("sbsim.host.step"):
            with profiling.span("sbsim.host.observe"):
                obs = self.observe()
            with profiling.span("sbsim.host.policy"):
                action = self._policy(obs[None, :])
                if isinstance(action, torch.Tensor):
                    action = action.cpu().numpy()
                action = np.asarray(action)[0]
            with profiling.span("sbsim.host.request"):
                self._building.request_action(native_action_request(self._env, action))
            with profiling.span("sbsim.host.env"):
                self._building.wait_time()
            return action

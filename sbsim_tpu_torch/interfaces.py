"""Abstract interfaces: the pluggable contracts of the stack.

Port of sbsim_tpu/interfaces.py on the port's protos and `datetime`.
Mirrors the reference's models/ layer (base_building.py:27-95,
base_reward_function.py:23-30, base_energy_cost.py:23-66,
base_normalizer.py:24-79, base_occupancy.py:29-46) so user implementations
(real-building endpoints, custom rewards/tariffs/occupancy models) slot in
with the same surface they had against the reference. Timestamps are
UTC-aware `datetime.datetime`s.
"""

from __future__ import annotations

import abc
import datetime
import math
from typing import Sequence

import numpy as np

from sbsim_tpu_torch.proto import building_pb2, reward_pb2


class BaseBuilding(abc.ABC):
    """A controllable building, simulated or real (base_building.py:27-95)."""

    @abc.abstractmethod
    def request_observations(
        self, observation_request: building_pb2.ObservationRequest
    ) -> building_pb2.ObservationResponse:
        """Queries the building for its current sensor readings."""

    @abc.abstractmethod
    def request_action(
        self, action_request: building_pb2.ActionRequest
    ) -> building_pb2.ActionResponse:
        """Issues setpoint commands; may raise RuntimeError if control is
        refused entirely."""

    @abc.abstractmethod
    def wait_time(self) -> None:
        """Blocks/advances until the next control timestep."""

    @abc.abstractmethod
    def reset(self) -> None:
        """Resets the building; raises RuntimeError if impossible."""

    @property
    @abc.abstractmethod
    def devices(self) -> Sequence[building_pb2.DeviceInfo]:
        ...

    @property
    @abc.abstractmethod
    def zones(self) -> Sequence[building_pb2.ZoneInfo]:
        ...

    @property
    @abc.abstractmethod
    def current_timestamp(self) -> datetime.datetime:
        ...

    @property
    @abc.abstractmethod
    def time_step_sec(self) -> float:
        ...

    @property
    @abc.abstractmethod
    def reward_info(self) -> reward_pb2.RewardInfo:
        ...

    @abc.abstractmethod
    def is_comfort_mode(self, current_time: datetime.datetime) -> bool:
        ...

    @property
    @abc.abstractmethod
    def num_occupants(self) -> int:
        ...


class BaseRewardFunction(abc.ABC):
    """RewardInfo -> RewardResponse (base_reward_function.py:23-30)."""

    @abc.abstractmethod
    def compute_reward(self, reward_info: reward_pb2.RewardInfo) -> reward_pb2.RewardResponse:
        ...


class BaseEnergyCost(abc.ABC):
    """Cost/carbon of consuming energy (base_energy_cost.py:23-66)."""

    @abc.abstractmethod
    def cost(self, start_time: datetime.datetime, end_time: datetime.datetime,
             energy_rate: float) -> float:
        """USD for `energy_rate` W applied over the window."""

    @abc.abstractmethod
    def carbon(self, start_time: datetime.datetime, end_time: datetime.datetime,
               energy_rate: float) -> float:
        """kg CO2 for `energy_rate` W applied over the window."""


class BaseObservationNormalizer(abc.ABC):
    """Proto-level observation (de)normalization (base_normalizer.py:24-50)."""

    @abc.abstractmethod
    def normalize(
        self, native: building_pb2.ObservationResponse
    ) -> building_pb2.ObservationResponse:
        ...

    @abc.abstractmethod
    def denormalize(
        self, normalized: building_pb2.ObservationResponse
    ) -> building_pb2.ObservationResponse:
        ...


class BaseActionNormalizer(abc.ABC):
    """Agent [-1,1] <-> native setpoint mapping (base_normalizer.py:52-79)."""

    @abc.abstractmethod
    def setpoint_value(self, agent_action: float) -> float:
        ...

    @abc.abstractmethod
    def agent_value(self, setpoint_value: float) -> float:
        ...

    @property
    @abc.abstractmethod
    def setpoint_min(self) -> float:
        ...

    @property
    @abc.abstractmethod
    def setpoint_max(self) -> float:
        ...


class BaseOccupancy(abc.ABC):
    """Zone occupancy over a time interval (base_occupancy.py:29-46)."""

    @abc.abstractmethod
    def average_zone_occupancy(self, zone_id: str, start_time: datetime.datetime,
                               end_time: datetime.datetime) -> float:
        """Average people in the zone over [start_time, end_time]; raises
        ValueError for unknown zones."""


class StandardScoreObservationNormalizer(BaseObservationNormalizer):
    """z-score normalizer over (mean, variance) constants
    (observation_normalizer.py:31-140): unknown fields pass through,
    zero-variance fields collapse to 0."""

    def __init__(self, normalization_constants):
        # The reference receives its constants through
        # ContinuousVariableInfo protos whose sample_mean/sample_variance
        # fields are 32-bit floats (smart_control_normalization.proto), so
        # it normalizes with float32-rounded constants; the arithmetic
        # itself stays in doubles (observation_normalizer.py:86-99).
        self._constants = {
            name: (float(np.float32(mean)), float(np.float32(var)))
            for name, (mean, var) in dict(normalization_constants).items()
        }

    def _transform(self, response, forward: bool):
        out = building_pb2.ObservationResponse()
        out.CopyFrom(response)
        for single in out.single_observation_responses:
            name = single.single_observation_request.measurement_name
            mean, var = self._constants.get(name, (0.0, 1.0))
            value = single.continuous_value
            if forward:
                # Zero-variance fields collapse to 0
                # (observation_normalizer.py:86-91).
                single.continuous_value = (value - mean) / math.sqrt(var) if var > 0.0 else 0.0
            else:
                # Denormalize has no variance guard: zero-variance fields
                # recover their mean (observation_normalizer.py:93-99).
                single.continuous_value = value * math.sqrt(var) + mean
        return out

    def normalize(self, native):
        return self._transform(native, forward=True)

    def denormalize(self, normalized):
        return self._transform(normalized, forward=False)


class BoundedActionNormalizer(BaseActionNormalizer):
    """Linear bounded map (bounded_action_normalizer.py:28-126)."""

    def __init__(
        self,
        min_native_value: float,
        max_native_value: float,
        min_normalized_value: float = -1.0,
        max_normalized_value: float = 1.0,
    ):
        self._min_native = min_native_value
        self._max_native = max_native_value
        self._min_norm = min_normalized_value
        self._max_norm = max_normalized_value

    def setpoint_value(self, agent_action: float) -> float:
        ratio = (agent_action - self._min_norm) / (self._max_norm - self._min_norm)
        return ratio * (self._max_native - self._min_native) + self._min_native

    def agent_value(self, setpoint_value: float) -> float:
        return (self._max_norm - self._min_norm) / (
            self._max_native - self._min_native
        ) * (setpoint_value - self._min_native) + self._min_norm

    @property
    def setpoint_min(self) -> float:
        return self._min_native

    @property
    def setpoint_max(self) -> float:
        return self._max_native

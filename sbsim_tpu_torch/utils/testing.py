"""Canned protos and fakes for tests (the reference's test_utils.py:1-524
equivalent): quick constructors for observation/action/reward messages and an
in-memory reader. Port of sbsim_tpu/utils/testing.py on the port's protos
and `datetime` (UTC-aware timestamps)."""

from __future__ import annotations

import datetime
from typing import Dict, Mapping, Optional, Sequence, Tuple

from sbsim_tpu_torch.proto import building_pb2, reward_pb2
from sbsim_tpu_torch.utils import conversions

# The canned episode start (2023-07-06 07:00 UTC).
START = datetime.datetime(2023, 7, 6, 7, tzinfo=conversions.UTC)


def single_observation_response(
    device_id: str,
    measurement_name: str,
    value: float,
    timestamp: Optional[datetime.datetime] = None,
    valid: bool = True,
) -> building_pb2.SingleObservationResponse:
    out = building_pb2.SingleObservationResponse()
    out.single_observation_request.device_id = device_id
    out.single_observation_request.measurement_name = measurement_name
    out.continuous_value = value
    out.observation_valid = valid
    if timestamp is not None:
        out.timestamp.CopyFrom(conversions.pandas_to_proto_timestamp(timestamp))
    return out


def observation_response(
    values: Mapping[Tuple[str, str], float],
    timestamp: Optional[datetime.datetime] = None,
) -> building_pb2.ObservationResponse:
    out = building_pb2.ObservationResponse()
    if timestamp is not None:
        out.timestamp.CopyFrom(conversions.pandas_to_proto_timestamp(timestamp))
    for (device, measurement), value in values.items():
        out.single_observation_responses.add().CopyFrom(
            single_observation_response(device, measurement, value, timestamp)
        )
    return out


def action_request(
    setpoints: Mapping[Tuple[str, str], float],
    timestamp: Optional[datetime.datetime] = None,
) -> building_pb2.ActionRequest:
    out = building_pb2.ActionRequest()
    if timestamp is not None:
        out.timestamp.CopyFrom(conversions.pandas_to_proto_timestamp(timestamp))
    for (device, setpoint), value in setpoints.items():
        out.single_action_requests.add(
            device_id=device, setpoint_name=setpoint, continuous_value=value
        )
    return out


def device_info(
    device_id: str,
    device_type=building_pb2.DeviceInfo.VAV,
    zone_id: str = "",
    observable_fields: Sequence[str] = (),
    action_fields: Sequence[str] = (),
) -> building_pb2.DeviceInfo:
    out = building_pb2.DeviceInfo(
        device_id=device_id, device_type=device_type, zone_id=zone_id
    )
    for f in observable_fields:
        out.observable_fields[f] = building_pb2.DeviceInfo.VALUE_CONTINUOUS
    for f in action_fields:
        out.action_fields[f] = building_pb2.DeviceInfo.VALUE_CONTINUOUS
    return out


def reward_info(
    zone_temps: Mapping[str, float],
    heating_setpoint: float = 294.0,
    cooling_setpoint: float = 297.0,
    occupancy: float = 1.0,
    blower_rate: float = 0.0,
    ac_rate: float = 0.0,
    gas_rate: float = 0.0,
    pump_rate: float = 0.0,
    start: Optional[datetime.datetime] = None,
    step_sec: float = 300.0,
) -> reward_pb2.RewardInfo:
    out = reward_pb2.RewardInfo()
    start = start or START
    out.start_timestamp.CopyFrom(conversions.pandas_to_proto_timestamp(start))
    out.end_timestamp.CopyFrom(
        conversions.pandas_to_proto_timestamp(
            start + datetime.timedelta(seconds=step_sec)
        )
    )
    for zone_id, temp in zone_temps.items():
        z = out.zone_reward_infos[zone_id]
        z.heating_setpoint_temperature = heating_setpoint
        z.cooling_setpoint_temperature = cooling_setpoint
        z.zone_air_temperature = temp
        z.average_occupancy = occupancy
    ahu = out.air_handler_reward_infos["air_handler"]
    ahu.blower_electrical_energy_rate = blower_rate
    ahu.air_conditioning_electrical_energy_rate = ac_rate
    boiler = out.boiler_reward_infos["boiler"]
    boiler.natural_gas_heating_energy_rate = gas_rate
    boiler.pump_electrical_energy_rate = pump_rate
    return out


class SimpleBuilding:
    """In-memory BaseBuilding-protocol fake with scripted observations
    (the environment_test_utils.SimpleBuilding analogue, :30-195)."""

    def __init__(
        self,
        observation_script: Mapping[Tuple[str, str], Sequence[float]],
        action_fields: Mapping[str, Sequence[str]] = (),
        time_step_sec: float = 300.0,
        start_timestamp: Optional[datetime.datetime] = None,
    ):
        """Args:
        observation_script: (device, measurement) -> per-step values
          (cycled).
        action_fields: device -> accepted setpoint names.
        """
        self._script = {k: list(v) for k, v in observation_script.items()}
        self._action_fields = {k: set(v) for k, v in dict(action_fields).items()}
        self._time_step_sec = time_step_sec
        self._start = start_timestamp or START
        self._step = 0
        self.received_actions = []

    @property
    def devices(self):
        out = []
        device_fields: Dict[str, list] = {}
        for device, measurement in self._script:
            device_fields.setdefault(device, []).append(measurement)
        for device, fields in device_fields.items():
            out.append(
                device_info(
                    device,
                    observable_fields=fields,
                    action_fields=sorted(
                        self._action_fields.get(device, ())
                    ),
                )
            )
        return out

    @property
    def zones(self):
        return []

    @property
    def time_step_sec(self):
        return self._time_step_sec

    @property
    def current_timestamp(self) -> datetime.datetime:
        return self._start + self._step * datetime.timedelta(seconds=self._time_step_sec)

    def reset(self):
        self._step = 0
        self.received_actions = []

    def request_observations(self, observation_request):
        response = building_pb2.ObservationResponse()
        response.request.CopyFrom(observation_request)
        response.timestamp.CopyFrom(
            conversions.pandas_to_proto_timestamp(self.current_timestamp)
        )
        for sreq in observation_request.single_observation_requests:
            key = (sreq.device_id, sreq.measurement_name)
            single = response.single_observation_responses.add()
            single.single_observation_request.CopyFrom(sreq)
            if key in self._script:
                values = self._script[key]
                single.continuous_value = values[self._step % len(values)]
                single.observation_valid = True
            else:
                single.observation_valid = False
        return response

    def request_action(self, action_request):
        response = building_pb2.ActionResponse()
        response.request.CopyFrom(action_request)
        for sreq in action_request.single_action_requests:
            single = response.single_action_responses.add()
            single.request.CopyFrom(sreq)
            allowed = self._action_fields.get(sreq.device_id, set())
            if sreq.setpoint_name in allowed:
                single.response_type = (
                    building_pb2.SingleActionResponse.ACCEPTED
                )
                self.received_actions.append(
                    (sreq.device_id, sreq.setpoint_name,
                     sreq.continuous_value)
                )
            else:
                single.response_type = (
                    building_pb2.SingleActionResponse.REJECTED_INVALID_DEVICE
                )
        return response

    def wait_time(self):
        self._step += 1

    @property
    def reward_info(self):
        return reward_info({})

    def is_comfort_mode(self, current_time):
        return True

    @property
    def num_occupants(self) -> int:
        return 0


class FakeReader:
    """In-memory reader with the RecordReader surface (test_utils.py:485)."""

    def __init__(
        self,
        observation_responses=(),
        action_responses=(),
        reward_infos=(),
        reward_responses=(),
        device_infos=(),
        zone_infos=(),
        normalization_info: Optional[Dict] = None,
    ):
        self._observation_responses = list(observation_responses)
        self._action_responses = list(action_responses)
        self._reward_infos = list(reward_infos)
        self._reward_responses = list(reward_responses)
        self._device_infos = list(device_infos)
        self._zone_infos = list(zone_infos)
        self._normalization_info = normalization_info or {}

    def read_observation_responses(self, start=None, end=None):
        return self._observation_responses

    def read_action_responses(self, start=None, end=None):
        return self._action_responses

    def read_reward_infos(self, start=None, end=None):
        return self._reward_infos

    def read_reward_responses(self, start=None, end=None):
        return self._reward_responses

    def read_device_infos(self):
        return self._device_infos

    def read_zone_infos(self):
        return self._zone_infos

    def read_normalization_info(self):
        return self._normalization_info

"""Regression-building workflow: learn a building model from telemetry.

The reference pairs its physics simulator with a *regression building* — a
data-driven surrogate trained on recorded real-building telemetry that
predicts the next observation set and device energy rates from the current
observations + agent actions (regression_building_utils.py:64-820; the model
itself lives outside the reference repo but all framing/reconstruction
helpers ship with it).  Port of sbsim_tpu/utils/regression.py on the
port's protos, `datetime` and `Frame` in place of pandas; local time comes
from the port's table of time zones (scenario/tables.to_local).  This
module provides the same workflow:

* framing recorded `(ObservationResponse, ActionResponse, RewardInfo)`
  streams into supervised (input_t -> output_{t+1}) tables,
* reconstructing wire protos from a model's flat prediction mapping,
* deriving device/zone `RewardInfo` submessages from real telemetry, and
* `RegressionBuilding`, a `BaseBuilding` driven by any prediction callable
  (e.g. an sklearn regressor or a torch module), so trained surrogates
  plug straight into `HostEnvironment`.

Column keys are tuples: observations are `(device_id, measurement_name)`,
actions `("action", device_id, setpoint_name)`, reward fields
`("reward_info", device_id, field_name)` — matching the reference layout so
recorded datasets frame identically.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import (
    Any, Callable, Dict, Iterable, List, Mapping, Sequence, Set, Tuple,
)

import numpy as np

from sbsim_tpu_torch import interfaces
from sbsim_tpu_torch.proto import building_pb2, reward_pb2
from sbsim_tpu_torch.scenario.tables import to_local
from sbsim_tpu_torch.utils import conversions
from sbsim_tpu_torch.utils.frame import Frame
from sbsim_tpu_torch.utils.telemetry import expand_time_features, get_time_feature_names

ACTION = "action"
REWARD_INFO = "reward_info"
TIMESTAMP = "timestamp"
START = "start"
END = "end"
BLOWER_RATE = "blower_electrical_energy_rate"
AC_RATE = "air_conditioning_electrical_energy_rate"
GAS_RATE = "natural_gas_heating_energy_rate"
PUMP_RATE = "pump_electrical_energy_rate"
ZONE_TEMP_SENSOR = "zone_air_temperature_sensor"
ZONE_COOL_SETPOINT = "zone_air_cooling_temperature_setpoint"
ZONE_HEAT_SETPOINT = "zone_air_heating_temperature_setpoint"

# Device types whose setpoints the agent commands
# (regression_building_utils.py:38-42).
ACTIONABLE_DEVICE_TYPES = (
    building_pb2.DeviceInfo.AHU,
    building_pb2.DeviceInfo.BLR,
    building_pb2.DeviceInfo.AC,
)

ObsKey = Tuple[str, str]
ActionKey = Tuple[str, str, str]
RewardKey = Tuple[str, str, str]


# ---------------------------------------------------------------------------
# Tuple extraction
# ---------------------------------------------------------------------------


def feature_tuples(
    response: building_pb2.ObservationResponse,
) -> Set[ObsKey]:
    """Valid (device, measurement) pairs in a response (:226-239)."""
    return {
        (
            s.single_observation_request.device_id,
            s.single_observation_request.measurement_name,
        )
        for s in response.single_observation_responses
        if s.observation_valid
    }


def action_tuples(
    response: building_pb2.ActionResponse,
) -> Set[ActionKey]:
    """("action", device, setpoint) keys present in a response (:214-224)."""
    return {
        (ACTION, r.device_id, r.setpoint_name)
        for r in response.request.single_action_requests
    }


def device_action_tuples(
    devices: Sequence[building_pb2.DeviceInfo],
) -> List[ActionKey]:
    """Action keys for every commandable setpoint on actionable devices
    (:428-440)."""
    out: List[ActionKey] = []
    for info in devices:
        if info.device_type in ACTIONABLE_DEVICE_TYPES:
            out.extend((ACTION, info.device_id, name) for name in info.action_fields)
    return out


def reward_info_tuples(
    reward_info: reward_pb2.RewardInfo,
) -> Set[RewardKey]:
    """("reward_info", device, field) keys for AHU/boiler energy rates plus
    the interval timestamps (:270-299)."""
    keys: Set[RewardKey] = {
        (REWARD_INFO, TIMESTAMP, START),
        (REWARD_INFO, TIMESTAMP, END),
    }
    for ahu_id in reward_info.air_handler_reward_infos:
        keys.add((REWARD_INFO, ahu_id, BLOWER_RATE))
        keys.add((REWARD_INFO, ahu_id, AC_RATE))
    for boiler_id in reward_info.boiler_reward_infos:
        keys.add((REWARD_INFO, boiler_id, GAS_RATE))
        keys.add((REWARD_INFO, boiler_id, PUMP_RATE))
    return keys


# ---------------------------------------------------------------------------
# Proto -> flat mapping
# ---------------------------------------------------------------------------


def _time_features(
    ts: datetime.datetime, time_zone: str, n_hod: int, n_dow: int
) -> Dict[str, float]:
    """hod then dow sin/cos features of `ts`'s local time in `time_zone`."""
    local = to_local(ts, time_zone)
    row = expand_time_features(
        n_hod, conversions.get_radian_time(local, conversions.TimeIntervalEnum.HOUR_OF_DAY),
        "hod")
    row.update(expand_time_features(
        n_dow, conversions.get_radian_time(local, conversions.TimeIntervalEnum.DAY_OF_WEEK),
        "dow"))
    return row


def feature_map(
    response: building_pb2.ObservationResponse,
    time_zone: str = "UTC",
    n_hod: int = 1,
    n_dow: int = 1,
) -> Dict[Any, Any]:
    """Flat {key: value} for one response, with timestamp (UTC) and
    phase-shifted hod/dow sin/cos features of its local time in `time_zone`
    prepended (:166-212)."""
    ts = conversions.proto_to_pandas_timestamp(response.timestamp)
    row: Dict[Any, Any] = {TIMESTAMP: ts}
    row.update(_time_features(ts, time_zone, n_hod, n_dow))
    for s in response.single_observation_responses:
        if s.observation_valid:
            req = s.single_observation_request
            row[(req.device_id, req.measurement_name)] = s.continuous_value
    return row


def action_map(
    response: building_pb2.ActionResponse,
    time_zone: str = "UTC",
) -> Dict[Any, Any]:
    """Flat {("action", device, setpoint): value}; rejected commands map to
    NaN (:240-267). The timestamp is UTC, the same instant as the JAX
    package's `time_zone` timestamp."""
    del time_zone
    row: Dict[Any, Any] = {TIMESTAMP: conversions.proto_to_pandas_timestamp(response.timestamp)}
    for single in response.single_action_responses:
        req = single.request
        key = (ACTION, req.device_id, req.setpoint_name)
        accepted = (
            single.response_type
            == building_pb2.SingleActionResponse.ACCEPTED
        )
        row[key] = req.continuous_value if accepted else np.nan
    return row


def reward_info_map(
    reward_info: reward_pb2.RewardInfo,
    time_zone: str = "UTC",
) -> Dict[RewardKey, Any]:
    """Flat {("reward_info", device, field): value} (:302-349); timestamps
    in UTC, as in `action_map`."""
    del time_zone
    row: Dict[RewardKey, Any] = {
        (REWARD_INFO, TIMESTAMP, START): conversions.proto_to_pandas_timestamp(
            reward_info.start_timestamp
        ),
        (REWARD_INFO, TIMESTAMP, END): conversions.proto_to_pandas_timestamp(
            reward_info.end_timestamp
        ),
    }
    for ahu_id, info in reward_info.air_handler_reward_infos.items():
        row[(REWARD_INFO, ahu_id, BLOWER_RATE)] = info.blower_electrical_energy_rate
        row[(REWARD_INFO, ahu_id, AC_RATE)] = (
            info.air_conditioning_electrical_energy_rate
        )
    for boiler_id, info in reward_info.boiler_reward_infos.items():
        row[(REWARD_INFO, boiler_id, GAS_RATE)] = (
            info.natural_gas_heating_energy_rate
        )
        row[(REWARD_INFO, boiler_id, PUMP_RATE)] = info.pump_electrical_energy_rate
    return row


# ---------------------------------------------------------------------------
# Sequences (Frames)
# ---------------------------------------------------------------------------


def observation_sequence(
    responses: Sequence[building_pb2.ObservationResponse],
    keys: Iterable[ObsKey],
    time_zone: str = "UTC",
    n_hod: int = 1,
    n_dow: int = 1,
) -> Frame:
    """One row per response; timestamp + time features + sorted obs columns
    (:128-163)."""
    cols = (
        [TIMESTAMP]
        + get_time_feature_names(n_hod, "hod")
        + get_time_feature_names(n_dow, "dow")
        + sorted(keys)
    )
    rows = [feature_map(r, time_zone, n_hod, n_dow) for r in responses]
    return Frame.from_rows(rows, columns=cols)


def action_sequence(
    responses: Sequence[building_pb2.ActionResponse],
    keys: Iterable[ActionKey],
    time_zone: str = "UTC",
) -> Frame:
    """One row per ActionResponse, restricted to the given keys (:413-426)."""
    cols = [TIMESTAMP] + sorted(keys)
    colset = set(cols)
    rows = [
        {k: v for k, v in action_map(r, time_zone).items() if k in colset}
        for r in responses
    ]
    return Frame.from_rows(rows, columns=cols)


def reward_info_sequence(
    reward_infos: Sequence[reward_pb2.RewardInfo],
    keys: Iterable[RewardKey],
    time_zone: str = "UTC",
) -> Frame:
    """One row per RewardInfo (:398-410)."""
    return Frame.from_rows(
        (reward_info_map(ri, time_zone) for ri in reward_infos),
        columns=sorted(keys),
    )


def match_sequence_indexes(
    inputs: Frame,
    outputs: Frame,
    step_interval: datetime.timedelta,
) -> Tuple[List[datetime.datetime], List[datetime.datetime]]:
    """Pairs each input timestamp with the first later output timestamp within
    one step, producing aligned (input_t, output_{t+1}) training indexes
    (:351-396).  Rows with NaNs are dropped first, so gaps in telemetry
    simply skip pairs rather than mis-aligning them.
    """
    in_times = list(inputs.dropna().index)
    out_times = list(outputs.dropna().index)
    matched_in: List[datetime.datetime] = []
    matched_out: List[datetime.datetime] = []
    j = 0
    for ts_in in in_times:
        while j < len(out_times) and out_times[j] <= ts_in:
            j += 1
        if j >= len(out_times):
            break
        if out_times[j] - ts_in <= step_interval:
            matched_in.append(ts_in)
            matched_out.append(out_times[j])
    return matched_in, matched_out


# ---------------------------------------------------------------------------
# Mapping -> proto reconstruction
# ---------------------------------------------------------------------------


def observation_mapping(
    response: building_pb2.ObservationResponse,
) -> Dict[ObsKey, float]:
    """Valid readings as {(device, measurement): value} (:487-512)."""
    return {
        (
            s.single_observation_request.device_id,
            s.single_observation_request.measurement_name,
        ): s.continuous_value
        for s in response.single_observation_responses
        if s.observation_valid
    }


def build_observation_response(
    request: building_pb2.ObservationRequest,
    mapping: Mapping[ObsKey, float],
    timestamp: datetime.datetime,
) -> building_pb2.ObservationResponse:
    """Answers a request from a flat mapping; unknown keys come back invalid
    (:441-484)."""
    response = building_pb2.ObservationResponse()
    response.request.CopyFrom(request)
    response.timestamp.CopyFrom(conversions.pandas_to_proto_timestamp(timestamp))
    for single_request in request.single_observation_requests:
        single = response.single_observation_responses.add()
        single.single_observation_request.CopyFrom(single_request)
        single.timestamp.CopyFrom(conversions.pandas_to_proto_timestamp(timestamp))
        key = (single_request.device_id, single_request.measurement_name)
        if key in mapping:
            single.continuous_value = float(mapping[key])
            single.observation_valid = True
        else:
            single.observation_valid = False
    return response


def build_action_response(
    request: building_pb2.ActionRequest,
    timestamp: datetime.datetime,
    allowed: Sequence[ActionKey],
) -> building_pb2.ActionResponse:
    """Accepts commands on known device setpoints, rejects the rest
    (:515-557)."""
    allowed_set = set(allowed)
    response = building_pb2.ActionResponse()
    response.request.CopyFrom(request)
    response.timestamp.CopyFrom(conversions.pandas_to_proto_timestamp(timestamp))
    for single_request in request.single_action_requests:
        single = response.single_action_responses.add()
        single.request.CopyFrom(single_request)
        key = (ACTION, single_request.device_id, single_request.setpoint_name)
        single.response_type = (
            building_pb2.SingleActionResponse.ACCEPTED
            if key in allowed_set
            else building_pb2.SingleActionResponse.REJECTED_INVALID_DEVICE
        )
    return response


def action_request_to_mapping(
    request: building_pb2.ActionRequest,
    allowed: Sequence[ActionKey],
) -> Dict[ActionKey, float]:
    """Model-input action columns from an agent request; unknown setpoints are
    dropped (:591-628)."""
    allowed_set = set(allowed)
    out: Dict[ActionKey, float] = {}
    for single in request.single_action_requests:
        key = (ACTION, single.device_id, single.setpoint_name)
        if key in allowed_set:
            out[key] = single.continuous_value
    return out


def split_prediction(
    prediction: Mapping[Tuple[str, ...], float],
) -> Tuple[Dict[ObsKey, float], Dict[RewardKey, float]]:
    """Splits a model's flat output into (observations, reward-info fields)
    (:559-571)."""
    obs = {k: v for k, v in prediction.items() if k[0] != REWARD_INFO}
    reward = {k: v for k, v in prediction.items() if k[0] == REWARD_INFO}
    return obs, reward  # type: ignore[return-value]


def group_reward_fields_by_device(
    reward_mapping: Mapping[RewardKey, float],
) -> Dict[str, Dict[str, float]]:
    """{device: {field: value}} (:574-589)."""
    out: Dict[str, Dict[str, float]] = {}
    for (_, device, field), value in reward_mapping.items():
        out.setdefault(device, {})[field] = value
    return out


def device_observations(
    mapping: Mapping[ObsKey, float], device_id: str
) -> Dict[str, float]:
    """{measurement: value} for one device (:715-730)."""
    return {m: v for (d, m), v in mapping.items() if d == device_id}


# ---------------------------------------------------------------------------
# RewardInfo construction from telemetry
# ---------------------------------------------------------------------------


def boiler_reward_infos(
    by_device: Mapping[str, Mapping[str, float]],
) -> Dict[str, reward_pb2.RewardInfo.BoilerRewardInfo]:
    """A device is a boiler iff it reports both gas heating and pump power;
    devices with either rate missing/NaN are skipped (:630-669)."""
    out = {}
    for device_id, fields in by_device.items():
        gas = fields.get(GAS_RATE, np.nan)
        pump = fields.get(PUMP_RATE, np.nan)
        if not (np.isnan(gas) or np.isnan(pump)):
            out[device_id] = reward_pb2.RewardInfo.BoilerRewardInfo(
                natural_gas_heating_energy_rate=gas,
                pump_electrical_energy_rate=pump,
            )
    return out


def air_handler_reward_infos(
    by_device: Mapping[str, Mapping[str, float]],
) -> Dict[str, reward_pb2.RewardInfo.AirHandlerRewardInfo]:
    """A device is an air handler iff it reports blower and AC power
    (:672-713)."""
    out = {}
    for device_id, fields in by_device.items():
        blower = fields.get(BLOWER_RATE, np.nan)
        ac = fields.get(AC_RATE, np.nan)
        if not (np.isnan(blower) or np.isnan(ac)):
            out[device_id] = reward_pb2.RewardInfo.AirHandlerRewardInfo(
                blower_electrical_energy_rate=blower,
                air_conditioning_electrical_energy_rate=ac,
            )
    return out


def zone_reward_infos(
    timestamp: datetime.datetime,
    step_interval: datetime.timedelta,
    obs_mapping: Mapping[ObsKey, float],
    occupancy: interfaces.BaseOccupancy,
    schedule_window: Callable[[datetime.datetime], Tuple[float, float]],
    zone_infos: Sequence[building_pb2.ZoneInfo],
    device_infos: Sequence[building_pb2.DeviceInfo],
    sensors_in_fahrenheit: bool = True,
) -> Dict[str, reward_pb2.RewardInfo.ZoneRewardInfo]:
    """Builds per-zone reward infos from real VAV telemetry (:733-820).

    The schedule window is the default heat/cool setpoint pair; per-zone VAV
    setpoint readings override it.  Real-building VAV temperatures arrive in
    Fahrenheit and are converted here (the documented reference quirk at
    :789-808); pass sensors_in_fahrenheit=False for Kelvin feeds.
    """
    heat_default, cool_default = schedule_window(timestamp)
    if heat_default > cool_default:
        raise ValueError(
            f"Bad setpoints: heating {heat_default} > cooling {cool_default}"
        )
    to_kelvin = (
        conversions.fahrenheit_to_kelvin if sensors_in_fahrenheit else float
    )
    device_types = {d.device_id: d.device_type for d in device_infos}
    out: Dict[str, reward_pb2.RewardInfo.ZoneRewardInfo] = {}
    for zone_info in zone_infos:
        avg_occupancy = occupancy.average_zone_occupancy(
            zone_info.zone_id, timestamp - step_interval, timestamp
        )
        for device_id in zone_info.devices:
            if device_types.get(device_id) != building_pb2.DeviceInfo.VAV:
                continue
            readings = device_observations(obs_mapping, device_id)
            if ZONE_TEMP_SENSOR not in readings:
                continue
            heat, cool = heat_default, cool_default
            if ZONE_HEAT_SETPOINT in readings:
                heat = to_kelvin(readings[ZONE_HEAT_SETPOINT])
            if ZONE_COOL_SETPOINT in readings:
                cool = to_kelvin(readings[ZONE_COOL_SETPOINT])
            out[zone_info.zone_id] = reward_pb2.RewardInfo.ZoneRewardInfo(
                heating_setpoint_temperature=heat,
                cooling_setpoint_temperature=cool,
                zone_air_temperature=to_kelvin(readings[ZONE_TEMP_SENSOR]),
                average_occupancy=avg_occupancy,
            )
            break  # one VAV sensor per zone suffices
    return out


# ---------------------------------------------------------------------------
# RegressionBuilding: a BaseBuilding backed by a learned surrogate
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RegressionBuildingSpec:
    """Static description of the surrogate's wire surface."""

    devices: Sequence[building_pb2.DeviceInfo]
    zones: Sequence[building_pb2.ZoneInfo]
    time_step_sec: float
    start_timestamp: datetime.datetime
    occupancy: interfaces.BaseOccupancy
    schedule_window: Callable[[datetime.datetime], Tuple[float, float]]
    is_comfort_mode: Callable[[datetime.datetime], bool]
    time_zone: str = "UTC"
    n_hod: int = 1
    n_dow: int = 1
    sensors_in_fahrenheit: bool = True


class RegressionBuilding(interfaces.BaseBuilding):
    """Data-driven building: a prediction callable in place of physics.

    `predict_fn(input_row)` receives the current flat mapping — time
    features, `(device, measurement)` observations and
    `("action", device, setpoint)` commands — and returns the next flat
    mapping of observations and `("reward_info", ...)` energy rates, i.e.
    exactly the supervised framing produced by `observation_sequence` /
    `action_sequence` / `reward_info_sequence`.  Plays the role of the
    reference's externally-trained regression building behind the same
    `BaseBuilding` facade.
    """

    def __init__(
        self,
        spec: RegressionBuildingSpec,
        predict_fn: Callable[[Mapping[Any, float]], Mapping[Any, float]],
        initial_observation: building_pb2.ObservationResponse,
    ):
        self._spec = spec
        self._predict_fn = predict_fn
        self._allowed = device_action_tuples(spec.devices)
        self._step = datetime.timedelta(seconds=spec.time_step_sec)
        self._initial_mapping = observation_mapping(initial_observation)
        self.reset()

    def reset(self) -> None:
        self._timestamp = conversions.as_utc(self._spec.start_timestamp)
        self._obs_mapping = dict(self._initial_mapping)
        self._pending_actions: Dict[ActionKey, float] = {}
        self._reward_mapping: Dict[RewardKey, float] = {}

    @property
    def devices(self) -> Sequence[building_pb2.DeviceInfo]:
        return self._spec.devices

    @property
    def zones(self) -> Sequence[building_pb2.ZoneInfo]:
        return self._spec.zones

    @property
    def current_timestamp(self) -> datetime.datetime:
        return self._timestamp

    @property
    def time_step_sec(self) -> float:
        return self._spec.time_step_sec

    @property
    def num_occupants(self) -> int:
        total = 0.0
        for zone in self._spec.zones:
            total += self._spec.occupancy.average_zone_occupancy(
                zone.zone_id,
                self._timestamp - self._step,
                self._timestamp,
            )
        return int(round(total))

    def is_comfort_mode(self, current_time: datetime.datetime) -> bool:
        return self._spec.is_comfort_mode(current_time)

    def request_observations(
        self, observation_request: building_pb2.ObservationRequest
    ) -> building_pb2.ObservationResponse:
        return build_observation_response(
            observation_request, self._obs_mapping, self._timestamp
        )

    def request_action(
        self, action_request: building_pb2.ActionRequest
    ) -> building_pb2.ActionResponse:
        self._pending_actions = action_request_to_mapping(
            action_request, self._allowed
        )
        return build_action_response(
            action_request, self._timestamp, self._allowed
        )

    def wait_time(self) -> None:
        """Advances one step: one surrogate prediction replaces the FDM."""
        row: Dict[Any, float] = _time_features(
            self._timestamp, self._spec.time_zone, self._spec.n_hod, self._spec.n_dow
        )
        row.update(self._obs_mapping)
        row.update(self._pending_actions)
        prediction = dict(self._predict_fn(row))
        obs, reward = split_prediction(prediction)
        self._obs_mapping.update(obs)
        self._reward_mapping = reward
        self._timestamp = self._timestamp + self._step

    @property
    def reward_info(self) -> reward_pb2.RewardInfo:
        by_device = group_reward_fields_by_device(self._reward_mapping)
        info = reward_pb2.RewardInfo(
            agent_id="regression_building",
            scenario_id="regression_building",
        )
        info.start_timestamp.CopyFrom(
            conversions.pandas_to_proto_timestamp(self._timestamp - self._step)
        )
        info.end_timestamp.CopyFrom(
            conversions.pandas_to_proto_timestamp(self._timestamp)
        )
        for zone_id, zone_info in zone_reward_infos(
            self._timestamp,
            self._step,
            self._obs_mapping,
            self._spec.occupancy,
            self._spec.schedule_window,
            self._spec.zones,
            self._spec.devices,
            self._spec.sensors_in_fahrenheit,
        ).items():
            info.zone_reward_infos[zone_id].CopyFrom(zone_info)
        for ahu_id, ahu_info in air_handler_reward_infos(by_device).items():
            info.air_handler_reward_infos[ahu_id].CopyFrom(ahu_info)
        for boiler_id, boiler_info in boiler_reward_infos(by_device).items():
            info.boiler_reward_infos[boiler_id].CopyFrom(boiler_info)
        return info

"""Observation/action wire format between a building and the agent
(building.proto beside this file): the same package, messages, field
numbers and enums as sbsim_tpu/proto/building_pb2.py, on the port's own
wire runtime."""

from sbsim_tpu_torch.proto._message import (
    BOOL, ENUM, FLOAT, INT32, MAP, MESSAGE, STRING, EnumType, Field, message_type)
from sbsim_tpu_torch.proto.timestamp_pb2 import Timestamp

_PACKAGE = "smart_buildings.smart_control.proto."

_ZoneType = EnumType("ZoneType", [
    ("UNDEFINED", 0), ("ROOM", 1), ("FLOOR", 2), ("OTHER", 10)])

ZoneInfo = message_type("ZoneInfo", _PACKAGE + "ZoneInfo", [
    Field("zone_id", 1, STRING),
    Field("building_id", 2, STRING),
    Field("zone_description", 3, STRING),
    Field("area", 4, FLOAT),
    Field("devices", 5, STRING, repeated=True),
    Field("zone_type", 6, ENUM, _ZoneType),
    Field("floor", 7, INT32),
], enums=[_ZoneType])

_DeviceType = EnumType("DeviceType", [
    ("UNDEFINED", 0), ("FAN", 1), ("PMP", 2), ("FCU", 3), ("VAV", 4), ("DH", 5), ("AHU", 6),
    ("BLR", 7), ("CDWS", 8), ("CH", 9), ("CHWS", 10), ("CT", 11), ("DC", 12), ("DFR", 13),
    ("DMP", 14), ("HWS", 15), ("HX", 16), ("MAU", 17), ("SDC", 18), ("UH", 19), ("PWR", 20),
    ("GAS", 21), ("AC", 22), ("OTHER", 23)])

_ValueType = EnumType("ValueType", [
    ("VALUE_TYPE_UNDEFINED", 0), ("VALUE_CONTINUOUS", 1), ("VALUE_INTEGER", 2),
    ("VALUE_CATEGORICAL", 3), ("VALUE_BINARY", 4)])

DeviceInfo = message_type("DeviceInfo", _PACKAGE + "DeviceInfo", [
    Field("device_id", 1, STRING),
    Field("namespace", 2, STRING),
    Field("code", 3, STRING),
    Field("zone_id", 4, STRING),
    Field("device_type", 5, ENUM, _DeviceType),
    Field("observable_fields", 6, MAP, _ValueType, value_kind=ENUM),
    Field("action_fields", 7, MAP, _ValueType, value_kind=ENUM),
], enums=[_DeviceType, _ValueType])

SingleObservationRequest = message_type(
    "SingleObservationRequest", _PACKAGE + "SingleObservationRequest", [
        Field("device_id", 1, STRING),
        Field("measurement_name", 2, STRING),
    ])

SingleObservationResponse = message_type(
    "SingleObservationResponse", _PACKAGE + "SingleObservationResponse", [
        Field("timestamp", 1, MESSAGE, Timestamp),
        Field("single_observation_request", 2, MESSAGE, SingleObservationRequest),
        Field("observation_valid", 3, BOOL),
        Field("continuous_value", 4, FLOAT, oneof="observation_value"),
        Field("integer_value", 5, INT32, oneof="observation_value"),
        Field("categorical_value", 6, STRING, oneof="observation_value"),
        Field("binary_value", 7, BOOL, oneof="observation_value"),
        Field("string_value", 8, STRING, oneof="observation_value"),
    ])

ObservationRequest = message_type("ObservationRequest", _PACKAGE + "ObservationRequest", [
    Field("timestamp", 1, MESSAGE, Timestamp),
    Field("single_observation_requests", 2, MESSAGE, SingleObservationRequest, repeated=True),
])

ObservationResponse = message_type("ObservationResponse", _PACKAGE + "ObservationResponse", [
    Field("timestamp", 1, MESSAGE, Timestamp),
    Field("request", 2, MESSAGE, ObservationRequest),
    Field("single_observation_responses", 3, MESSAGE, SingleObservationResponse, repeated=True),
])

SingleActionRequest = message_type("SingleActionRequest", _PACKAGE + "SingleActionRequest", [
    Field("device_id", 1, STRING),
    Field("setpoint_name", 2, STRING),
    Field("continuous_value", 3, FLOAT, oneof="setpoint_value"),
    Field("integer_value", 4, INT32, oneof="setpoint_value"),
    Field("categorical_value", 5, STRING, oneof="setpoint_value"),
    Field("binary_value", 6, BOOL, oneof="setpoint_value"),
    Field("string_value", 7, STRING, oneof="setpoint_value"),
])

_ActionResponseType = EnumType("ActionResponseType", [
    ("UNDEFINED", 0), ("ACCEPTED", 1), ("PENDING", 2), ("TIMED_OUT", 3),
    ("REJECTED_INVALID_SETTING", 4), ("REJECTED_NOT_ENABLED_OR_AVAILABLE", 5),
    ("REJECTED_OVERRIDE", 6), ("REJECTED_INVALID_DEVICE", 7), ("REJECTED_DEVICE_OFFLINE", 8),
    ("UNKNOWN", 9), ("OTHER", 10)])

SingleActionResponse = message_type("SingleActionResponse", _PACKAGE + "SingleActionResponse", [
    Field("request", 1, MESSAGE, SingleActionRequest),
    Field("response_type", 2, ENUM, _ActionResponseType),
    Field("additional_info", 3, STRING),
], enums=[_ActionResponseType])

ActionRequest = message_type("ActionRequest", _PACKAGE + "ActionRequest", [
    Field("timestamp", 1, MESSAGE, Timestamp),
    Field("single_action_requests", 2, MESSAGE, SingleActionRequest, repeated=True),
])

ActionResponse = message_type("ActionResponse", _PACKAGE + "ActionResponse", [
    Field("timestamp", 1, MESSAGE, Timestamp),
    Field("request", 2, MESSAGE, ActionRequest),
    Field("single_action_responses", 3, MESSAGE, SingleActionResponse, repeated=True),
])

"""Normalization-constant wire format (normalization.proto beside this
file): the same message and field numbers as
sbsim_tpu/proto/normalization_pb2.py, on the port's own wire runtime."""

from sbsim_tpu_torch.proto._message import FLOAT, INT32, MESSAGE, STRING, Field, message_type
from sbsim_tpu_torch.proto.timestamp_pb2 import Timestamp

ContinuousVariableInfo = message_type(
    "ContinuousVariableInfo", "smart_buildings.smart_control.proto.ContinuousVariableInfo", [
        Field("id", 1, STRING),
        Field("sample_start", 2, MESSAGE, Timestamp),
        Field("sample_end", 3, MESSAGE, Timestamp),
        Field("sample_size", 4, INT32),
        Field("sample_variance", 5, FLOAT),
        Field("sample_mean", 6, FLOAT),
        Field("sample_median", 7, FLOAT),
        Field("sample_maximum", 8, FLOAT),
        Field("sample_minimum", 9, FLOAT),
    ])

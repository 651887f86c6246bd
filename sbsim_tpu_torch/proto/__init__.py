"""Wire-format protos on the port's own runtime, byte-compatible with
protobuf and with sbsim_tpu/proto.

The card's machine has no protobuf runtime, so the three schemas
(building.proto, reward.proto, normalization.proto, and the well-known
timestamp.proto, kept beside the modules as documentation) are static
field tables in `*_pb2.py`, read by one schema-driven message class
(`_message.py`) over the proto3 wire format (`_wire.py`). Records written
by either package are read by the other.
"""

from sbsim_tpu_torch.proto import building_pb2, normalization_pb2, reward_pb2, timestamp_pb2

__all__ = ["building_pb2", "normalization_pb2", "reward_pb2", "timestamp_pb2"]

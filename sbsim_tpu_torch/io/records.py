"""Length-prefixed proto record IO, shard-compatible with the reference.

Port of sbsim_tpu/io/records.py on the port's protos and `datetime`.
File format (controller_writer.py:34-162 / controller_reader.py:39-237):
hourly shard files named `<prefix>_YYYY.MM.DD.HH` (UTC) containing a
stream of [4-byte little-endian length][serialized proto] records; one file
prefix per message type; a `normalization_info` file of
ContinuousVariableInfo records. Shards written by either package are
readable by the other byte for byte. Records are framed in Python (the JAX
package's native bulk scanner is not ported).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterator, List, Optional, Sequence, Type

import numpy as np

from sbsim_tpu_torch import constants
from sbsim_tpu_torch.proto import building_pb2, normalization_pb2, reward_pb2
from sbsim_tpu_torch.proto._message import Message
from sbsim_tpu_torch.utils.conversions import UTC, as_utc

_PREFIX_TO_MESSAGE: Dict[str, Type[Message]] = {
    constants.OBSERVATION_RESPONSE_FILE_PREFIX: building_pb2.ObservationResponse,
    constants.ACTION_RESPONSE_FILE_PREFIX: building_pb2.ActionResponse,
    constants.REWARD_INFO_PREFIX: reward_pb2.RewardInfo,
    constants.REWARD_RESPONSE_PREFIX: reward_pb2.RewardResponse,
    constants.DEVICE_INFO_PREFIX: building_pb2.DeviceInfo,
    constants.ZONE_INFO_PREFIX: building_pb2.ZoneInfo,
}


def _serial(timestamp: datetime.datetime) -> str:
    return as_utc(timestamp).strftime("%Y.%m.%d.%H")


def append_records(filepath: str, messages: Sequence[Message]) -> None:
    """Appends length-prefixed records (controller_writer.py:118-147)."""
    with open(filepath, "ab") as f:
        for msg in messages:
            data = msg.SerializeToString()
            f.write(len(data).to_bytes(4, "little"))
            f.write(data)


def read_records(filepath: str, message_type: Type[Message]) -> Iterator[Message]:
    """Streams records from one shard (controller_reader.py:186-207)."""
    with open(filepath, "rb") as f:
        while True:
            size_bytes = f.read(4)
            if len(size_bytes) < 4:
                return
            yield message_type.FromString(f.read(int.from_bytes(size_bytes, "little")))


class RecordWriter:
    """Writes hourly proto shards for one episode directory
    (the ProtoWriter contract, writer_lib.py:39-106)."""

    def __init__(self, output_dir: str):
        self._output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def _path(self, prefix: str, timestamp: datetime.datetime) -> str:
        return os.path.join(self._output_dir, f"{prefix}_{_serial(timestamp)}")

    def write_observation_response(self, msg, timestamp: datetime.datetime):
        append_records(self._path(constants.OBSERVATION_RESPONSE_FILE_PREFIX, timestamp), [msg])

    def write_action_response(self, msg, timestamp: datetime.datetime):
        append_records(self._path(constants.ACTION_RESPONSE_FILE_PREFIX, timestamp), [msg])

    def write_reward_info(self, msg, timestamp: datetime.datetime):
        append_records(self._path(constants.REWARD_INFO_PREFIX, timestamp), [msg])

    def write_reward_response(self, msg, timestamp: datetime.datetime):
        append_records(self._path(constants.REWARD_RESPONSE_PREFIX, timestamp), [msg])

    def write_device_infos(self, device_infos) -> None:
        append_records(os.path.join(self._output_dir, constants.DEVICE_INFO_PREFIX + "s"),
                       list(device_infos))

    def write_zone_infos(self, zone_infos) -> None:
        append_records(os.path.join(self._output_dir, constants.ZONE_INFO_PREFIX + "s"),
                       list(zone_infos))

    def write_normalization_info(self, variable_infos) -> None:
        append_records(os.path.join(self._output_dir, constants.NORMALIZATION_FILENAME),
                       list(variable_infos))


class RecordWriterFactory:
    """writer_lib.BaseWriterFactory equivalent (controller_writer.py:173)."""

    def create(self, output_dir: str) -> RecordWriter:
        return RecordWriter(output_dir)


class RecordReader:
    """Reads proto shards from one episode directory
    (controller_reader.py:39-237)."""

    def __init__(self, input_dir: str):
        self._input_dir = input_dir

    def _shards(
        self,
        prefix: str,
        start: Optional[datetime.datetime] = None,
        end: Optional[datetime.datetime] = None,
    ) -> List[str]:
        """Shard files for prefix, filtered to [start, end] by their hourly
        serial (controller_reader.py:160-185)."""
        if start is not None:
            start = as_utc(start).replace(minute=0, second=0, microsecond=0)
        if end is not None:
            end = as_utc(end)
        out = []
        for name in sorted(os.listdir(self._input_dir)):
            if not name.startswith(prefix + "_"):
                continue
            try:
                ts = datetime.datetime(*(int(p) for p in name[len(prefix) + 1:].split(".")),
                                       tzinfo=UTC)
            except (TypeError, ValueError):
                continue
            if (start is not None and ts < start) or (end is not None and ts > end):
                continue
            out.append(os.path.join(self._input_dir, name))
        return out

    def _read_prefixed(self, prefix: str, start=None, end=None) -> List[Message]:
        message_type = _PREFIX_TO_MESSAGE[prefix]
        out: List[Message] = []
        for shard in self._shards(prefix, start, end):
            out.extend(read_records(shard, message_type))
        return out

    def read_observation_responses(self, start=None, end=None):
        return self._read_prefixed(constants.OBSERVATION_RESPONSE_FILE_PREFIX, start, end)

    def read_action_responses(self, start=None, end=None):
        return self._read_prefixed(constants.ACTION_RESPONSE_FILE_PREFIX, start, end)

    def read_reward_infos(self, start=None, end=None):
        return self._read_prefixed(constants.REWARD_INFO_PREFIX, start, end)

    def read_reward_responses(self, start=None, end=None):
        return self._read_prefixed(constants.REWARD_RESPONSE_PREFIX, start, end)

    def _read_file(self, name: str, message_type: Type[Message]) -> List[Message]:
        path = os.path.join(self._input_dir, name)
        return list(read_records(path, message_type)) if os.path.exists(path) else []

    def read_device_infos(self):
        return self._read_file(constants.DEVICE_INFO_PREFIX + "s", building_pb2.DeviceInfo)

    def read_zone_infos(self):
        return self._read_file(constants.ZONE_INFO_PREFIX + "s", building_pb2.ZoneInfo)

    def read_normalization_info(self):
        infos = self._read_file(constants.NORMALIZATION_FILENAME,
                                normalization_pb2.ContinuousVariableInfo)
        return {info.id: info for info in infos}


def get_episode_data(metrics_path: str) -> Dict[str, np.ndarray]:
    """Scans episode directories into summary columns, one numpy array per
    column and a row per episode with reward responses
    (controller_reader.py:240-316; the JAX package returns the same rows
    as a DataFrame)."""
    rows = []
    for episode in sorted(os.listdir(metrics_path)):
        episode_dir = os.path.join(metrics_path, episode)
        if not os.path.isdir(episode_dir):
            continue
        rewards = RecordReader(episode_dir).read_reward_responses()
        if not rewards:
            continue
        rows.append({
            "episode": episode,
            "n_steps": len(rewards),
            "cumulative_reward": sum(r.agent_reward_value for r in rewards),
            "electricity_cost": sum(r.electricity_energy_cost for r in rewards),
            "gas_cost": sum(r.natural_gas_energy_cost for r in rewards),
            "carbon_emitted": sum(r.carbon_emitted for r in rewards),
        })
    keys = ("episode", "n_steps", "cumulative_reward", "electricity_cost", "gas_cost",
            "carbon_emitted")
    return {k: np.asarray([row[k] for row in rows]) for k in keys}

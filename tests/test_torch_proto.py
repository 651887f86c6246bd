"""The port's proto3 wire runtime (sbsim_tpu_torch/proto) against protobuf.

The port cannot import protobuf (the card's machine has none), so it keeps
the three schemas as static field tables over its own runtime. Here,
where protobuf is installed, every message type is held to the JAX
package's generated `*_pb2` modules:

* the field tables equal the descriptors field for field (name, number,
  type, repeated, oneof, map key/value, enum names and values);
* seeded random contents (negative int32, -0.0, NaN, infinities, empty and
  non-ASCII strings, oneofs set to their default, maps holding default
  values, empty sub-messages) serialize to exactly
  `SerializeToString(deterministic=True)`, each side parses the other's
  bytes to an equal message, and float reads equal protobuf's float32
  rounding;
* two messages' bytes concatenated parse as protobuf parses them (the last
  scalar wins, repeated fields append, sub-messages merge);
* presence, oneof switches, unknown fields and the Timestamp conversions.
"""

import datetime
import math
import struct

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
from google.protobuf import timestamp_pb2 as pb_timestamp
from google.protobuf.descriptor import FieldDescriptor

from sbsim_tpu.proto import building_pb2 as pb_building
from sbsim_tpu.proto import normalization_pb2 as pb_normalization
from sbsim_tpu.proto import reward_pb2 as pb_reward
from sbsim_tpu_torch.proto import _message, _wire
from sbsim_tpu_torch.proto import building_pb2, normalization_pb2, reward_pb2, timestamp_pb2

M = _message

# (port type, protobuf type) for every message type of the three schemas
# and the Timestamp they import.
TYPES = [
    (building_pb2.ZoneInfo, pb_building.ZoneInfo),
    (building_pb2.DeviceInfo, pb_building.DeviceInfo),
    (building_pb2.SingleObservationRequest, pb_building.SingleObservationRequest),
    (building_pb2.SingleObservationResponse, pb_building.SingleObservationResponse),
    (building_pb2.ObservationRequest, pb_building.ObservationRequest),
    (building_pb2.ObservationResponse, pb_building.ObservationResponse),
    (building_pb2.SingleActionRequest, pb_building.SingleActionRequest),
    (building_pb2.SingleActionResponse, pb_building.SingleActionResponse),
    (building_pb2.ActionRequest, pb_building.ActionRequest),
    (building_pb2.ActionResponse, pb_building.ActionResponse),
    (reward_pb2.RewardInfo, pb_reward.RewardInfo),
    (reward_pb2.RewardInfo.ZoneRewardInfo, pb_reward.RewardInfo.ZoneRewardInfo),
    (reward_pb2.RewardInfo.AirHandlerRewardInfo, pb_reward.RewardInfo.AirHandlerRewardInfo),
    (reward_pb2.RewardInfo.BoilerRewardInfo, pb_reward.RewardInfo.BoilerRewardInfo),
    (reward_pb2.RewardResponse, pb_reward.RewardResponse),
    (normalization_pb2.ContinuousVariableInfo, pb_normalization.ContinuousVariableInfo),
    (timestamp_pb2.Timestamp, pb_timestamp.Timestamp),
]
IDS = [p.FULL_NAME.split(".", 3)[-1] for p, _ in TYPES]
_PB_OF = {p: q for p, q in TYPES}
_KIND_TYPE = {
    M.STRING: FieldDescriptor.TYPE_STRING, M.FLOAT: FieldDescriptor.TYPE_FLOAT,
    M.INT32: FieldDescriptor.TYPE_INT32, M.INT64: FieldDescriptor.TYPE_INT64,
    M.BOOL: FieldDescriptor.TYPE_BOOL, M.ENUM: FieldDescriptor.TYPE_ENUM,
    M.MESSAGE: FieldDescriptor.TYPE_MESSAGE,
}
SEEDS = range(6)


def _bits(x: float) -> bytes:
    return struct.pack("<f", x)


# ---- field tables against the descriptors -----------------------------------


def _check_enum(port_enum, pb_enum_descriptor):
    assert port_enum.name == pb_enum_descriptor.name
    assert port_enum.items() == [(v.name, v.number) for v in pb_enum_descriptor.values]


@pytest.mark.parametrize("port,pb", TYPES, ids=IDS)
def test_field_table_equals_descriptor(port, pb):
    d = pb.DESCRIPTOR
    assert port.FULL_NAME == d.full_name
    assert [f.name for f in port.FIELDS] == sorted(d.fields_by_name, key=lambda n: d.fields_by_name[
        n].number)
    for f in port.FIELDS:
        fd = d.fields_by_name[f.name]
        assert f.number == fd.number
        assert (fd.containing_oneof.name if fd.containing_oneof else None) == f.oneof
        if f.kind == M.MAP:
            assert fd.type == FieldDescriptor.TYPE_MESSAGE and fd.message_type.GetOptions().map_entry
            key, value = fd.message_type.fields_by_name["key"], fd.message_type.fields_by_name["value"]
            assert key.type == FieldDescriptor.TYPE_STRING
            assert value.type == _KIND_TYPE[f.value_kind]
            assert not f.repeated
            vd = value
        else:
            assert fd.type == _KIND_TYPE[f.kind]
            assert f.repeated == fd.is_repeated
            vd = fd
        if vd.type == FieldDescriptor.TYPE_ENUM:
            _check_enum(f.type, vd.enum_type)
        if vd.type == FieldDescriptor.TYPE_MESSAGE:
            assert f.type.FULL_NAME == vd.message_type.full_name
            assert _PB_OF[f.type].DESCRIPTOR.full_name == vd.message_type.full_name
    # Nested enums: by attribute, both ways, with Name/Value.
    for ed in d.enum_types:
        enum = getattr(port, ed.name)
        _check_enum(enum, ed)
        pb_enum = getattr(pb, ed.name)
        for v in ed.values:
            assert getattr(port, v.name) == getattr(enum, v.name) == getattr(pb, v.name)
            assert enum.Name(v.number) == pb_enum.Name(v.number)
            assert enum.Value(v.name) == pb_enum.Value(v.name)


def test_every_message_type_has_a_table():
    names = set()

    def walk(d):
        if not d.GetOptions().map_entry:
            names.add(d.full_name)
            for n in d.nested_types:
                walk(n)

    for mod in (pb_building, pb_reward, pb_normalization):
        for d in mod.DESCRIPTOR.message_types_by_name.values():
            walk(d)
    walk(pb_timestamp.Timestamp.DESCRIPTOR)
    assert names == {p.FULL_NAME for p, _ in TYPES}


# ---- seeded contents ------------------------------------------------------------

_STRINGS = ["", "a", "zone_id_1", "é", "漢字", "\U0001f600x", "ascii then é", "x" * 200]
_FLOATS = [0.0, -0.0, math.nan, math.inf, -math.inf, 1e-45, 3.4e38, 1e39, -1e39, 0.1, 294.15]
_INT32 = [0, 1, -1, 127, 128, 300, -(2**31), 2**31 - 1]
_INT64 = [0, 1, -1, 2**40, -(2**62), 2**63 - 1]


def _scalar(kind, enum, rs):
    if kind == M.STRING:
        return _STRINGS[rs.integers(len(_STRINGS))]
    if kind == M.FLOAT:
        return (_FLOATS[rs.integers(len(_FLOATS))] if rs.random() < 0.6
                else float(rs.normal() * 10.0 ** rs.integers(-6, 7)))
    if kind == M.BOOL:
        return bool(rs.integers(2))
    if kind == M.ENUM:
        values = enum.values()
        return 99 if rs.random() < 0.1 else values[rs.integers(len(values))]
    pool = _INT32 if kind == M.INT32 else _INT64
    bits = 31 if kind == M.INT32 else 63
    return (pool[rs.integers(len(pool))] if rs.random() < 0.6
            else int(rs.integers(-(2**bits), 2**bits)))


def _default(kind):
    return {M.STRING: "", M.FLOAT: 0.0, M.BOOL: False}.get(kind, 0)


def make_spec(cls, rs, depth=0):
    """A random list of (field, value) assignments for a message of `cls`;
    a sub-message's value is its own list (empty: present and empty)."""
    spec = []
    for f in cls.FIELDS:
        if rs.random() < 0.25:
            continue
        if f.kind == M.MAP:
            keys = sorted({_STRINGS[i] for i in rs.integers(len(_STRINGS), size=rs.integers(4))})
            spec.append((f, [(k, make_spec(f.type, rs, depth + 1) if f.value_kind == M.MESSAGE
                              else (_default(f.value_kind) if rs.random() < 0.3
                                    else _scalar(f.value_kind, f.type, rs)))
                             for k in keys]))
        elif f.repeated:
            n = int(rs.integers(4))
            spec.append((f, [make_spec(f.type, rs, depth + 1) if f.kind == M.MESSAGE
                             else _scalar(f.kind, f.type, rs) for _ in range(n)]))
        elif f.kind == M.MESSAGE:
            spec.append((f, [] if depth > 2 or rs.random() < 0.2
                         else make_spec(f.type, rs, depth + 1)))
        elif f.oneof is not None and rs.random() < 0.3:
            spec.append((f, _default(f.kind)))  # a oneof member at its default
        else:
            spec.append((f, _scalar(f.kind, f.type, rs)))
    return spec


def apply_spec(msg, spec):
    """Applies a spec through the API both runtimes share."""
    for f, v in spec:
        if f.kind == M.MAP:
            target = getattr(msg, f.name)
            for k, value in v:
                if f.value_kind == M.MESSAGE:
                    apply_spec(target[k], value)
                else:
                    target[k] = value
        elif f.repeated:
            target = getattr(msg, f.name)
            if f.kind == M.MESSAGE:
                for value in v:
                    apply_spec(target.add(), value)
            else:
                target.extend(v)
        elif f.kind == M.MESSAGE:
            sub = getattr(msg, f.name)
            if v:
                apply_spec(sub, v)
            else:
                sub.CopyFrom(type(sub)())
        else:
            setattr(msg, f.name, v)
    return msg


def _check_float_reads(port_msg, pb_msg):
    """Every float read equals protobuf's (float32 bits), recursively."""
    for f in type(port_msg).FIELDS:
        if f.kind == M.FLOAT and not f.repeated:
            assert _bits(getattr(port_msg, f.name)) == _bits(getattr(pb_msg, f.name)), f.name
        elif f.kind == M.MESSAGE and not f.repeated:
            assert port_msg.HasField(f.name) == pb_msg.HasField(f.name), f.name
            _check_float_reads(getattr(port_msg, f.name), getattr(pb_msg, f.name))
        elif f.kind == M.MESSAGE:
            for a, b in zip(getattr(port_msg, f.name), getattr(pb_msg, f.name), strict=True):
                _check_float_reads(a, b)
        elif f.kind == M.MAP and f.value_kind == M.MESSAGE:
            a, b = getattr(port_msg, f.name), getattr(pb_msg, f.name)
            assert sorted(a.keys()) == sorted(b.keys())
            for k in a:
                _check_float_reads(a[k], b[k])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("port,pb", TYPES, ids=IDS)
def test_bytes_equal_protobuf_and_parse_both_ways(port, pb, seed):
    spec = make_spec(port, np.random.default_rng(1000 * TYPES.index((port, pb)) + seed))
    ours, theirs = apply_spec(port(), spec), apply_spec(pb(), spec)
    data = ours.SerializeToString()
    assert data == theirs.SerializeToString(deterministic=True)
    _check_float_reads(ours, theirs)
    back = pb.FromString(data)
    assert back == theirs and back.SerializeToString(deterministic=True) == data
    mine = port.FromString(theirs.SerializeToString(deterministic=True))
    assert mine == ours and mine.SerializeToString() == data
    _check_float_reads(mine, theirs)
    # CopyFrom and MergeFrom through the API, as protobuf does them.
    other = apply_spec(port(), make_spec(port, np.random.default_rng(seed + 77)))
    pb_other = pb.FromString(other.SerializeToString())
    copy = port()
    copy.CopyFrom(ours)
    copy.MergeFrom(other)
    pb_copy = pb()
    pb_copy.CopyFrom(theirs)
    pb_copy.MergeFrom(pb_other)
    assert copy.SerializeToString() == pb_copy.SerializeToString(deterministic=True)


@pytest.mark.parametrize("port,pb", TYPES, ids=IDS)
def test_concatenated_messages_parse_as_protobuf_parses_them(port, pb):
    """Two messages' bytes back to back: the last scalar wins, repeated
    fields append, sub-messages merge, map entries replace."""
    i = TYPES.index((port, pb))
    a = apply_spec(port(), make_spec(port, np.random.default_rng(5000 + i)))
    b = apply_spec(port(), make_spec(port, np.random.default_rng(6000 + i)))
    data = a.SerializeToString() + b.SerializeToString()
    want = pb.FromString(data)
    got = port.FromString(data)
    assert got.SerializeToString() == want.SerializeToString(deterministic=True)
    merged = port()
    merged.ParseFromString(a.SerializeToString())
    merged.MergeFromString(b.SerializeToString())
    assert merged == got


@hypothesis.settings(max_examples=60, deadline=None, derandomize=True)
@hypothesis.given(
    reward=st.floats(width=32) | st.floats(allow_nan=True, allow_infinity=True),
    ints=st.lists(st.integers(-(2**31), 2**31 - 1), min_size=1, max_size=4),
    text=st.text(max_size=20),
    valid=st.booleans(),
)
def test_hypothesis_contents(reward, ints, text, valid):
    """Doubles, float32 values, int32s and any text, on a response with a
    oneof, a nested request and a map."""
    kw = dict(agent_reward_value=reward, carbon_cost=-reward)
    assert reward_pb2.RewardResponse(**kw).SerializeToString() == pb_reward.RewardResponse(
        **kw).SerializeToString(deterministic=True)
    assert _bits(reward_pb2.RewardResponse(**kw).agent_reward_value) == _bits(
        pb_reward.RewardResponse(**kw).agent_reward_value)
    for port, pb in ((building_pb2, pb_building),):
        msgs = []
        for mod in (port, pb):
            r = mod.ObservationResponse()
            r.request.single_observation_requests.add(device_id=text, measurement_name="m")
            for v in ints:
                s = r.single_observation_responses.add(observation_valid=valid)
                s.integer_value = v
                s.single_observation_request.device_id = text
            d = mod.DeviceInfo(device_id=text, zone_id=text[::-1])
            d.observable_fields[text] = ints[0] % 5
            msgs.append((r, d))
        (r1, d1), (r2, d2) = msgs
        assert r1.SerializeToString() == r2.SerializeToString(deterministic=True)
        assert d1.SerializeToString() == d2.SerializeToString(deterministic=True)
        assert port.ObservationResponse.FromString(r2.SerializeToString()) == r1


# ---- the semantics named one by one ---------------------------------------------


@pytest.mark.parametrize("make,want", [
    (lambda: reward_pb2.RewardResponse(agent_reward_value=-0.0), "0d00000080"),
    (lambda: reward_pb2.RewardResponse(agent_reward_value=0.0), ""),
    (lambda: building_pb2.SingleObservationResponse(continuous_value=0.0), "2500000000"),
    (lambda: building_pb2.ZoneInfo(floor=-1), "38ffffffffffffffffff01"),
    (lambda: building_pb2.DeviceInfo(observable_fields={"b": 0}), "32050a01621000"),
    (lambda: building_pb2.ZoneInfo(floor=3, zone_id="z", area=1.5),
     "0a017a250000c03f3803"),
], ids=["minus_zero", "plus_zero", "oneof_default", "negative_int32", "map_default",
        "field_order"])
def test_named_encodings(make, want):
    assert make().SerializeToString().hex() == want


def test_float_rounds_to_float32_on_assignment():
    assert reward_pb2.RewardResponse(agent_reward_value=0.1).agent_reward_value == (
        0.10000000149011612)
    r = building_pb2.SingleActionRequest()
    r.continuous_value = 294.123456789
    assert r.continuous_value == float(np.float32(294.123456789))
    assert reward_pb2.RewardResponse(agent_reward_value=1e39).agent_reward_value == math.inf


def test_presence():
    o = building_pb2.ObservationResponse()
    sub = o.request
    assert not o.HasField("request") and o.SerializeToString() == b""
    assert sub.timestamp.seconds == 0 and not o.HasField("request")
    sub.timestamp.seconds = 0  # writing, even the default, sets presence up the chain
    assert o.HasField("request") and sub.HasField("timestamp")
    assert o.SerializeToString().hex() == "12020a00"
    o = building_pb2.ObservationResponse()
    o.request.CopyFrom(building_pb2.ObservationRequest())
    assert o.SerializeToString().hex() == "1200"
    o = building_pb2.ObservationResponse()
    o.request.single_observation_requests.add()
    assert o.HasField("request")
    o.ClearField("request")
    assert not o.HasField("request") and o.SerializeToString() == b""
    sub = o.request
    o.Clear()
    sub.timestamp.seconds = 5  # a default read before Clear is detached
    assert not o.HasField("request") and o.SerializeToString() == b""
    with pytest.raises(ValueError):
        o.HasField("single_observation_responses")
    with pytest.raises(AttributeError):
        o.request = building_pb2.ObservationRequest()
    info = reward_pb2.RewardInfo()
    assert info.zone_reward_infos.get("a") is None and len(info.zone_reward_infos) == 0
    info.zone_reward_infos["a"]  # a message map creates on first read
    assert "a" in info.zone_reward_infos
    assert info.SerializeToString() == pb_reward.RewardInfo(
        zone_reward_infos={"a": {}}).SerializeToString(deterministic=True)


def test_oneof_switch_clears_the_old_member():
    r = building_pb2.SingleActionRequest(continuous_value=2.5)
    assert r.WhichOneof("setpoint_value") == "continuous_value"
    r.integer_value = 0
    assert r.WhichOneof("setpoint_value") == "integer_value"
    assert r.continuous_value == 0.0 and not r.HasField("continuous_value")
    assert r.HasField("integer_value") and r.HasField("setpoint_value")
    assert r.SerializeToString().hex() == "2000"
    r.ClearField("setpoint_value")
    assert r.WhichOneof("setpoint_value") is None and r.SerializeToString() == b""
    with pytest.raises(ValueError):
        r.HasField("device_id")  # a proto3 scalar has no presence


def test_unknown_fields_are_skipped():
    extra = (_wire.encode_tag(99, _wire.VARINT) + _wire.encode_varint(5)
             + _wire.encode_tag(98, _wire.LENGTH) + _wire.encode_length(b"abc")
             + _wire.encode_tag(97, _wire.FIXED32) + b"\0\0\0\0"
             + _wire.encode_tag(96, _wire.FIXED64) + b"\0" * 8)
    known = building_pb2.ZoneInfo(zone_id="z", floor=-2).SerializeToString()
    # Field 1 with the wrong wire type is skipped as protobuf skips it.
    wrong = _wire.encode_tag(1, _wire.VARINT) + _wire.encode_varint(7)
    got = building_pb2.ZoneInfo.FromString(extra + known + wrong)
    assert got == building_pb2.ZoneInfo(zone_id="z", floor=-2)
    assert got.zone_id == pb_building.ZoneInfo.FromString(extra + known + wrong).zone_id


def test_truncated_bytes_raise():
    data = building_pb2.ZoneInfo(zone_id="zone").SerializeToString()
    with pytest.raises(_wire.DecodeError):
        building_pb2.ZoneInfo.FromString(data[:-1])


def test_type_and_range_checks():
    with pytest.raises(TypeError):
        building_pb2.ZoneInfo(area="1.0")
    with pytest.raises(TypeError):
        building_pb2.ZoneInfo(floor=1.0)
    with pytest.raises(ValueError):
        building_pb2.ZoneInfo(floor=2**31)
    with pytest.raises(ValueError):
        building_pb2.ZoneInfo(no_such_field=1)
    assert building_pb2.ZoneInfo(zone_type="ROOM").zone_type == building_pb2.ZoneInfo.ROOM
    assert building_pb2.ZoneInfo(floor=np.int64(3), area=np.float32(1.5)) == building_pb2.ZoneInfo(
        floor=3, area=1.5)


@pytest.mark.parametrize("nanos", [0, 1, -1, 1_689_000_000_123_456_789, -86_400_000_000_001,
                                   999_999_999])
def test_timestamp_nanoseconds(nanos):
    ours, theirs = timestamp_pb2.Timestamp(), pb_timestamp.Timestamp()
    ours.FromNanoseconds(nanos)
    theirs.FromNanoseconds(nanos)
    assert (ours.seconds, ours.nanos) == (theirs.seconds, theirs.nanos)
    assert ours.ToNanoseconds() == theirs.ToNanoseconds() == nanos
    assert ours.SerializeToString() == theirs.SerializeToString(deterministic=True)


@pytest.mark.parametrize("dt", [
    datetime.datetime(2023, 7, 6, 7, 0, tzinfo=datetime.timezone.utc),
    datetime.datetime(2023, 7, 6, 7, 30, 15, 123456),  # naive: taken as UTC
    datetime.datetime(2023, 11, 5, 1, 30, tzinfo=datetime.timezone(datetime.timedelta(hours=-8))),
    datetime.datetime(1969, 12, 31, 23, 59, 59, 999999, tzinfo=datetime.timezone.utc),
])
def test_timestamp_datetimes(dt):
    ours, theirs = timestamp_pb2.Timestamp(), pb_timestamp.Timestamp()
    ours.FromDatetime(dt)
    theirs.FromDatetime(dt)
    assert (ours.seconds, ours.nanos) == (theirs.seconds, theirs.nanos)
    assert ours.ToDatetime() == theirs.ToDatetime()
    for tz in (datetime.timezone.utc, datetime.timezone(datetime.timedelta(hours=5, minutes=30))):
        assert ours.ToDatetime(tzinfo=tz) == theirs.ToDatetime(tzinfo=tz)
        assert ours.ToDatetime(tzinfo=tz).utcoffset() == theirs.ToDatetime(tzinfo=tz).utcoffset()

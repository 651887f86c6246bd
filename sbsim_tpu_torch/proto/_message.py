"""One schema-driven proto3 message class.

Each message type is a subclass of `Message` made by `message_type` from a
static table of `Field`s. Its bytes equal protobuf's
`SerializeToString(deterministic=True)`:

* fields in field-number order; a scalar only when it is not its default
  (a float when its float32 bits are nonzero, so -0.0 and NaN are written);
* a oneof member whenever it is set, even at its default; setting one
  member clears the others;
* a sub-message when it is present, even empty; reading an unset one gives
  a default that sets presence only once it is written into;
* map entries sorted by key as upb sorts them (by UTF-8 bytes, a key
  before its own prefixes), key and value always written;
* float fields round to float32 when assigned.

Parsing keeps the last occurrence of a scalar, appends repeated fields,
merges repeated occurrences of a sub-message and skips unknown fields.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Dict, Iterable, Optional, Sequence, Tuple

from sbsim_tpu_torch.proto import _wire
from sbsim_tpu_torch.proto._wire import DecodeError

STRING, FLOAT, INT32, INT64, BOOL, ENUM, MESSAGE, MAP = (
    "string", "float", "int32", "int64", "bool", "enum", "message", "map")

_WIRE_TYPE = {STRING: _wire.LENGTH, FLOAT: _wire.FIXED32, INT32: _wire.VARINT,
              INT64: _wire.VARINT, BOOL: _wire.VARINT, ENUM: _wire.VARINT,
              MESSAGE: _wire.LENGTH, MAP: _wire.LENGTH}
_DEFAULT = {STRING: "", FLOAT: 0.0, INT32: 0, INT64: 0, BOOL: False, ENUM: 0}
_INT_BITS = {INT32: 32, INT64: 64, ENUM: 32}


class EnumType:
    """A proto enum: values by attribute, `Name(number)`, `Value(name)`."""

    def __init__(self, name: str, values: Sequence[Tuple[str, int]]):
        self.name = name
        self._by_name = dict(values)
        self._by_number = {v: k for k, v in reversed(values)}

    def __getattr__(self, name):
        try:
            return self.__dict__["_by_name"][name]
        except KeyError:
            raise AttributeError(name) from None

    def Name(self, number: int) -> str:
        try:
            return self._by_number[number]
        except KeyError:
            raise ValueError(f"enum {self.name} has no value {number}") from None

    def Value(self, name: str) -> int:
        try:
            return self._by_name[name]
        except KeyError:
            raise ValueError(f"enum {self.name} has no value named {name!r}") from None

    def values(self):
        return list(self._by_name.values())

    def items(self):
        return list(self._by_name.items())


@dataclasses.dataclass(frozen=True)
class Field:
    """One field of a message table. `type` is the enum or message type of
    an enum, message or map field (the map's value type); `value_kind` the
    kind of a map's values (its keys are strings)."""

    name: str
    number: int
    kind: str
    type: object = None
    repeated: bool = False
    oneof: Optional[str] = None
    value_kind: Optional[str] = None

    def __post_init__(self):
        # The field's key bytes, encoded once.
        object.__setattr__(self, "tag", _wire.encode_tag(self.number, self.wire_type))

    @property
    def wire_type(self) -> int:
        return _WIRE_TYPE[self.kind]


def _check_scalar(kind: str, value, enum: Optional[EnumType] = None):
    """`value` as stored in a field of `kind`, or TypeError/ValueError as
    protobuf raises them."""
    if kind == FLOAT:
        if isinstance(value, (str, bytes)):
            raise TypeError(f"must be real number, not {type(value).__name__}")
        return _wire.round_f32(float(value))
    if kind == STRING:
        if isinstance(value, bytes):
            try:
                return value.decode("utf-8")
            except UnicodeDecodeError:
                raise ValueError(f"{value!r} is not valid UTF-8") from None
        if not isinstance(value, str):
            raise TypeError(f"{value!r} has type {type(value).__name__}, but expected str")
        return value
    if kind == BOOL:
        if isinstance(value, (str, bytes)):
            raise TypeError(f"{value!r} has type {type(value).__name__}, but expected bool")
        return bool(value)
    if kind == ENUM and isinstance(value, str):
        return enum.Value(value)
    value = operator.index(value)
    bits = _INT_BITS[kind]
    if not -(1 << (bits - 1)) <= value < (1 << (bits - 1)):
        raise ValueError(f"Value out of range: {value}")
    return value


def _encode_scalar(kind: str, value) -> bytes:
    if kind == FLOAT:
        return _wire.encode_float(value)
    if kind == STRING:
        return _wire.encode_length(value.encode("utf-8"))
    return _wire.encode_varint(int(value))


def _decode_scalar(kind: str, data: bytes, pos: int):
    if kind == FLOAT:
        return _wire.decode_float(data, pos)
    if kind == STRING:
        raw, pos = _wire.decode_length(data, pos)
        try:
            return raw.decode("utf-8"), pos
        except UnicodeDecodeError:
            raise DecodeError("string field is not valid UTF-8") from None
    value, pos = _wire.decode_varint(data, pos)
    if kind == BOOL:
        return value != 0, pos
    return _wire.to_signed(value, _INT_BITS[kind]), pos


def _map_order(key: str) -> bytes:
    """Sort key of a map entry, as upb's deterministic serializer orders
    string keys: by their UTF-8 bytes, a key before any of its prefixes
    ("ab" before "a"). 0xff never occurs in UTF-8, so it sorts after every
    byte of a longer key."""
    return key.encode("utf-8") + b"\xff"


def _scalar_is_set(kind: str, value) -> bool:
    return _wire.float_is_set(value) if kind == FLOAT else value != _DEFAULT[kind]


class RepeatedScalar:
    """A repeated string (or other scalar) field."""

    __slots__ = ("_owner", "_kind", "_items")

    def __init__(self, owner: "Message", kind: str):
        self._owner, self._kind, self._items = owner, kind, []

    def append(self, value) -> None:
        self._items.append(_check_scalar(self._kind, value))
        self._owner._modified()

    def extend(self, values: Iterable) -> None:
        self._items.extend(_check_scalar(self._kind, v) for v in values)
        self._owner._modified()

    def __getitem__(self, i):
        return self._items[i]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedScalar):
            other = other._items
        return self._items == list(other)

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._items)


class RepeatedComposite:
    """A repeated message field: `add(**fields)` appends a new element."""

    __slots__ = ("_owner", "_type", "_items")

    def __init__(self, owner: "Message", message_cls):
        self._owner, self._type, self._items = owner, message_cls, []

    def add(self, **fields) -> "Message":
        msg = self._type(**fields)
        self._items.append(msg)
        self._owner._modified()
        return msg

    def __getitem__(self, i):
        return self._items[i]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedComposite):
            other = other._items
        return self._items == list(other)

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._items)


class _Map:
    __slots__ = ("_owner", "_field", "_items")

    def __init__(self, owner: "Message", field: Field):
        self._owner, self._field, self._items = owner, field, {}

    def __contains__(self, key) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def keys(self):
        return self._items.keys()

    def values(self):
        return self._items.values()

    def items(self):
        return self._items.items()

    def get(self, key, default=None):
        return self._items.get(key, default)

    def __eq__(self, other) -> bool:
        if isinstance(other, _Map):
            other = other._items
        return self._items == dict(other)

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._items)


class ScalarMap(_Map):
    """map<string, scalar or enum>. Reading a missing key inserts its
    default, as protobuf does."""

    __slots__ = ()

    def __getitem__(self, key):
        if key not in self._items:
            self[key] = _DEFAULT[self._field.value_kind]
        return self._items[key]

    def __setitem__(self, key, value) -> None:
        f = self._field
        self._items[_check_scalar(STRING, key)] = _check_scalar(f.value_kind, value, f.type)
        self._owner._modified()


class MessageMap(_Map):
    """map<string, message>: `m[key]` creates the value on first read."""

    __slots__ = ()

    def __getitem__(self, key):
        msg = self._items.get(key)
        if msg is None:
            msg = self._items[_check_scalar(STRING, key)] = self._field.type()
            self._owner._modified()
        return msg

    def __setitem__(self, key, value) -> None:
        raise ValueError("May not set values directly, call my_map[key].foo = 5")


class Message:
    """Base class of the schema-driven messages (see `message_type`)."""

    __slots__ = ("_values", "_present", "_oneofs", "_parent")
    FULL_NAME = ""
    FIELDS: Tuple[Field, ...] = ()
    _BY_NAME: Dict[str, Field] = {}
    _BY_NUMBER: Dict[int, Field] = {}
    _ONEOFS: Dict[str, Tuple[str, ...]] = {}

    def __init__(self, **fields):
        self._values = {}
        self._present = set()
        self._oneofs = {}
        self._parent = None
        for name, value in fields.items():
            if value is None:
                continue
            f = self._BY_NAME.get(name)
            if f is None:
                raise ValueError(f'Protocol message {type(self).__name__} has no "{name}" field.')
            if f.kind == MAP:
                target = getattr(self, name)
                for k, v in dict(value).items():
                    if f.value_kind == MESSAGE:
                        _assign_message(target[k], v)
                    else:
                        target[k] = v
            elif f.repeated:
                target = getattr(self, name)
                if f.kind == MESSAGE:
                    for v in value:
                        _assign_message(target.add(), v)
                else:
                    target.extend(value)
            elif f.kind == MESSAGE:
                _assign_message(getattr(self, name), value)
            else:
                setattr(self, name, value)

    # -- presence ----------------------------------------------------------

    def _modified(self) -> None:
        """Marks this message present in the chain of messages that hold it
        (a default sub-message becomes a set one once written into)."""
        msg = self
        while msg._parent is not None:
            parent, name = msg._parent
            msg._parent = None
            if parent._values.get(name) is not msg:
                return  # cleared from its parent since it was read
            parent._present.add(name)
            msg = parent

    def HasField(self, name: str) -> bool:
        if name in self._ONEOFS:
            return name in self._oneofs
        f = self._BY_NAME.get(name)
        if f is None:
            raise ValueError(f'Protocol message has no "{name}" field.')
        if f.oneof is not None:
            return self._oneofs.get(f.oneof) == name
        if f.kind == MESSAGE and not f.repeated:
            return name in self._present
        raise ValueError(f"Field {self.FULL_NAME}.{name} does not have presence.")

    def WhichOneof(self, group: str) -> Optional[str]:
        if group not in self._ONEOFS:
            raise ValueError(f'Protocol message has no oneof "{group}" field.')
        return self._oneofs.get(group)

    def ClearField(self, name: str) -> None:
        if name in self._ONEOFS:
            name = self._oneofs.get(name)
            if name is None:
                return
        elif name not in self._BY_NAME:
            raise ValueError(f'Protocol message has no "{name}" field.')
        f = self._BY_NAME[name]
        self._values.pop(name, None)
        self._present.discard(name)
        if f.oneof is not None and self._oneofs.get(f.oneof) == name:
            del self._oneofs[f.oneof]

    def Clear(self) -> None:
        self._values.clear()
        self._present.clear()
        self._oneofs.clear()

    # -- copy and merge ------------------------------------------------------

    def _check_type(self, other) -> None:
        if type(other) is not type(self):
            raise TypeError(f"Parameter to CopyFrom/MergeFrom must be instance of same class: "
                            f"expected {self.FULL_NAME} got {type(other).__name__}.")

    def CopyFrom(self, other: "Message") -> None:
        self._check_type(other)
        if other is self:
            return
        self.Clear()
        self._copy(other)
        self._modified()

    def _copy(self, other: "Message") -> None:
        """Copies `other` into this cleared message; its values were checked
        when they were set, so they are taken as they are."""
        values = self._values
        for name, value in other._values.items():
            f = self._BY_NAME[name]
            if f.kind == MAP:
                mine = getattr(self, name)
                if f.value_kind == MESSAGE:
                    for k, v in value._items.items():
                        mine._items[k] = m = f.type()
                        m._copy(v)
                else:
                    mine._items.update(value._items)
            elif f.repeated:
                mine = getattr(self, name)
                if f.kind == MESSAGE:
                    for v in value._items:
                        mine._items.append(m := f.type())
                        m._copy(v)
                else:
                    mine._items.extend(value._items)
            elif f.kind == MESSAGE:
                if name in other._present:
                    values[name] = m = f.type()
                    m._copy(value)
                    self._present.add(name)
            else:
                values[name] = value
        self._oneofs.update(other._oneofs)

    def MergeFrom(self, other: "Message") -> None:
        self._check_type(other)
        for f in self.FIELDS:
            name = f.name
            if f.kind == MAP:
                theirs = other._values.get(name)
                if theirs:
                    mine = getattr(self, name)
                    for k, v in theirs.items():
                        if f.value_kind == MESSAGE:
                            mine[k].CopyFrom(v)
                        else:
                            mine[k] = v
            elif f.repeated:
                theirs = other._values.get(name)
                if theirs:
                    mine = getattr(self, name)
                    if f.kind == MESSAGE:
                        for v in theirs:
                            mine.add().MergeFrom(v)
                    else:
                        mine.extend(theirs)
            elif f.kind == MESSAGE:
                if name in other._present:
                    getattr(self, name).MergeFrom(other._values[name])
            elif f.oneof is not None:
                if other._oneofs.get(f.oneof) == name:
                    setattr(self, name, other._values[name])
            elif name in other._values and _scalar_is_set(f.kind, other._values[name]):
                setattr(self, name, other._values[name])
        self._modified()

    # -- wire format ---------------------------------------------------------

    def SerializeToString(self, deterministic: bool = True) -> bytes:
        """The message's bytes. Map entries are always in the order of
        protobuf's deterministic=True."""
        del deterministic
        return b"".join(self._encode())

    def _encode(self):
        values = self._values
        for f in self.FIELDS:
            name = f.name
            if name not in values:
                continue
            value = values[name]
            if f.kind == MAP:
                for k in sorted(value._items, key=_map_order):
                    v = value._items[k]
                    entry = _wire.encode_tag(1, _wire.LENGTH) + _encode_scalar(STRING, k)
                    if f.value_kind == MESSAGE:
                        entry += _wire.encode_tag(2, _wire.LENGTH) + _wire.encode_length(
                            v.SerializeToString())
                    else:
                        entry += _wire.encode_tag(2, _WIRE_TYPE[f.value_kind]) + _encode_scalar(
                            f.value_kind, v)
                    yield f.tag
                    yield _wire.encode_length(entry)
            elif f.repeated:
                for v in value:
                    yield f.tag
                    if f.kind == MESSAGE:
                        yield _wire.encode_length(v.SerializeToString())
                    else:
                        yield _encode_scalar(f.kind, v)
            elif f.kind == MESSAGE:
                if name in self._present:
                    yield f.tag
                    yield _wire.encode_length(value.SerializeToString())
            elif (self._oneofs.get(f.oneof) == name if f.oneof is not None
                  else _scalar_is_set(f.kind, value)):
                yield f.tag
                yield _encode_scalar(f.kind, value)

    def ParseFromString(self, data: bytes) -> int:
        self.Clear()
        return self.MergeFromString(data)

    def MergeFromString(self, data: bytes) -> int:
        data = bytes(data)
        self._merge(data)
        self._modified()
        return len(data)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        msg.MergeFromString(data)
        return msg

    def _merge(self, data: bytes) -> None:
        pos, n = 0, len(data)
        while pos < n:
            key, pos = _wire.decode_varint(data, pos)
            number, wire_type = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = self._BY_NUMBER.get(number)
            if f is None or wire_type != f.wire_type:
                pos = _wire.skip_field(data, pos, wire_type)
                continue
            if f.kind == MESSAGE:
                raw, pos = _wire.decode_length(data, pos)
                target = getattr(self, f.name)
                (target.add() if f.repeated else target)._merge(raw)
                if not f.repeated:
                    target._modified()
            elif f.kind == MAP:
                raw, pos = _wire.decode_length(data, pos)
                self._merge_map_entry(f, raw)
            else:
                value, pos = _decode_scalar(f.kind, data, pos)
                if f.repeated:
                    getattr(self, f.name).append(value)
                else:
                    setattr(self, f.name, value)

    def _merge_map_entry(self, f: Field, raw: bytes) -> None:
        key, value, pos = "", None, 0
        while pos < len(raw):
            tag, pos = _wire.decode_varint(raw, pos)
            number, wire_type = tag >> 3, tag & 7
            if number == 1 and wire_type == _wire.LENGTH:
                key, pos = _decode_scalar(STRING, raw, pos)
            elif number == 2 and wire_type == _WIRE_TYPE[f.value_kind]:
                if f.value_kind == MESSAGE:
                    sub, pos = _wire.decode_length(raw, pos)
                    if value is None:
                        value = f.type()
                    value._merge(sub)
                else:
                    value, pos = _decode_scalar(f.value_kind, raw, pos)
            else:
                pos = _wire.skip_field(raw, pos, wire_type)
        target = getattr(self, f.name)
        if f.value_kind == MESSAGE:
            target[key].CopyFrom(value if value is not None else f.type())
        else:
            target[key] = _DEFAULT[f.value_kind] if value is None else value

    # -- comparison ---------------------------------------------------------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, Message):
            return NotImplemented
        return type(other) is type(self) and self.SerializeToString() == other.SerializeToString()

    __hash__ = None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.SerializeToString().hex()})"


def _assign_message(target: Message, value) -> None:
    """Constructor assignment of a sub-message: a message of the field's
    type is copied, a dict gives its fields."""
    if isinstance(value, dict):
        target.MergeFrom(type(target)(**value))
    else:
        target.CopyFrom(value)


def _field_property(f: Field) -> property:
    name = f.name

    if f.kind == MAP:
        container = MessageMap if f.value_kind == MESSAGE else ScalarMap

        def get(self):
            value = self._values.get(name)
            if value is None:
                value = self._values[name] = container(self, f)
            return value

        def put(self, value):
            raise AttributeError(f'Assignment not allowed to map field "{name}".')
    elif f.repeated:
        def get(self):
            value = self._values.get(name)
            if value is None:
                value = self._values[name] = (
                    RepeatedComposite(self, f.type) if f.kind == MESSAGE
                    else RepeatedScalar(self, f.kind))
            return value

        def put(self, value):
            raise AttributeError(f'Assignment not allowed to repeated field "{name}".')
    elif f.kind == MESSAGE:
        def get(self):
            value = self._values.get(name)
            if value is None:
                value = self._values[name] = f.type()
                value._parent = (self, name)
            return value

        def put(self, value):
            raise AttributeError(
                f'Assignment not allowed to message field "{name}" in protocol message object.')
    else:
        default, kind, oneof = _DEFAULT[f.kind], f.kind, f.oneof

        def get(self):
            if oneof is not None and self._oneofs.get(oneof) != name:
                return default
            return self._values.get(name, default)

        def put(self, value):
            value = _check_scalar(kind, value, f.type)
            if oneof is not None:
                other = self._oneofs.get(oneof)
                if other is not None and other != name:
                    self._values.pop(other, None)
                self._oneofs[oneof] = name
            self._values[name] = value
            self._modified()

    return property(get, put)


def message_type(
    name: str,
    full_name: str,
    fields: Sequence[Field],
    enums: Sequence[EnumType] = (),
    nested: Sequence[type] = (),
) -> type:
    """A Message subclass for one table of fields. Nested enums are
    attributes of the class, and so is each of their values (as protobuf
    has them: `DeviceInfo.DeviceType.BLR` and `DeviceInfo.BLR`); nested
    messages are attributes too."""
    fields = tuple(sorted(fields, key=lambda f: f.number))
    ns = {
        "__slots__": (),
        "FULL_NAME": full_name,
        "FIELDS": fields,
        "_BY_NAME": {f.name: f for f in fields},
        "_BY_NUMBER": {f.number: f for f in fields},
        "_ONEOFS": {},
    }
    for f in fields:
        if f.oneof is not None:
            ns["_ONEOFS"][f.oneof] = ns["_ONEOFS"].get(f.oneof, ()) + (f.name,)
        ns[f.name] = _field_property(f)
    for enum in enums:
        ns[enum.name] = enum
        ns.update(enum._by_name)
    for cls in nested:
        ns[cls.__name__] = cls
    return type(name, (Message,), ns)

"""A hand-written proto3 codec for the port's wire messages.

The JAX package speaks to the workload agent in protobuf
(``wire/workload.proto``, compiled to ``workload_pb2``). The card's
machine has no ``protobuf``, so the port carries its own message classes
(:mod:`~slurm_bridge_tpu_torch.wire.messages`), each declared by a field
table, and this module encodes and decodes them. Its output is
byte-identical to ``workload_pb2``'s ``SerializeToString`` for the same
field values, because the simulated agent draws its submits from the
wire content and every determinism digest hangs on those bytes. The
rules that matter:

- known fields are written in field-number order;
- proto3 zero values (0, "", False, b"", an all-zero double, an empty
  repeated field) are omitted, and a ``-0.0`` double is not zero;
- repeated numeric fields are packed into one length-delimited record;
- a negative ``int32``/``int64``/enum is a ten-byte varint (sign-extended
  to 64 bits);
- nested messages are length-delimited; a singular nested message is
  written when it is present (set through the constructor, ``CopyFrom``,
  a decode, or holding any non-default field), even empty.

Decoding skips unknown fields, groups included (they are not kept for
re-serialization, unlike ``workload_pb2``), takes the last value of a repeated scalar
occurrence, merges repeated occurrences of a singular message, accepts
packed and unpacked encodings of repeated numerics alike, and raises
:class:`DecodeError` on truncated or malformed bytes.

The message base class offers the slice of the generated API the
bridge, the simulated agent and the fault client use: keyword
construction (repeated and nested values are copied, as protobuf copies
them), ``SerializeToString(deterministic=...)``, ``FromString``,
``CopyFrom``, ``HasField`` on nested messages, equality, and repeated
fields whose ``add(**kw)`` returns the element held in the list and
whose ``append``/``extend`` copy.
``DESCRIPTOR`` carries the descriptor attributes
:mod:`~slurm_bridge_tpu_torch.wire.coldec` checks its tables against and
the services :mod:`~slurm_bridge_tpu_torch.wire.rpc` reads.
"""

from __future__ import annotations

import struct

__all__ = [
    "BOOL",
    "BYTES",
    "DOUBLE",
    "ENUM",
    "INT32",
    "INT64",
    "STRING",
    "REPEATED",
    "DecodeError",
    "Descriptor",
    "FieldDescriptor",
    "FileDescriptor",
    "Message",
    "MethodDescriptor",
    "ServiceDescriptor",
]

# field types, numbered as protobuf's FieldDescriptor.TYPE_* constants
DOUBLE = 1
INT64 = 3
INT32 = 5
BOOL = 8
STRING = 9
MESSAGE = 11
BYTES = 12
ENUM = 14

#: label of a repeated field (protobuf's FieldDescriptor.LABEL_REPEATED)
REPEATED = 3
_OPTIONAL = 1

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

_WIRE_OF_TYPE = {
    DOUBLE: _I64, INT64: _VARINT, INT32: _VARINT, BOOL: _VARINT,
    STRING: _LEN, MESSAGE: _LEN, BYTES: _LEN, ENUM: _VARINT,
}
_ZERO_OF_TYPE = {
    DOUBLE: 0.0, INT64: 0, INT32: 0, BOOL: False, STRING: "", BYTES: b"",
    ENUM: 0,
}

_MASK64 = (1 << 64) - 1
_ONE_BYTE = [bytes((i,)) for i in range(128)]
_pack_d = struct.Struct("<d").pack
_unpack_d = struct.Struct("<d").unpack_from
_ZERO8 = bytes(8)


class DecodeError(ValueError):
    """Malformed wire bytes (truncated, overrunning, or an invalid tag)."""


def _varint(value: int) -> bytes:
    """One varint; a negative value is its 64-bit two's complement."""
    if 0 <= value < 128:
        return _ONE_BYTE[value]
    if value < 0:
        value &= _MASK64
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _read_varint(data: bytes, pos: int, end: int) -> tuple[int, int]:
    if pos >= end:
        raise DecodeError("truncated varint")
    b = data[pos]
    if b < 0x80:
        return b, pos + 1
    result = b & 0x7F
    shift = 7
    pos += 1
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint over 10 bytes")


def _signed64(v: int) -> int:
    v &= _MASK64
    return v - (1 << 64) if v >= (1 << 63) else v


def _signed32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


# ---- descriptors -------------------------------------------------------


class FieldDescriptor:
    """One field of a message: name, number, type and label, under the
    attribute names protobuf's descriptors use."""

    __slots__ = (
        "name", "number", "type", "label", "message_type_name",
        "message_type", "tag", "packed_tag", "default",
    )

    def __init__(self, name: str, number: int, ftype, label: int = _OPTIONAL):
        self.name = name
        self.number = number
        if isinstance(ftype, str):
            #: a nested message, by name; resolved by its FileDescriptor
            self.type = MESSAGE
            self.message_type_name = ftype
        else:
            self.type = ftype
            self.message_type_name = ""
        self.label = label
        #: the nested message's Descriptor (set on resolution)
        self.message_type = None
        self.tag = _varint(number << 3 | _WIRE_OF_TYPE[self.type])
        self.packed_tag = _varint(number << 3 | _LEN)
        self.default = _ZERO_OF_TYPE.get(self.type)

    @property
    def is_repeated(self) -> bool:
        return self.label == REPEATED

    def __repr__(self) -> str:
        return f"<FieldDescriptor {self.name}={self.number}>"


class Descriptor:
    """A message type: its fields in declaration order and by name/number."""

    def __init__(self, name: str, fields: tuple[FieldDescriptor, ...], cls):
        self.name = name
        self.fields = fields
        self.fields_by_name = {f.name: f for f in fields}
        self.fields_by_number = {f.number: f for f in fields}
        #: the message class built from this descriptor
        self._concrete_class = cls


class MethodDescriptor:
    def __init__(self, name, input_type, output_type, *, client_streaming=False,
                 server_streaming=False):
        self.name = name
        self.input_type = input_type
        self.output_type = output_type
        self.client_streaming = client_streaming
        self.server_streaming = server_streaming


class ServiceDescriptor:
    def __init__(self, full_name: str, methods: list[MethodDescriptor]):
        self.full_name = full_name
        self.name = full_name.rsplit(".", 1)[-1]
        self.methods = methods


class FileDescriptor:
    """The schema: every message type by name (their nested-message fields
    resolved here) and the services."""

    def __init__(self, package: str, messages, services=(), serialized_pb: bytes = b""):
        #: the ``FileDescriptorProto`` bytes protoc writes for this schema
        self.serialized_pb = serialized_pb
        self.message_types_by_name = {m.DESCRIPTOR.name: m.DESCRIPTOR for m in messages}
        for desc in self.message_types_by_name.values():
            for f in desc.fields:
                if f.type == MESSAGE:
                    f.message_type = self.message_types_by_name[f.message_type_name]
        self.services_by_name = {}
        for name, methods in services:
            self.services_by_name[name] = ServiceDescriptor(
                f"{package}.{name}",
                [
                    MethodDescriptor(
                        m, self.message_types_by_name[req],
                        self.message_types_by_name[resp],
                        client_streaming=cs, server_streaming=ss,
                    )
                    for m, req, resp, cs, ss in methods
                ],
            )


# ---- repeated containers -----------------------------------------------


class RepeatedScalarContainer(list):
    """A repeated scalar field: a plain list."""

    __slots__ = ()


class RepeatedCompositeContainer(list):
    """A repeated message field. ``add(**kw)`` appends a new element and
    returns it (later writes to it are writes to the held element);
    ``append`` and ``extend`` append copies, as protobuf does."""

    __slots__ = ("_type",)

    def __init__(self, msg_type):
        super().__init__()
        self._type = msg_type

    def add(self, **kw):
        m = self._type(**kw)
        list.append(self, m)
        return m

    def append(self, msg) -> None:
        list.append(self, msg._copy())

    def extend(self, msgs) -> None:
        list.extend(self, [m._copy() for m in msgs])


# ---- messages ----------------------------------------------------------


class _MessageMeta(type):
    """Builds a message class from its ``FIELDS`` table: scalar defaults
    as class attributes, the :class:`Descriptor`, the field order the
    encoder walks."""

    def __new__(mcls, name, bases, ns):
        table = ns.pop("FIELDS", None)
        if table is None:
            return super().__new__(mcls, name, bases, ns)
        fields = tuple(FieldDescriptor(*row) for row in table)
        lazy = {}
        for f in fields:
            if f.is_repeated or f.type == MESSAGE:
                lazy[f.name] = f
            else:
                ns[f.name] = f.default
        ns["_LAZY"] = lazy
        ns["_ORDER"] = tuple(sorted(fields, key=lambda f: f.number))
        cls = super().__new__(mcls, name, bases, ns)
        cls.DESCRIPTOR = Descriptor(name, fields, cls)
        return cls


class Message(metaclass=_MessageMeta):
    """Base of the port's wire messages (see the module docstring)."""

    #: names of singular nested-message fields set explicitly (presence)
    _has = None

    def __init__(self, **kw):
        if not kw:
            return
        fields = self.DESCRIPTOR.fields_by_name
        for key, value in kw.items():
            f = fields.get(key)
            if f is None:
                raise ValueError(
                    f'Protocol message {type(self).__name__} has no "{key}" field.'
                )
            if value is None:
                continue
            if f.is_repeated:
                getattr(self, key).extend(value)
            elif f.type == MESSAGE:
                sub = getattr(self, key)
                sub.CopyFrom(value)
                self._mark(key)
            else:
                self.__dict__[key] = value

    def __getattr__(self, name: str):
        # only reached for repeated and nested-message fields not yet
        # touched: build the container or the default sub-message
        f = self._LAZY.get(name)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__!r} message has no field {name!r}"
            )
        if f.is_repeated:
            if f.type == MESSAGE:
                value = RepeatedCompositeContainer(f.message_type._concrete_class)
            else:
                value = RepeatedScalarContainer()
        else:
            value = f.message_type._concrete_class()
        self.__dict__[name] = value
        return value

    def __setattr__(self, name: str, value) -> None:
        if name in self._LAZY:
            raise AttributeError(
                f'Assignment not allowed to field "{name}" in protocol message object.'
            )
        self.__dict__[name] = value

    def _mark(self, name: str) -> None:
        has = self.__dict__.get("_has")
        if has is None:
            self.__dict__["_has"] = {name}
        else:
            has.add(name)

    def _present(self, name: str) -> bool:
        sub = self.__dict__.get(name)
        if sub is None:
            return False
        has = self.__dict__.get("_has")
        return (has is not None and name in has) or bool(sub._encode())

    def _set_fields(self) -> list:
        """(descriptor, value) of every field that would be written."""
        out = []
        for f in self._ORDER:
            if f.type == MESSAGE and not f.is_repeated:
                if self._present(f.name):
                    out.append((f, self.__dict__[f.name]))
                continue
            v = getattr(self, f.name)
            if f.is_repeated:
                if v:
                    out.append((f, v))
            elif f.type == DOUBLE:
                if _pack_d(v) != _ZERO8:
                    out.append((f, v))
            elif v:
                out.append((f, v))
        return out

    # -- the generated API's slice --

    def CopyFrom(self, other: "Message") -> None:
        if other is self:
            return
        if type(other) is not type(self):
            raise TypeError(
                f"CopyFrom: expected {type(self).__name__}, got {type(other).__name__}"
            )
        self.__dict__.clear()
        self.__dict__.update(other._copy().__dict__)

    def HasField(self, name: str) -> bool:
        """Whether a singular nested-message field is present; like
        protobuf, a ValueError for any other (proto3 scalar) field."""
        f = self.DESCRIPTOR.fields_by_name.get(name)
        if f is None or f.type != MESSAGE or f.is_repeated:
            raise ValueError(
                f'Protocol message {type(self).__name__} has no non-repeated '
                f'submessage field "{name}" nor marked as optional'
            )
        return self._present(name)

    def SerializeToString(self, deterministic: bool = False) -> bytes:
        # the port writes no maps, so every serialization is deterministic
        return self._encode()

    @classmethod
    def FromString(cls, data):
        m = cls()
        data = bytes(data)
        m._merge(data, 0, len(data))
        return m

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return self._set_fields() == other._set_fields()

    __hash__ = None

    def __repr__(self) -> str:
        body = ", ".join(f"{f.name}={v!r}" for f, v in self._set_fields())
        return f"{type(self).__name__}({body})"

    # -- internals --

    def _copy(self):
        new = object.__new__(type(self))
        d = new.__dict__
        for k, v in self.__dict__.items():
            if isinstance(v, Message):
                d[k] = v._copy()
            elif type(v) is RepeatedCompositeContainer:
                c = RepeatedCompositeContainer(v._type)
                list.extend(c, [m._copy() for m in v])
                d[k] = c
            elif type(v) is RepeatedScalarContainer:
                d[k] = RepeatedScalarContainer(v)
            elif k == "_has":
                d[k] = set(v)
            else:
                d[k] = v
        return new

    def _encode(self) -> bytes:
        out = bytearray()
        d = self.__dict__
        for f in self._ORDER:
            if f.name not in d:
                continue  # never set: the default, which proto3 omits
            v = d[f.name]
            t = f.type
            if f.is_repeated:
                if not v:
                    continue
                if t == STRING:
                    for s in v:
                        b = s.encode("utf-8")
                        out += f.tag
                        out += _varint(len(b))
                        out += b
                elif t == MESSAGE:
                    for m in v:
                        b = m._encode()
                        out += f.tag
                        out += _varint(len(b))
                        out += b
                elif t == BYTES:
                    for b in v:
                        out += f.tag
                        out += _varint(len(b))
                        out += b
                else:
                    if t == DOUBLE:
                        payload = b"".join(_pack_d(x) for x in v)
                    elif t == BOOL:
                        payload = b"".join(b"\x01" if x else b"\x00" for x in v)
                    else:
                        payload = b"".join(_varint(int(x)) for x in v)
                    out += f.packed_tag
                    out += _varint(len(payload))
                    out += payload
                continue
            if t == STRING:
                if v:
                    b = v.encode("utf-8")
                    out += f.tag
                    out += _varint(len(b))
                    out += b
            elif t == INT64 or t == INT32 or t == ENUM:
                if v:
                    out += f.tag
                    out += _varint(int(v))
            elif t == BOOL:
                if v:
                    out += f.tag
                    out += b"\x01"
            elif t == DOUBLE:
                b = _pack_d(v)
                if b != _ZERO8:
                    out += f.tag
                    out += b
            elif t == BYTES:
                if v:
                    out += f.tag
                    out += _varint(len(v))
                    out += v
            else:  # a singular nested message
                has = d.get("_has")
                b = v._encode()
                if b or (has is not None and f.name in has):
                    out += f.tag
                    out += _varint(len(b))
                    out += b
        return bytes(out)

    def _merge(self, data: bytes, pos: int, end: int) -> None:
        by_number = self.DESCRIPTOR.fields_by_number
        d = self.__dict__
        while pos < end:
            tag = data[pos]
            if tag < 0x80:
                pos += 1
            else:
                tag, pos = _read_varint(data, pos, end)
            fno = tag >> 3
            wt = tag & 7
            if fno == 0:
                raise DecodeError("field number 0")
            f = by_number.get(fno)
            if f is None or (wt != _WIRE_OF_TYPE[f.type]
                             and not (f.is_repeated and wt == _LEN)):
                pos = _skip(data, pos, end, wt, fno)
                continue
            t = f.type
            if wt == _VARINT:
                v, pos = _read_varint(data, pos, end)
                if t == INT64:
                    v = _signed64(v)
                elif t == BOOL:
                    v = v != 0
                else:  # INT32, ENUM
                    v = _signed32(v)
                if f.is_repeated:
                    getattr(self, f.name).append(v)
                else:
                    d[f.name] = v
            elif wt == _I64:
                if pos + 8 > end:
                    raise DecodeError("truncated fixed64")
                v = _unpack_d(data, pos)[0]
                pos += 8
                if f.is_repeated:
                    getattr(self, f.name).append(v)
                else:
                    d[f.name] = v
            else:  # length-delimited
                n = data[pos] if pos < end else 0x80
                if n < 0x80:
                    pos += 1
                else:
                    n, pos = _read_varint(data, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError("length-delimited field overruns its message")
                if t == STRING:
                    try:
                        v = data[pos:stop].decode("utf-8")
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"invalid UTF-8 in string field: {e}") from None
                elif t == BYTES:
                    v = data[pos:stop]
                elif t == MESSAGE:
                    if f.is_repeated:
                        v = f.message_type._concrete_class()
                        v._merge(data, pos, stop)
                        list.append(getattr(self, f.name), v)
                    else:
                        getattr(self, f.name)._merge(data, pos, stop)
                        self._mark(f.name)
                    pos = stop
                    continue
                else:  # a packed run of numbers
                    _unpack_into(getattr(self, f.name), t, data, pos, stop)
                    pos = stop
                    continue
                pos = stop
                if f.is_repeated:
                    getattr(self, f.name).append(v)
                else:
                    d[f.name] = v


def _unpack_into(out: list, t: int, data: bytes, pos: int, end: int) -> None:
    if t == DOUBLE:
        if (end - pos) % 8:
            raise DecodeError("packed doubles of a length not a multiple of 8")
        out.extend(struct.unpack_from(f"<{(end - pos) // 8}d", data, pos))
        return
    while pos < end:
        v, pos = _read_varint(data, pos, end)
        if t == INT64:
            v = _signed64(v)
        elif t == BOOL:
            v = v != 0
        else:
            v = _signed32(v)
        out.append(v)


_START_GROUP, _END_GROUP = 3, 4


def _skip(data: bytes, pos: int, end: int, wt: int, fno: int = 0) -> int:
    """Skip one unknown field's value (a group up to its end tag)."""
    if wt == _VARINT:
        _, pos = _read_varint(data, pos, end)
    elif wt == _I64:
        pos += 8
    elif wt == _LEN:
        n, pos = _read_varint(data, pos, end)
        pos += n
    elif wt == _I32:
        pos += 4
    elif wt == _START_GROUP:
        while True:
            tag, pos = _read_varint(data, pos, end)
            if tag & 7 == _END_GROUP:
                if tag >> 3 != fno:
                    raise DecodeError("mismatched end-group tag")
                break
            pos = _skip(data, pos, end, tag & 7, tag >> 3)
    else:
        raise DecodeError(f"unexpected wire type {wt}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos

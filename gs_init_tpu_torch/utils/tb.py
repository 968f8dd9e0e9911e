"""TensorBoard scalar event files, written and read without tensorboard.

The writer produces what ``tensorboardX.SummaryWriter.add_scalar`` does:
an ``events.out.tfevents.*`` file of TFRecords (a little-endian uint64
length, its masked CRC32C, the payload, its masked CRC32C), the first
record an ``Event{wall_time, file_version: "brain.Event:2"}``, then one
``Event{wall_time, step, summary{value{tag, simple_value}}}`` per scalar,
the protobuf encoded by hand. TensorBoard's ``EventAccumulator`` reads
these files, and ``read_scalars`` reads them and tensorboardX's.
"""
from __future__ import annotations

import glob
import os
import socket
import struct
import time
from typing import Dict, List, Tuple


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64 as its two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    key = _varint((number << 3) | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def _event(wall_time: float, step: int = 0, file_version: str = "", tag: str = "", value: float = 0.0) -> bytes:
    out = _field(1, 1, struct.pack("<d", wall_time))
    if step:
        out += _field(2, 0, _varint(step))
    if file_version:
        return out + _field(3, 2, file_version.encode())
    val = _field(1, 2, tag.encode()) + _field(2, 5, struct.pack("<f", value))
    return out + _field(5, 2, _field(1, 2, val))


def _record(data: bytes) -> bytes:
    n = struct.pack("<Q", len(data))
    return n + struct.pack("<I", _masked_crc(n)) + data + struct.pack("<I", _masked_crc(data))


class SummaryWriter:
    """Scalars into ``<logdir>/events.out.tfevents.<time>.<host>.<pid>``;
    every record is flushed as it is written, so a reader sees it at once."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{int(now)}.{socket.gethostname()}.{os.getpid()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(_event(now, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(_record(event))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), int(step), tag=tag, value=float(value)))

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------------ reader


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: ints for
    varints, bytes for everything else."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + n], pos + n
        elif wire == 5:
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, wire, val


def read_records(path: str) -> List[bytes]:
    """The payloads of a TFRecord file; raises ValueError on a bad CRC.
    A record cut short at the end (a writer still running) is left out."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos + 12 <= len(data):
        head = data[pos : pos + 8]
        (n,) = struct.unpack("<Q", head)
        if struct.unpack("<I", data[pos + 8 : pos + 12])[0] != _masked_crc(head):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        if pos + 16 + n > len(data):
            break
        body = data[pos + 12 : pos + 12 + n]
        if struct.unpack("<I", data[pos + 12 + n : pos + 16 + n])[0] != _masked_crc(body):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        out.append(body)
        pos += 16 + n
    return out


def read_scalars(logdir: str) -> Dict[str, List[Tuple[int, float]]]:
    """{tag: [(step, value), ...]} over every event file in ``logdir``, in
    file-name order and then write order (as EventAccumulator orders them).
    Only ``simple_value`` scalars are read."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for path in sorted(glob.glob(os.path.join(logdir, "*tfevents*"))):
        for rec in read_records(path):
            step, summary = 0, None
            for num, wire, val in _fields(rec):
                if num == 2 and wire == 0:
                    step = val - (1 << 64) if val >> 63 else val
                elif num == 5 and wire == 2:
                    summary = val
            if summary is None:
                continue
            for num, wire, value in _fields(summary):
                if num != 1 or wire != 2:
                    continue
                tag, simple = None, None
                for vn, vw, vv in _fields(value):
                    if vn == 1 and vw == 2:
                        tag = vv.decode()
                    elif vn == 2 and vw == 5:
                        simple = struct.unpack("<f", vv)[0]
                if tag is not None and simple is not None:
                    out.setdefault(tag, []).append((step, float(simple)))
    return out

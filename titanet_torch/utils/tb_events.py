"""Pure-Python TensorBoard event-file writer (and verifying reader); the
port's own copy of ``titanet_tpu/utils/tb_events.py``, byte-compatible with
it.

A third observability sink beyond the reference's W&B + console
(SURVEY.md §2.1 #16, the reference's ``src/utils.py:406-418``): unlike
the W&B adapter — which needs a live server — TensorBoard's on-disk format is fully
local, so scalars/images logged here are verifiable end-to-end in-repo
and viewable by any stock TensorBoard later.

No tensorflow/tensorboard dependency: the two wire formats involved are
small and stable, so they are encoded by hand —

- **TFRecord framing**: ``uint64le length | masked crc32c(length bytes)
  | payload | masked crc32c(payload)`` with the Castagnoli polynomial
  and TF's rotate+offset masking.
- **tf.Event protobuf** (tensorflow/core/util/event.proto): fields
  wall_time=1 (double), step=2 (int64), file_version=3 (string),
  summary=5 (message). Summary.value=1 (repeated Value); Value.tag=1,
  simple_value=2 (float), image=4 (Summary.Image: height=1, width=2,
  colorspace=3, encoded_image_string=4).

``read_events`` decodes the same subset (verifying both CRCs), which is
what the tests round-trip through.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, + TFRecord masking


def _make_crc32c_table():
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding (write side)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _f_varint(field: int, value: int) -> bytes:
    if value < 0:  # int64 negatives encode as 10-byte two's complement
        value += 1 << 64
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_str(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


def _summary_scalar(tag: str, value: float) -> bytes:
    v = _f_str(1, tag) + _f_float(2, float(value))
    return _f_bytes(1, v)  # Summary.value (repeated)


def _summary_image(tag: str, png: bytes, height: int, width: int,
                   colorspace: int = 4) -> bytes:
    img = (_f_varint(1, height) + _f_varint(2, width)
           + _f_varint(3, colorspace) + _f_bytes(4, png))
    v = _f_str(1, tag) + _f_bytes(4, img)  # Value.image = 4
    return _f_bytes(1, v)


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary_values: bytes = b"") -> bytes:
    out = _f_double(1, wall_time)
    if step is not None:
        out += _f_varint(2, int(step))
    if file_version is not None:
        out += _f_str(3, file_version)
    if summary_values:
        out += _f_bytes(5, summary_values)  # Event.summary
    return out


def png_dimensions(png: bytes) -> tuple:
    """(height, width) from a PNG's IHDR chunk (bytes 16..24, big-endian
    width then height)."""
    if len(png) < 24 or png[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    width, height = struct.unpack(">II", png[16:24])
    return height, width


class EventFileWriter:
    """Append tf.Events to ``<logdir>/events.out.tfevents.<ts>.<host>``.

    Usage mirrors the TB summary API subset the train loop needs:
    ``add_scalar(tag, value, step)``, ``add_image(tag, png_path, step)``.
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "localhost"
        # pid uniquifier (like real TB writers): two writers created in the
        # same second for the same logdir must not interleave one file.
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}"
            f".{os.getpid()}{filename_suffix}"
        )
        self._f = open(self.path, "ab")
        # every event file starts with a version record
        self._write_record(_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int = 0,
                   wall_time: Optional[float] = None):
        self._write_record(_event(
            wall_time if wall_time is not None else time.time(),
            step=step, summary_values=_summary_scalar(tag, value),
        ))

    def add_scalars(self, metrics: Dict[str, float], step: int = 0):
        def _as_float(v):
            # hasattr(v, "__float__") alone passes multi-element ndarrays,
            # whose float() raises and would abort the whole record
            try:
                return float(v)
            except (TypeError, ValueError):
                return None

        scalars = [(tag, _as_float(v)) for tag, v in metrics.items()]
        values = b"".join(
            _summary_scalar(tag, v) for tag, v in scalars if v is not None
        )
        if values:
            self._write_record(_event(time.time(), step=step,
                                      summary_values=values))

    def add_image(self, tag: str, png_path: str, step: int = 0):
        with open(png_path, "rb") as f:
            png = f.read()
        h, w = png_dimensions(png)
        self._write_record(_event(time.time(), step=step,
                                  summary_values=_summary_image(tag, png, h, w)))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ---------------------------------------------------------------------------
# Reader (decode the same subset; used by tests and post-hoc analysis)


def _iter_fields(buf: bytes) -> Iterator[tuple]:
    """Yield (field, wire, value) triples from one message's bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            value, i = buf[i:i + ln], i + ln
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:  # groups (3/4) never appear in these messages
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _read_varint(buf: bytes, i: int):
    shift, out = 0, 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def read_events(path: str, verify_crc: bool = True) -> List[Dict]:
    """Decode an event file into dicts:
    ``{wall_time, step, file_version?, scalars: {tag: value},
    images: {tag: (height, width, nbytes)}}``."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        (length,) = struct.unpack("<Q", data[i:i + 8])
        if verify_crc:
            (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
            if hcrc != _masked_crc(data[i:i + 8]):
                raise ValueError(f"length CRC mismatch at offset {i}")
        payload = data[i + 12:i + 12 + length]
        if verify_crc:
            (pcrc,) = struct.unpack(
                "<I", data[i + 12 + length:i + 16 + length])
            if pcrc != _masked_crc(payload):
                raise ValueError(f"payload CRC mismatch at offset {i}")
        i += 16 + length

        ev: Dict = {"step": 0, "scalars": {}, "images": {}}
        for field, wire, value in _iter_fields(payload):
            if field == 1 and wire == 1:
                ev["wall_time"] = struct.unpack("<d", value)[0]
            elif field == 2 and wire == 0:
                step = value if value < 1 << 63 else value - (1 << 64)
                ev["step"] = step
            elif field == 3 and wire == 2:
                ev["file_version"] = value.decode("utf-8")
            elif field == 5 and wire == 2:
                _decode_summary(value, ev)
        out.append(ev)
    return out


def _decode_summary(buf: bytes, ev: Dict):
    for field, wire, value in _iter_fields(buf):
        if field != 1 or wire != 2:
            continue
        tag, scalar, image = None, None, None
        for f2, w2, v2 in _iter_fields(value):
            if f2 == 1 and w2 == 2:
                tag = v2.decode("utf-8")
            elif f2 == 2 and w2 == 5:
                scalar = struct.unpack("<f", v2)[0]
            elif f2 == 4 and w2 == 2:
                h = w = nbytes = 0
                for f3, w3, v3 in _iter_fields(v2):
                    if f3 == 1:
                        h = v3
                    elif f3 == 2:
                        w = v3
                    elif f3 == 4:
                        nbytes = len(v3)
                image = (h, w, nbytes)
        if tag is not None and scalar is not None:
            ev["scalars"][tag] = scalar
        if tag is not None and image is not None:
            ev["images"][tag] = image

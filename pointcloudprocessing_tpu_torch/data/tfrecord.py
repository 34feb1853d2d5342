"""TFRecord + tf.train.Example codec with no TensorFlow (numpy only).

The port's copy of ``pointcloudprocessing_tpu/data/tfrecord.py``: the same
bytes as the JAX package writes and reads, so datasets built by either
package load in the other.

Wire format notes:
- TFRecord frame: u64-LE length, u32 masked-crc32c(length bytes), payload,
  u32 masked-crc32c(payload); masked = rotr15(crc) + 0xa282ead8.
- Example proto: Example{features=1} -> Features{map<string,Feature>=1} ->
  Feature{bytes_list=1|float_list=2|int64_list=3}, FloatList/Int64List value
  field 1 (packed). The decoder accepts both packed and unpacked encodings.

The C++ helpers (``utils/native.py``) provide CRC32C and the encoder; this
module works without them at reduced ingest speed.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from pointcloudprocessing_tpu_torch.utils.native import crc32c as _crc32c

# copied from pointcloudprocessing_tpu/data/tfrecord.py::_MASK_DELTA
_MASK_DELTA = 0xA282EAD8


# copied from pointcloudprocessing_tpu/data/tfrecord.py::masked_crc32c
def masked_crc32c(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf primitives
# ---------------------------------------------------------------------------

# copied from pointcloudprocessing_tpu/data/tfrecord.py::_varint
def _varint(value: int) -> bytes:
    out = bytearray()
    value &= 0xFFFFFFFFFFFFFFFF  # two's complement for negatives
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_read_varint
def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_tag
def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_len_delimited
def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_float_list
def _float_list(values: np.ndarray) -> bytes:
    raw = np.ascontiguousarray(values, dtype="<f4").tobytes()
    return _len_delimited(1, raw)  # FloatList.value packed


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_int64_list
def _int64_list(values) -> bytes:
    arr = np.atleast_1d(np.asarray(values, dtype=np.int64))
    if arr.size and 0 <= arr.min() and arr.max() < 128:
        # fast path: every varint is one byte
        raw = arr.astype(np.uint8).tobytes()
    else:
        raw = b"".join(_varint(int(v)) for v in arr)
    return _len_delimited(1, raw)


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_feature
def _feature(payload: bytes, kind_field: int) -> bytes:
    # Feature{ float_list=2 | int64_list=3 }
    return _len_delimited(kind_field, payload)


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_map_entry
def _map_entry(key: str, feature: bytes) -> bytes:
    entry = _len_delimited(1, key.encode()) + _len_delimited(2, feature)
    return _len_delimited(1, entry)  # Features.feature map entry


# copied from pointcloudprocessing_tpu/data/tfrecord.py::encode_example
def encode_example(
    observations: np.ndarray,
    class_label: int,
    part_labels: np.ndarray,
    se3: np.ndarray,
) -> bytes:
    """Serialize one sample; same feature names/shapes as the reference
    (PointCloudSet._serialize_sample, :306-323). The C++ encoder is
    byte-identical and ~10x faster (pinned by test_tfrecord); the pure-
    Python body below is the contract and the fallback."""
    from pointcloudprocessing_tpu_torch.utils.native import encode_example_native

    native = encode_example_native(observations, class_label, part_labels, se3)
    if native is not None:
        return native
    features = b"".join(
        [
            _map_entry("observations", _feature(_float_list(observations.ravel()), 2)),
            _map_entry("class_label", _feature(_int64_list(int(class_label)), 3)),
            _map_entry("part_labels", _feature(_int64_list(part_labels.ravel()), 3)),
            _map_entry("se3", _feature(_float_list(se3.ravel()), 2)),
        ]
    )
    return _len_delimited(1, features)  # Example.features


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_decode_scalar_list
def _decode_scalar_list(buf: bytes, is_float: bool):
    """Decode a FloatList/Int64List message body (field 1, packed or not)."""
    pos = 0
    floats: list[bytes] = []
    ints: list[int] = []
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1:
            # skip unknown field
            if wire == 0:
                _, pos = _read_varint(buf, pos)
            elif wire == 2:
                ln, pos = _read_varint(buf, pos)
                pos += ln
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            continue
        if is_float:
            if wire == 2:  # packed
                ln, pos = _read_varint(buf, pos)
                floats.append(buf[pos : pos + ln])
                pos += ln
            else:  # wire 5, single fixed32
                floats.append(buf[pos : pos + 4])
                pos += 4
        else:
            if wire == 2:  # packed varints
                ln, pos = _read_varint(buf, pos)
                end = pos + ln
                chunk = np.frombuffer(buf[pos:end], dtype=np.uint8)
                if chunk.size and not (chunk & 0x80).any():
                    # fast path: every varint is a single byte (labels < 128)
                    ints.extend(chunk.tolist())
                    pos = end
                else:
                    while pos < end:
                        v, pos = _read_varint(buf, pos)
                        ints.append(v)
            else:
                v, pos = _read_varint(buf, pos)
                ints.append(v)
    if is_float:
        return np.frombuffer(b"".join(floats), dtype="<f4")
    arr = np.array(ints, dtype=np.uint64).astype(np.int64)  # two's complement
    return arr


# copied from pointcloudprocessing_tpu/data/tfrecord.py::_skip_field
def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"Unsupported wire type {wire}")
    return pos


# copied from pointcloudprocessing_tpu/data/tfrecord.py::decode_example
def decode_example(buf: bytes) -> dict[str, np.ndarray]:
    """Parse a serialized tf.train.Example into {name: array} (float32 for
    float lists, int64 for int64 lists)."""
    out: dict[str, np.ndarray] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1 or wire != 2:  # not Example.features
            pos = _skip_field(buf, pos, wire)
            continue
        ln, pos = _read_varint(buf, pos)
        features = buf[pos : pos + ln]
        pos += ln

        fpos = 0
        while fpos < len(features):
            ftag, fpos = _read_varint(features, fpos)
            ffield, fwire = ftag >> 3, ftag & 7
            if ffield != 1 or fwire != 2:
                fpos = _skip_field(features, fpos, fwire)
                continue
            fln, fpos = _read_varint(features, fpos)
            entry = features[fpos : fpos + fln]
            fpos += fln

            key = None
            value = None
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                efield, ewire = etag >> 3, etag & 7
                eln, epos = _read_varint(entry, epos)
                body = entry[epos : epos + eln]
                epos += eln
                if efield == 1:
                    key = body.decode()
                elif efield == 2:
                    value = body
            if key is None or value is None:
                continue

            # value is a Feature message: float_list=2, int64_list=3, bytes_list=1
            vpos = 0
            while vpos < len(value):
                vtag, vpos = _read_varint(value, vpos)
                vfield, vwire = vtag >> 3, vtag & 7
                vln, vpos = _read_varint(value, vpos)
                body = value[vpos : vpos + vln]
                vpos += vln
                if vfield == 2:
                    out[key] = _decode_scalar_list(body, is_float=True)
                elif vfield == 3:
                    out[key] = _decode_scalar_list(body, is_float=False)
                elif vfield == 1:
                    out[key] = np.frombuffer(body, dtype=np.uint8)
    return out


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


# copied from pointcloudprocessing_tpu/data/tfrecord.py::frame_record
def frame_record(record: bytes) -> bytes:
    """Frame one serialized record into TFRecord wire bytes (u64 length +
    masked CRC of the length bytes + payload + masked CRC of the payload) —
    the exact byte stream TFRecordWriter.write emits."""
    length = struct.pack("<Q", len(record))
    return (
        length
        + struct.pack("<I", masked_crc32c(length))
        + record
        + struct.pack("<I", masked_crc32c(record))
    )


# copied from pointcloudprocessing_tpu/data/tfrecord.py::TFRecordWriter
class TFRecordWriter:
    """Drop-in analogue of tf.io.TFRecordWriter (context manager + write)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# copied from pointcloudprocessing_tpu/data/tfrecord.py::read_tfrecord_file
def read_tfrecord_file(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (len_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc32c(header) != len_crc:
                raise ValueError(f"{path}: corrupt record length CRC")
            data = f.read(length)
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc32c(data) != data_crc:
                raise ValueError(f"{path}: corrupt record data CRC")
            yield data

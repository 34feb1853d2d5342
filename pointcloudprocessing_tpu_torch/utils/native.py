"""Loader for the repo's C++ frame scanner (``native/pcp_native.cpp``).

The port's own copy of the frame-parsing part of
``pointcloudprocessing_tpu/utils/native.py``. The shared library is compiled
with g++ at first use into the port's git-ignored build directory
(``csrc/build/``), under a name keyed on a hash of the source, never into
the JAX package's library. Without a toolchain ``parse_aftr_frame_native``
returns None and the caller parses in Python (host-side parsing, which the
JAX package has too).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "pcp_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
if os.uname().machine in ("x86_64", "amd64"):
    _FLAGS.append("-msse4.2")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


# copied from pointcloudprocessing_tpu/utils/native.py::_try_load (frame
# parsing only; built into the port's build directory)
def _try_load() -> "ctypes.CDLL | None":
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed or not _SRC.exists():
            _build_failed = True
            return None
        digest = hashlib.sha256(
            _SRC.read_bytes() + " ".join(_FLAGS).encode()
        ).hexdigest()[:16]
        so = _BUILD_DIR / f"libpcp_native-{digest}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
            except (OSError, subprocess.SubprocessError):
                tmp.unlink(missing_ok=True)
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None
        lib.pcp_parse_aftr_frame.restype = ctypes.c_int64
        lib.pcp_parse_aftr_frame.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


# copied from pointcloudprocessing_tpu/utils/native.py::parse_aftr_frame_native
def parse_aftr_frame_native(
    text: bytes, class_vocab: list[str], part_vocab: list[str], max_points: int
):
    """C++ fast path for frame parsing; returns None if the native library is
    unavailable. See data.frames.parse_frame_text for the full contract."""
    lib = _try_load()
    if lib is None:
        return None

    xyz = np.empty((max_points, 3), dtype=np.float32)
    cls = np.empty(max_points, dtype=np.int32)
    part = np.empty(max_points, dtype=np.int32)
    valid = np.empty(max_points, dtype=np.uint8)
    had_unknown = ctypes.c_int32(0)
    non_finite = ctypes.c_int32(0)

    n = lib.pcp_parse_aftr_frame(
        text,
        len(text),
        "\n".join(class_vocab).encode(),
        "\n".join(part_vocab).encode(),
        max_points,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        part.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(had_unknown),
        ctypes.byref(non_finite),
    )
    if n < 0:
        raise ValueError("Malformed frame text")
    return (
        xyz[:n],
        cls[:n],
        part[:n],
        valid[:n].astype(bool),
        bool(had_unknown.value),
        int(non_finite.value),
    )

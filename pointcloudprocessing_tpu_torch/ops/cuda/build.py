"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``: no
PyTorch headers are compiled, so a build takes seconds. A library is built
at its first use in a process, into ``csrc/build/`` under a name keyed on a
hash of its source and flags, so a changed source is never served a stale
library. ``nvcc``'s output, including ``-Xptxas -v``'s register and
shared-memory report, is kept beside each library as ``<name>.log``.

Every wrapper under ``ops/cuda/`` launches through :func:`launch` and counts
its calls with :func:`count` in :data:`LAUNCHES`, which the acceptance
checks on the card read to prove that a kernel ran and not its plain
version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("voxel_reduce", "fps", "pooled_chain", "window_normals",
           "gather_maxmin", "knn_select", "sa_group_mlp")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of each library's entry points: {name: argtypes}
_ENTRY = {
    "voxel_reduce": {"pcp_sorted_segment_sum": [_P, _P, _P, _L, _L, _I, _I, _P],
                     "pcp_segment_sum": [_P, _P, _P, _P, _L, _L, _I, _I, _P],
                     "pcp_segment_clusters_a_wave": [_I]},
    "fps": {"pcp_fps": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
            "pcp_fps_large": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "pooled_chain": {
        "pcp_pooled_chain_forward":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "pcp_pooled_chain_backward":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "pcp_pooled_chain_forward_bf16":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "pcp_pooled_chain_backward_bf16":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "pcp_pooled_chain_forward_bf16_tma":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "pcp_pooled_chain_backward_bf16_tma":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "window_normals": {
        "pcp_window_moments": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]},
    "gather_maxmin": {
        "pcp_gather_maxmin": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
        "pcp_gather_maxmin_bf16": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
        "pcp_gather_maxmin_bf16_ring":
            [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "knn_select": {"pcp_knn_select": [_P, _P, _L, _I, _I, _I, _I, _P]},
    "sa_group_mlp": {"pcp_sa_group_mlp": [_P] * 21 + [_I] * 10 + [_F, _P]},
}
#: the library of each C entry point
_LIBRARY = {entry: name for name, entries in _ENTRY.items() for entry in entries}

#: the launch counters: one a wrapper and form, by the kernel's name in
#: ``chip_smoke.py``'s kernels JSON line
COUNTERS = ("sorted_segment_sum", "segment_reduce", "fps_with_points",
            "pooled_chain_forward", "pooled_chain_backward",
            "pooled_chain_forward_bf16", "pooled_chain_backward_bf16",
            "windowed_moment_sums", "gather_maxmin", "gather_maxmin_bf16",
            "knn_select", "sa_group_mlp")
#: wrapper calls that launched in this process, by counter: one a call,
#: whatever its plan launches (CPU calls and refusals count nothing)
LAUNCHES = dict.fromkeys(COUNTERS, 0)

_libs: dict[str, ctypes.CDLL] = {}
_locks = {name: threading.Lock() for name in KERNELS}  # one build per library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "pointcloudprocessing_tpu_torch are built from source at first use"
    )


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(name: str, so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = _library_path(name)
        if not so.exists():
            _compile(name, so)
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in _ENTRY[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pcp_error_string.argtypes = [ctypes.c_int]
        lib.pcp_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def build_all() -> None:
    """Load every kernel of the port, building each missing one: one
    ``nvcc`` per source, all started together."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        list(pool.map(load, KERNELS))


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.pcp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` with ``args`` and PyTorch's current
    stream of ``device``; raise if it returns a CUDA error."""
    lib = load(_LIBRARY[entry])
    with torch.cuda.device(device):
        code = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    check(lib, code, f"{entry} launch")


def _known(names) -> None:
    for name in names:
        if name not in LAUNCHES:
            raise KeyError(f"no launch counter {name!r}; the counters are {COUNTERS}")


def count(name: str) -> None:
    """Count a wrapper call that launched under counter ``name``."""
    _known((name,))
    LAUNCHES[name] += 1


def reset(*names: str) -> None:
    """Zero the named counters, every counter when none is named."""
    _known(names)
    for name in names or COUNTERS:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def sms(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count

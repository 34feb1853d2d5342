#!/usr/bin/env python3
"""Read what bounds kernel 7's bf16 ring form on the card: time variants of
``csrc/gather_maxmin.cu``'s ring kernel, each made from the checkout's own
source by one text substitution, on DGCNN's 64x1024 launches (k 20, w 64 /
128 / 256, the ``knn_graph`` of normal(0, 1) clouds), as ``gather_plan``
plans them:

- ``as built``: the kernel unchanged (checked bit-identical to the plain
  version);
- ``plain stores``: the outputs by plain stores, not streaming ones;
- ``no stores``: the outputs never stored (the gather alone);
- ``no index loads``: the neighbours' indices made by arithmetic instead
  of loaded (n a power of two; the shared kernel's too, untimed);
- ``no compare``: each row folded in by an xor and an add instead of the
  NaN-propagating bf16x2 max and min (the instructions' cost);
- ``8 a step``: at most eight neighbours a step (two index loads, eight
  row loads in flight) instead of sixteen;
- ``stamps``: the kernel unchanged but for %globaltimer stamps by each
  block's thread 0 (after its first copies are issued, after each tile's
  rows have landed, after each tile's gathers), printed as median and
  largest over blocks, microseconds from the first block's first stamp.

Only ``as built`` computes the function; the others are timings. Device
ms from a torch.profiler trace of 20 calls (``tools/gather_bench.py``'s
``device_ms``). Each variant is built with the port's nvcc flags into
``csrc/build/variants/``. Needs CUDA and nvcc; exits non-zero without them.

Usage: python tools/gather_variants.py [--variant NAME]...
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

STORES = ("__stcs(hi, make_uint4(mx[0], mx[1], mx[2], mx[3]));\n"
          "          __stcs(lo, make_uint4(mn[0], mn[1], mn[2], mn[3]));")
TAKE = "\n".join([f"    mx[{e}] = Word<T>::max(x.{c}, mx[{e}]);" for e, c in enumerate("xyzw")]
                 + [f"    mn[{e}] = Word<T>::min(x.{c}, mn[{e}]);" for e, c in enumerate("xyzw")])
SIXTEEN = "      for (; j + 16 <= k; j += 16) {"
IDX_LOAD = re.compile(r"\*reinterpret_cast<const int4\*>\(ir \+ (j(?: \+ \d+)?)\)")
FAKE_IDX = ("  const int m = static_cast<int>(rows) - 1;\n"
            "  const int seed = static_cast<int>(reinterpret_cast<uintptr_t>(ir) >> 2);\n"
            "  auto fake_idx = [&](int j) {\n"
            "    const int h = (seed * 97 + j * 389) & m;\n"
            "    return make_int4(h, (h + 31) & m, (h + 77) & m, (h + 511) & m);\n"
            "  };\n")
STAMP_DECL = "__device__ unsigned long long g_stamps[256 * 16];\n"
STAMP_EXPORT = """
extern "C" int pcp_stamps(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}
"""


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"gather_variants: the ring kernel no longer holds {old[:60]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    """Each variant's whole source: the ring kernel's text, or the
    per-point gather it calls (``neighbour_maxmin``), substituted."""
    at = src.index("gather_maxmin_ring_kernel(const __grid_constant__")
    end = src.index("using EncodeTiled")
    head, ring, tail = src[:at], src[at:end], src[end:]
    at = head.index("__device__ __forceinline__ void neighbour_maxmin(")
    end = head.index("// The shared form, S channels a slice.")
    pre, point, post = head[:at], head[at:end], head[end:]

    def in_ring(old, new):
        return pre + point + post + _sub(ring, old, new) + tail

    def in_point(old, new):
        return pre + _sub(point, old, new) + post + ring + tail

    out = {"as built": src,
           "plain stores": in_ring(STORES, STORES.replace("__stcs(hi, ", "*hi = (")
                                   .replace("__stcs(lo, ", "*lo = (")),
           "no stores": in_ring("      if (live && store) {",
                                "      if (live && store && mx[0] == 0x12345u && mn[1] == 0x54321u) {"),
           "no compare": in_point(TAKE, "\n".join(
               f"    mx[{e}] ^= x.{c};\n    mn[{e}] += x.{c};" for e, c in enumerate("xyzw"))),
           "8 a step": in_point(SIXTEEN, "      if (k < 0) for (; j + 16 <= k; j += 16) {")}
    fake = _sub(point, "  int j = 0;\n", FAKE_IDX + "  int j = 0;\n")
    fake, count = IDX_LOAD.subn(r"fake_idx(\1)", fake)
    if count < 7:
        raise SystemExit("gather_variants: the gather's index loads moved")
    out["no index loads"] = pre + fake + post + ring + tail
    stamps = _sub(ring, "  int j = 0;\n  for (long long t = blockIdx.x;",
                  "  int ns = 0;\n  auto stamp = [&]() {\n"
                  "    if (threadIdx.x == 0 && ns < 16) g_stamps[blockIdx.x * 16 + ns++] = global_ns();\n"
                  "  };\n  stamp();\n  int j = 0;\n  for (long long t = blockIdx.x;")
    stamps = _sub(stamps, "    mbar_wait(full + 8u * (j & 1), (j >> 1) & 1);\n",
                  "    mbar_wait(full + 8u * (j & 1), (j >> 1) & 1);\n    stamp();\n")
    stamps = _sub(stamps, "    if (t + stride < tiles) __syncthreads();",
                  "    __syncthreads();\n    stamp();\n    if (t + stride < tiles) __syncthreads();")
    stamp_head = _sub(head, "constexpr int kRingThreads", STAMP_DECL + "constexpr int kRingThreads")
    out["stamps"] = stamp_head + stamps + tail + STAMP_EXPORT
    return out


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from pointcloudprocessing_tpu_torch.ops.cuda import build as cuda_build

    folder = cuda_build.BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        stem = name.replace(" ", "_")
        cu, so = folder / f"{stem}.cu", folder / f"lib{stem}.so"
        cu.write_text(text)
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                               str(cu)], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"gather_variants: {name} did not build:\n{proc.stderr[-3000:]}")
        return name, ctypes.CDLL(str(so))

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = dict(pool.map(one, sources.items()))
    for lib in libs.values():
        fn = lib.pcp_gather_maxmin_bf16_ring
        fn.argtypes = cuda_build._ENTRY["gather_maxmin"]["pcp_gather_maxmin_bf16_ring"]
        fn.restype = ctypes.c_int
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", action="append", help="only these (repeatable)")
    args = parser.parse_args()
    import torch

    import gather_bench
    from pointcloudprocessing_tpu_torch.models.dgcnn import knn_graph
    from pointcloudprocessing_tpu_torch.ops.cuda import gather_maxmin as gm

    if not torch.cuda.is_available():
        raise SystemExit("gather_variants: needs CUDA")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with open(os.path.join(HERE, "pointcloudprocessing_tpu_torch", "csrc",
                           "gather_maxmin.cu")) as f:
        sources = variants(f.read())
    if args.variant:
        sources = {k: v for k, v in sources.items() if k in args.variant}
    libs = build(sources)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    n, k = 1024, 20
    pts = torch.from_numpy(rng.normal(size=(64, n, 3)).astype(np.float32)).to(dev)
    graph = knn_graph(pts, k)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for w in (64, 128, 256):
        q = torch.from_numpy(rng.normal(size=(64, n, w)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        qmax, qmin = torch.empty_like(q), torch.empty_like(q)
        (step,) = gm.gather_plan(64, n, w, 2, sms)
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib):
            code = lib.pcp_gather_maxmin_bf16_ring(
                q.data_ptr(), graph.data_ptr(), qmax.data_ptr(), qmin.data_ptr(), 64, n,
                w, k, 2 * step.slice, step.c_begin, step.slices, step.parts,
                step.blocks, stream)
            if code:
                raise SystemExit(f"gather_variants: launch failed ({code})")

        row = [f"64x{n}x{w} k{k} ({step.tiles(64)} tiles on {step.blocks} blocks)"]
        for name, lib in libs.items():
            if name == "as built":
                call(lib)
                want = gm.gather_maxmin_reference(q, graph)
                same = all(torch.equal(g, wt) for g, wt in zip((qmax, qmin), want))
                if not same:
                    raise SystemExit("gather_variants: the kernel as built differs "
                                     "from the plain version")
            ms = gather_bench.device_ms(torch, lambda lib=lib: call(lib))
            row.append(f"{name} " + ("not traced" if ms is None else f"{ms:.4f}"))
        print("; ".join(row) + " (device ms)", flush=True)
        if "stamps" in libs:
            lib = libs["stamps"]
            lib.pcp_stamps.argtypes = [ctypes.c_void_p]
            call(lib)
            torch.cuda.synchronize()
            buf = np.zeros(256 * 16, dtype=np.uint64)
            lib.pcp_stamps(buf.ctypes.data)
            got = buf.reshape(256, 16)[:step.blocks].astype(np.float64)
            cols = 1 + 2 * -(-step.tiles(64) // step.blocks)
            got = np.where(got[:, :cols] > 0, got[:, :cols], np.nan)
            rel = (got - np.nanmin(got[:, 0])) / 1e3
            print(f"  stamps 64x{n}x{w}, us (issued, then each tile's landed and "
                  "gathered): median "
                  + ", ".join(f"{v:.2f}" for v in np.nanmedian(rel, axis=0))
                  + "; largest " + ", ".join(f"{v:.2f}" for v in np.nanmax(rel, axis=0)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

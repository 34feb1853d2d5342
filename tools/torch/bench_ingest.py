"""Host ingest throughput with the PyTorch port: synthetic AftrBurner
collect -> TFRecord splits (twin of ``tools/bench_ingest.py``).

Measures the port's full ``PointCloudSet.add_from_aftr_output`` pass (file
read -> parse -> finite filter -> seeded resample -> Example encode ->
TFRecord framing -> split write) in Mpoints/s, with the native one-pass
C++ ingest on and off, in process CPU time, best of three. It works in a
temporary directory of its own and removes it at the end.

Usage: python tools/torch/bench_ingest.py [frames] [points_per_frame]
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

from helpers import CLASS_LABELS, PART_LABELS, make_collect  # noqa: E402

WIDTH = 8192


def run(collect: str, out: str, use_native: bool, width: int) -> float:
    """One ingest of ``collect`` into ``out`` (emptied first), native on or
    off; returns its process CPU seconds."""
    from pointcloudprocessing_tpu_torch.data import PointCloudSet
    from pointcloudprocessing_tpu_torch.data import pointcloudset as pcs_mod

    real = pcs_mod.native.native_available
    pcs_mod.native.native_available = (lambda: True) if use_native else (lambda: False)
    try:
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out, exist_ok=True)
        pc = PointCloudSet(
            name="bench",
            class_labels=CLASS_LABELS,
            part_labels=PART_LABELS,
            network_input_width=width,
            batch_size=8,
            rand_seed=1,
            print_func=lambda *a, **k: None,
            data_path=out + "/",
        )
        t0 = time.process_time()
        pc.add_from_aftr_output(collect)
        return time.process_time() - t0
    finally:
        pcs_mod.native.native_available = real


def main(argv=None) -> list[str]:
    argv = sys.argv[1:] if argv is None else argv
    frames = int(argv[0]) if len(argv) > 0 else 300
    ppf = int(argv[1]) if len(argv) > 1 else 8192
    root = tempfile.mkdtemp(prefix="pcp_ingest_bench_torch_")
    lines = []
    try:
        print(f"writing synthetic collect: {frames} frames x ~{ppf} pts ...")
        collect = make_collect(root, num_frames=frames, points_per_frame=ppf,
                               sorted_parts=True)
        total_pts = 0
        for i in range(frames):
            with open(f"{collect}/Lidar/frame_{i}.txt", "rb") as f:
                total_pts += sum(1 for _ in f)
        total_bytes = sum(os.path.getsize(f"{collect}/Lidar/frame_{i}.txt")
                          for i in range(frames))
        print(f"total: {total_pts/1e6:.2f} M pts, {total_bytes/1e6:.1f} MB text")

        # process CPU time, best of 3: wall time on a shared host is
        # dominated by scheduler noise
        for label, use_native in [("native", True), ("python", False)]:
            best = min(run(collect, os.path.join(root, "out_" + label), use_native,
                           WIDTH) for _ in range(3))
            lines.append(
                f"{label:>7}: {best:6.2f} s cpu  {total_pts/best/1e6:7.2f} Mpts/s/core  "
                f"{total_bytes/best/1e6:7.1f} MB/s")
            print(lines[-1])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return lines


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Count what the windowed moment-sum kernel's walks do, on the CPU.

The kernel (``pointcloudprocessing_tpu_torch/csrc/window_normals.cu``) runs a
query a thread, 32 consecutive queries a warp. Pass 1 walks the candidates
in groups of 16 from just before the warp's queries around the window, and
inserts a distance into a query's k smallest when it is below the k-th so
far; pass 2 walks in candidate order and sums the selected candidates. An
insertion or a sum runs for the whole warp when any lane needs it, and a
warp skips a group whose bounding box no query can use. This script replays
those walks in numpy for sampled warps of the normals path's inputs and
prints, per query: insertions and selections a query needs, how many
candidates trigger them for its warp, and the share of groups a warp walks
in each pass. The counts do not depend on the device; no time is measured.

Inputs: the Morton-ordered voxel output of the config-2 shape (8x8192
uniform(-30, 30) scans, voxel 0.5, W 256) and of the config-5 shape
(256x2048 uniform(-20, 20), voxel 0.4, W 128), k 16, from seed 0.

Usage: python tools/window_events.py [--warps N]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUP = 16  # candidates a bounding box covers
K = 16


def rounded_dm(q, p, valid):
    """(queries, candidates) squared distances rounded as the kernel rounds
    them, +inf at invalid candidates."""
    with np.errstate(over="ignore"):
        d = p[None] - q[:, None]
        sq = d * d
        dist = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    return np.where(valid[None], dist, np.float32(np.inf))


def box_bound(q, lo, hi):
    with np.errstate(over="ignore", invalid="ignore"):
        g = np.maximum(np.maximum(lo - q, q - hi), np.float32(0))
        sq = g * g
        return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def warp_walks(q, cand, valid, thr, start_group):
    """Pass 1 and pass 2 of one warp: (insertions, insertion triggers,
    groups walked in pass 1, selections, selection triggers, groups walked
    in pass 2)."""
    c = len(cand)
    g = cand.reshape(-1, GROUP, 3)
    v = valid.reshape(-1, GROUP)
    lo = np.where(v[..., None], g, np.float32(np.inf)).min(axis=1)
    hi = np.where(v[..., None], g, np.float32(-np.inf)).max(axis=1)
    groups = c // GROUP
    dm = rounded_dm(q, cand, valid)
    m = np.full(len(q), np.inf, np.float32)
    top = np.full((len(q), K), np.inf, np.float32)
    ins = ins_trig = walked1 = 0
    for gi in [(start_group + i) % groups for i in range(groups)]:
        lb = box_bound(q, lo[gi], hi[gi])
        if (lb >= np.maximum(m, top[:, -1])).all():
            continue
        walked1 += 1
        for j in range(gi * GROUP, gi * GROUP + GROUP):
            x = dm[:, j]
            m = np.where(x > 0, np.minimum(m, x), m)
            e = x < top[:, -1]
            ins += int(e.sum())
            ins_trig += bool(e.any())
            top[e, -1] = x[e]
            top.sort(axis=1)
    sel = sel_trig = walked2 = 0
    for gi in range(groups):
        lb = box_bound(q, lo[gi], hi[gi])
        if not (lb <= thr).any():
            continue
        walked2 += 1
        e = dm[:, gi * GROUP:(gi + 1) * GROUP] <= thr[:, None]
        sel += int(e.sum())
        sel_trig += int(e.any(axis=0).sum())
    return ins, ins_trig, walked1 / groups, sel, sel_trig, walked2 / groups


def main() -> int:
    import torch

    from pointcloudprocessing_tpu_torch.ops.cuda.window_normals import (
        order_threshold,
    )
    from pointcloudprocessing_tpu_torch.ops.normals import window_arguments
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--warps", type=int, default=64, help="warps sampled a shape")
    args = parser.parse_args()
    rng = np.random.default_rng(0)
    for label, b, n, scale, voxel, window in (
            ("config 2: 8x8192, voxel 0.5, W 256", 8, 8192, 30.0, 0.5, 256),
            ("config 5: 256x2048, voxel 0.4, W 128", 256, 2048, 20.0, 0.4, 128)):
        scans = rng.uniform(-scale, scale, (b, n, 3)).astype(np.float32)
        vox, mask = voxel_downsample_batch(torch.from_numpy(scans), voxel, layout="bcn")
        centered, mask, window, q_block = window_arguments(vox, mask, window)[1:]
        c = q_block + 2 * window
        pts = centered.numpy().transpose(0, 2, 1)
        valid = mask.numpy()
        picks = rng.choice(b * (n // 32), size=min(args.warps, b * (n // 32)),
                           replace=False)
        totals = np.zeros(6)
        for pick in picks:
            cloud, wq0 = divmod(int(pick) * 32, n)
            q0 = wq0 // q_block * q_block
            start = min(max(q0 - window, 0), n - c)
            cand, cvalid = pts[cloud, start:start + c], valid[cloud, start:start + c]
            q = pts[cloud, wq0:wq0 + 32]
            dm = torch.from_numpy(rounded_dm(q, cand, cvalid))
            m = torch.where(dm > 0, dm, torch.inf).amin(dim=1, keepdim=True)
            dk = dm.kthvalue(K, dim=1, keepdim=True).values
            thr = order_threshold(m, dk)[:, 0].numpy()  # the kernel's threshold
            from_ = max(wq0 - start - GROUP, 0)
            totals += warp_walks(q, cand, cvalid, thr, from_ // GROUP)
        w = len(picks)
        ins, trig1, walk1, sel_, trig2, walk2 = totals
        print(f"{label}, k {K}, C {c}, {w} warps: a query needs {ins / w / 32:.1f} "
              f"insertions and {sel_ / w / 32:.1f} selections; its warp runs "
              f"{trig1 / w:.1f} insertions and {trig2 / w:.1f} candidates' sums; "
              f"a warp walks {walk1 / w:.3f} of the groups in pass 1 and "
              f"{walk2 / w:.3f} in pass 2", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

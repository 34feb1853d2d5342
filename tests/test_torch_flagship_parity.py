"""The flagship recipe (``examples/flagship_smoke.py`` and its twin
``examples/torch/flagship_smoke.py``) in both packages on the CPU, at a
reduced width, on the same synthesized collects: the port's validation
accuracy per stage and epoch, and the classes its serving CLI predicts for
each collect, against the JAX package's.

The recipe's 4 x 64 frames are kept (11 steps an epoch at batch 16, 2 bf16
stages x 3 epochs); the width is cut from 8,192 to 1,024 points and the
sampled points from 4,096 to 512. Each package trains in its own process
on its own copy of the collects (ingest writes its cache beside them).
The port's process also reads its final stage's checkpoint over the
validation split with the running BatchNorm statistics (eval) and with the
batch's own (``train=True``), and prints the classes each predicts. Run
with ``-s`` to see the numbers. Slow lane: about three minutes.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRAMES, SAMPLE, WIDTH, EPOCHS, BATCH = 64, 512, 1024, 3, 16

# the port's synthesis of the collects (the twin of the JAX example's)
SYNTH = r"""
import os, sys
repo, data_dir, frames, sample, width = sys.argv[1:6]
sys.path[:0] = [os.path.join(repo, "examples", "torch")]
from make_class_test_data import synthesize_class_collects
synthesize_class_collects(data_dir, 4, frames_per_class=int(frames),
                          sample_points=int(sample), pad=int(width), device="cpu")
"""

RUN = r"""
import collections, json, os, sys
repo, pkg, data_dir, work, width, epochs, batch = sys.argv[1:8]
width, epochs, batch = int(width), int(epochs), int(batch)
sys.path[:0] = [repo, os.path.join(repo, "examples")]
from make_class_test_configs import build_config

collects = sorted(os.path.join(data_dir, d) for d in os.listdir(data_dir)
                  if d.startswith("collect_"))
os.makedirs(os.path.join(work, "models"), exist_ok=True)
cfg = build_config("four", 4)
for stage in cfg["info"]["training_profiles"].values():
    stage["datasets"] = {str(i): os.path.basename(c) for i, c in enumerate(collects)}
cfg["params"].update({
    "input_width": width, "epochs": epochs, "batch_size": batch,
    "compute_dtype": "bfloat16",
    "learning": {"rate": 1e-3, "decay_steps": 1000, "decay_rate": 0.9},
})
cfg["file_system"] = {"model_path": os.path.join(work, "models") + "/",
                      "input_path": data_dir + "/", "data_path": data_dir + "/"}
path = os.path.join(work, "bertha_four_class_config.json")
with open(path, "w") as f:
    json.dump(cfg, f)
if pkg == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pointcloudprocessing_tpu.serve import main as serve_main
    from pointcloudprocessing_tpu.train.profile import TrainProfile
    tp, extra = TrainProfile(path, log_to_file=False), []
else:
    from pointcloudprocessing_tpu_torch.serve import main as serve_main
    from pointcloudprocessing_tpu_torch.train import TrainProfile
    tp, extra = TrainProfile(path, log_to_file=False, device="cpu"), ["--device", "cpu"]
histories = tp.train()
key = "val_classification_output_sparse_categorical_accuracy"
out = {"val_acc": {s: [float(v) for v in h[key]] for s, h in histories.items()},
       "served": {}}
stage_dir = os.path.join(work, "models", cfg["info"]["name"], "four_class_seg")
for c in collects:
    preds = os.path.join(work, os.path.basename(c) + ".jsonl")
    serve_main(["--model", stage_dir, "--input", c, "--output", preds,
                "--batch", str(batch)] + extra)
    with open(preds) as f:
        classes = collections.Counter(json.loads(line)["class"] for line in f)
    out["served"][os.path.basename(c)] = dict(classes)
if pkg == "torch":
    import numpy as np
    import torch
    from pointcloudprocessing_tpu_torch.data import load_from_file
    from pointcloudprocessing_tpu_torch.models import PointNet
    from pointcloudprocessing_tpu_torch.train import load_checkpoint

    payload = load_checkpoint(stage_dir, "cpu")
    model = PointNet(payload["mlp_cls_3.dense.weight"].shape[0],
                     payload["mlp_seg_5.conv.weight"].shape[0], device="cpu")
    model.load_state_dict(payload)
    model.eval()
    pc = load_from_file(os.path.join(
        data_dir, cfg["info"]["name"] + "_four_class_seg", "pc_set.joblib"))
    arrays = pc.load_split_arrays("val")
    x = torch.from_numpy(np.asarray(arrays["observations"])).float()
    labels = np.asarray(arrays["class_label"])
    for train in (False, True):
        with torch.no_grad():
            pred = torch.cat([
                model(x[i:i + batch], train=train,
                      generator=torch.Generator().manual_seed(0))
                ["classification_output"].argmax(-1)
                for i in range(0, len(x), batch)]).numpy()
        out["batch statistics" if train else "running statistics"] = {
            "acc": float((pred == labels).mean()),
            "classes": dict(collections.Counter(int(p) for p in pred))}
print(json.dumps(out))
"""


@pytest.mark.slow
def test_flagship_recipe_matches_the_jax_package(tmp_path):
    data = {pkg: str(tmp_path / f"data_{pkg}") for pkg in ("jax", "torch")}
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", SYNTH, REPO, data["torch"], str(FRAMES),
                    str(SAMPLE), str(WIDTH)], check=True, env=env)
    for collect in os.listdir(data["torch"]):
        shutil.copytree(os.path.join(data["torch"], collect),
                        os.path.join(data["jax"], collect))
    logs = {pkg: (tmp_path / f"{pkg}.out", tmp_path / f"{pkg}.err")
            for pkg in ("jax", "torch")}
    procs = {}
    for pkg, (out, err) in logs.items():  # both at once, each logging to files
        with open(out, "w") as stdout, open(err, "w") as stderr:
            procs[pkg] = subprocess.Popen(
                [sys.executable, "-c", RUN, REPO, pkg, data[pkg],
                 str(tmp_path / f"work_{pkg}"), str(WIDTH), str(EPOCHS), str(BATCH)],
                stdout=stdout, stderr=stderr, text=True, env=env)
    got = {}
    for pkg, proc in procs.items():
        proc.wait(timeout=1500)
        out, err = (path.read_text() for path in logs[pkg])
        assert proc.returncode == 0, err[-3000:]
        got[pkg] = json.loads(out.strip().splitlines()[-1])
        print(pkg, json.dumps(got[pkg]))
    jax_run, port = got["jax"], got["torch"]
    assert port["val_acc"].keys() == jax_run["val_acc"].keys()
    for stage, accs in port["val_acc"].items():
        assert len(accs) == EPOCHS
        # within two frames of the 32 the history's validation counts
        assert all(abs(a - b) <= 2 / 32 for a, b in zip(accs, jax_run["val_acc"][stage])), (
            stage, accs, jax_run["val_acc"][stage])
    for collect, classes in port["served"].items():
        assert set(classes) == set(jax_run["served"][collect]), (
            collect, classes, jax_run["served"][collect])

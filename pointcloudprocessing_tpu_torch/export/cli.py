"""Export CLI: a trained stage checkpoint -> ONNX and ``.pt2`` artifacts
(``pointcloudprocessing_tpu/export/cli.py``).

The trainer exports at the end of every stage; this exports any
saved stage after the fact:

    python -m pointcloudprocessing_tpu_torch.export.cli \\
        <stage_dir> <config.json> out.onnx [out.pt2] [--device cuda|cpu]

``stage_dir`` is a stage directory holding ``best/model.pt`` (the trainer's
checkpoint) and ``config.json`` the run's config (the stage dir's own copy
works). ONNX comes from the native opset-13 writer (export/onnx_native.py);
the ``.pt2`` program (export/pt2.py) is traced from a CPU copy of the model
and moved to ``--device`` (default cuda; without CUDA it raises).
"""

from __future__ import annotations

import sys


def main(argv: list[str]) -> int:
    device = "cuda"
    if "--device" in argv:
        at = argv.index("--device")
        device = argv[at + 1]
        argv = argv[:at] + argv[at + 2:]
    if len(argv) < 3:
        print(__doc__)
        return 1
    stage_dir, config_path, onnx_path = argv[0], argv[1], argv[2]
    pt2_path = argv[3] if len(argv) > 3 else None

    from pointcloudprocessing_tpu_torch.core.config import load_config
    from pointcloudprocessing_tpu_torch.export.onnx_bridge import export_onnx
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.utils.device import require_device
    from pointcloudprocessing_tpu_torch.train.callbacks import load_checkpoint

    if pt2_path:
        require_device(device)  # refuse before writing anything
    cfg = load_config(config_path)
    # the exports read the weights and trace a CPU copy: build on the CPU
    model = model_from_config(cfg, device="cpu")
    model.load_state_dict(load_checkpoint(stage_dir))
    model.eval()
    if not export_onnx(model, cfg.input_width, onnx_path):
        return 1
    print(f"wrote {onnx_path}")
    if pt2_path:
        from pointcloudprocessing_tpu_torch.export.pt2 import export_program

        export_program(model, cfg.input_width, pt2_path, device=device)
        print(f"wrote {pt2_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

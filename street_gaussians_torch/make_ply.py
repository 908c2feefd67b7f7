"""Flatten the composite scene at one frame into a single standard 3DGS PLY
for SIBR-style viewers.

    python -m street_gaussians_torch.make_ply --config CONFIG.yaml [--device D] [KEY VALUE ...]

Port of the repo's root make_ply.py (ref analog: make_ply.py:15-79): the
newest checkpoint under trained_model (or, without one, the initial
model), composed at viewer.frame_id by compose_frame (actor Gaussians in
world space, Fourier features collapsed at the frame's time), the alive
rows written as one `vertex` element (x y z nx ny nz, f_dc, f_rest
channel-major, opacity as a logit of the clipped sigmoid, log scales,
rotations) to model_path/viewer/<frame:06d>/point_cloud/
iteration_<train.iterations>/point_cloud.ply. The scene is built as
training built it (runner.build_trained_scene), so that the checkpoint's
rows fit. Runs on the CUDA card unless --device says otherwise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.config import config_from_args, make_argparser


def main(argv=None) -> str:
    from street_gaussians_torch import checkpoint as ckpt_lib
    from street_gaussians_torch.models.renderer import compose_frame
    from street_gaussians_torch.runner import (
        EVAL_STEP,
        build_initial_params,
        build_trained_scene,
        render_opts_from_cfg,
    )
    from street_gaussians_torch.train_lib import init_train_state
    from street_gaussians_torch.utils import ply as ply_utils

    ap = make_argparser("street_gaussians_torch make_ply")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    cfg.mode = "evaluate"
    frame_id = cfg.get("viewer", {}).get("frame_id", 0)

    scene = build_trained_scene(cfg, device)
    params = build_initial_params(cfg, scene, device)
    state = init_train_state(params, scene.aux_init)
    restored, it = ckpt_lib.load_train_state(cfg.trained_model_dir, state)
    if restored is not None:
        state = restored
        print(f"[make_ply] loaded iteration {it}")
    else:
        print("[make_ply] no checkpoint found; exporting the initial model")

    views = sorted(scene.all_views, key=lambda v: v.frame_idx)
    view = next((v for v in views if v.frame_idx == frame_id), None)
    if view is None:
        raise ValueError(f"no camera with frame_idx {frame_id}")

    opts = render_opts_from_cfg(cfg, "eval")
    with torch.no_grad():
        composed = compose_frame(state.params, state.aux, scene.table, scene.pose_data, view.frame_input,
                                 EVAL_STEP, opts=opts)
        g = state.params.gaussians
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        alive = host(composed["visible"])
        xyz = host(composed["means3d"])[alive]
        shs = host(composed["shs"])[alive]  # [N, K, 3]
        opacity = np.clip(host(torch.sigmoid(g.opacity_logit))[alive, 0], 1e-6, 1 - 1e-6)
        scale = host(g.log_scale)[alive]
        rot = host(composed["quats"])[alive]

    f_dc = shs[:, 0, :]  # [N, 3]
    f_rest = shs[:, 1:, :].transpose(0, 2, 1).reshape(xyz.shape[0], -1)  # band-major -> channel-major

    fields = (
        [(k, "f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
        + [(f"f_dc_{i}", "f4") for i in range(3)]
        + [(f"f_rest_{i}", "f4") for i in range(f_rest.shape[1])]
        + [("opacity", "f4")]
        + [(f"scale_{i}", "f4") for i in range(3)]
        + [(f"rot_{i}", "f4") for i in range(4)]
    )
    arr = np.zeros(xyz.shape[0], dtype=fields)
    arr["x"], arr["y"], arr["z"] = xyz.T
    for i in range(3):
        arr[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        arr[f"f_rest_{i}"] = f_rest[:, i]
    arr["opacity"] = np.log(opacity / (1 - opacity))
    for i in range(3):
        arr[f"scale_{i}"] = scale[:, i]
    for i in range(4):
        arr[f"rot_{i}"] = rot[:, i]

    out_dir = os.path.join(cfg.model_path, "viewer", f"{frame_id:06d}", "point_cloud",
                           f"iteration_{cfg.train.iterations}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "point_cloud.ply")
    ply_utils.write_ply(path, {"vertex": arr})
    print(f"[make_ply] wrote {xyz.shape[0]} gaussians to {path}")
    return path


if __name__ == "__main__":
    main()

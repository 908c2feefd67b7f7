"""Scene build and render options from a config.

Port of the first part of street_gaussians_tpu/runner.py (`build_scene`,
`build_initial_params`, `render_opts_from_cfg`), each on `device`. The
training loop, the ground-truth cache, checkpoints and YAML configs are
not ported yet.
"""

from __future__ import annotations

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.config import Config
from street_gaussians_torch.data.dataset import CameraView, Scene, load_waymo_scene
from street_gaussians_torch.models.corrections import init_color_correction, init_pose_correction
from street_gaussians_torch.models.renderer import RenderOptions, SceneParams
from street_gaussians_torch.models.sky_cubemap import init_sky


def build_scene(cfg: Config, device=None) -> Scene:
    """The scene of cfg.data.type (Waymo, Kitti, Colmap, Blender or
    SyntheticToy) on `device`."""
    device = resolve_device(device)
    dtype = cfg.data.type
    if dtype in ("Waymo", "Kitti"):
        return load_waymo_scene(cfg, device=device)
    if dtype == "Colmap":
        from street_gaussians_torch.data.static_readers import load_colmap_scene

        return load_colmap_scene(cfg, device=device)
    if dtype == "Blender":
        from street_gaussians_torch.data.static_readers import load_blender_scene

        return load_blender_scene(cfg, device=device)
    if dtype == "SyntheticToy":
        from street_gaussians_torch.data.synthetic import make_synthetic_scene

        syn = make_synthetic_scene(**cfg.data.get("synthetic_kwargs", {}), device=device)
        views = [
            CameraView(
                frame_input=f,
                image_path="",
                H=f.cam.H,
                W=f.cam.W,
                cam=0,
                frame=i,
                frame_idx=i,
                timestamp=float(syn.timestamps[i]),
                is_val=False,
                image_name=f"{i:06d}_0",
            )
            for i, f in enumerate(syn.frames)
        ]
        return Scene(
            table=syn.table,
            params_init=syn.params_init,
            aux_init=syn.aux,
            pose_data=syn.pose_data,
            pose_params_init=syn.pose_params_init,
            train_views=views,
            test_views=[],
            metadata=dict(num_images=len(views), num_cams=1, num_frames=len(views)),
        )
    raise NotImplementedError(f"dataset type {dtype}")


def build_initial_params(cfg: Config, scene: Scene, device=None) -> SceneParams:
    """The scene's initial Gaussians and actor poses, plus the sky and
    the corrections that cfg.model turns on, on `device`."""
    device = resolve_device(device)
    nsg = cfg.model.nsg
    sky = None
    if nsg.get("include_sky", False):
        sky = init_sky(cfg.model.sky.resolution, cfg.model.sky.get("white_background", True), device=device)
    cc = None
    if cfg.model.get("use_color_correction", False):
        num = (
            scene.metadata["num_images"]
            if cfg.model.color_correction.mode == "image"
            else scene.metadata["num_cams"]
        )
        cc = init_color_correction(num, device=device)
    pc = None
    if cfg.model.get("use_pose_correction", False):
        num = (
            scene.metadata["num_images"]
            if cfg.model.pose_correction.mode == "image"
            else scene.metadata["num_frames"]
        )
        pc = init_pose_correction(num, device=device)
    actor_pose = scene.pose_params_init if nsg.get("opt_track", True) else None
    return SceneParams(
        gaussians=scene.params_init,
        actor_pose=actor_pose,
        sky=sky,
        color_correction=cc,
        pose_correction=pc,
    )


def render_opts_from_cfg(cfg: Config, mode: str) -> RenderOptions:
    """RenderOptions from cfg.render and cfg.data; tile_capacity 0 or
    None means uncapped (= instance_capacity)."""
    ic = int(cfg.render.get("instance_capacity", 2**21))
    tc = int(cfg.render.get("tile_capacity", 0) or 0) or ic
    return RenderOptions(
        mode=mode,
        render_normal=cfg.render.get("render_normal", False),
        use_semantic=cfg.data.get("use_semantic", False),
        white_background=cfg.data.get("white_background", False),
        scaling_modifier=cfg.render.get("scaling_modifier", 1.0),
        tile_capacity=tc,
        instance_capacity=ic,
        sky_downsample=int(cfg.render.get("sky_downsample", 1) or 1),
        corner_cull=bool(cfg.render.get("corner_cull", True)),
    )

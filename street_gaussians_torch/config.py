"""Configuration: the JAX package's Config and default_config().

Copied from street_gaussians_tpu/config.py (the nested dict with
attribute access and the reference's tunables with their defaults). The
YAML loading, merging and CLI overrides are not ported yet; this module
imports no yaml, which the card's machine lacks.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


class Config(dict):
    """Nested dict with attribute access. Missing keys raise AttributeError;
    use .get(key, default) for optional tunables (the reference reads many
    YAML-only knobs that way, e.g. lib/models/gaussian_model.py:30-35)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def from_dict(d: Dict) -> "Config":
        out = Config()
        for k, v in d.items():
            out[k] = Config.from_dict(v) if isinstance(v, dict) else v
        return out


def default_config() -> Config:
    """Defaults mirroring lib/config/config.py:8-148."""
    return Config.from_dict(
        {
            "task": "hello",
            "exp_name": "test",
            "mode": "train",
            "debug": False,
            "resume": True,
            "seed": 0,
            "source_path": "",
            "model_path": "",
            "record_dir": None,
            "loaded_iter": -1,
            "resolution": -1,
            "resolution_scales": [1],
            "eval": {
                "skip_train": False,
                "skip_test": False,
                "eval_train": False,
                "eval_test": True,
                "quiet": False,
            },
            "train": {
                "test_iterations": [7000, 30000],
                "save_iterations": [7000, 30000],
                "iterations": 30000,
                "checkpoint_iterations": [30000],
                "start_checkpoint": None,
                "batch_size": 1,  # cameras per step (data-parallel axis)
                # Gaussian-sharded training (parallel/gauss.py): split the
                # packed Gaussian rows + their Adam state over N chips so a
                # scene larger than one chip's HBM can be TRAINED. Composes
                # with batch_size>1 on a 2D ('data','gauss') mesh; needs
                # batch_size*gauss_shards <= devices. 0/1 = off.
                "gauss_shards": 0,
            },
            "optim": {
                "position_lr_init": 0.00016,
                "position_lr_final": 0.0000016,
                "position_lr_delay_mult": 0.01,
                "position_lr_max_steps": 30000,
                "feature_lr": 0.0025,
                "opacity_lr": 0.05,
                "scaling_lr": 0.005,
                "rotation_lr": 0.001,
                "semantic_lr": 0.01,
                "percent_dense": 0.01,
                "densification_interval": 100,
                "opacity_reset_interval": 3000,
                "densify_from_iter": 500,
                "densify_until_iter": 15000,
                "densify_grad_threshold": 0.0002,
                "densify_grad_abs_bkgd": False,
                "densify_grad_abs_obj": False,
                "max_screen_size": 20,
                "min_opacity": 0.005,
                "percent_big_ws": 0.1,
                "lambda_l1": 1.0,
                "lambda_dssim": 0.2,
                "lambda_sky": 0.0,
                "lambda_sky_scale": [],
                "lambda_semantic": 0.0,
                "lambda_reg": 0.0,
                "lambda_depth_lidar": 0.0,
                "lambda_depth_mono": 0.0,
                "lambda_normal_mono": 0.0,
                "lambda_color_correction": 0.0,
                "lambda_pose_correction": 0.0,
                "lambda_scale_flatten": 0.0,
                "lambda_opacity_sparse": 0.0,
                "track_position_lr_init": 0.0005,
                "track_position_lr_final": 0.0001,
                "track_position_lr_delay_mult": 0.01,
                "track_position_max_steps": 30000,
                "track_rotation_lr_init": 0.001,
                "track_rotation_lr_final": 0.0001,
                "track_rotation_lr_delay_mult": 0.01,
                "track_rotation_max_steps": 30000,
                "sky_cube_map_lr_init": 0.01,
                "sky_cube_map_lr_final": 0.0001,
            },
            "model": {
                "gaussian": {
                    "sh_degree": 3,
                    "fourier_dim": 1,
                    "fourier_scale": 1.0,
                    "flip_prob": 0.0,
                    "semantic_mode": "logits",
                },
                "nsg": {
                    "include_bkgd": True,
                    "include_obj": True,
                    "include_sky": False,
                    "opt_track": True,
                },
                "sky": {"resolution": 1024, "white_background": True},
                "use_color_correction": False,
                "color_correction": {"mode": "image", "use_mlp": False, "use_sky": False},
                "use_pose_correction": False,
                "pose_correction": {"mode": "image"},
            },
            "data": {
                "white_background": False,
                "use_colmap_pose": False,
                "filter_colmap": False,
                "box_scale": 1.0,
                "split_test": -1,
                "split_train": 1,
                "shuffle": True,
                "eval": True,
                "type": "Colmap",
                "images": "images",
                "use_semantic": False,
                "num_classes": 20,
                "use_mono_depth": False,
                "use_mono_normal": False,
                "use_colmap": True,
                "extent": None,
                "sphere_scale": 1.0,
            },
            "render": {
                "fps": 24,
                "render_normal": False,
                "save_video": True,
                "save_image": True,
                "coord": "world",
                "concat_cameras": [],
                "scaling_modifier": 1.0,
                # TPU pipeline static capacities (no reference analog —
                # the CUDA code grows buffers dynamically). tile_capacity
                # 0 = uncapped (= instance_capacity): in the ragged
                # layout the per-tile rank mask is then skipped entirely
                # (binning.py) and the blend matches the reference's
                # uncapped early-terminating loop (forward.cu:390-455).
                # A finite cap is an experiment knob only — measured to
                # drop ~18% of instances at bench scale (perf_journal
                # wave 4), so it is no longer the default.
                "tile_capacity": 0,
                "instance_capacity": 2097152,
                # eval/serving: sample the sky on a 1/N ray grid and
                # bilinear-upsample (1 = exact; train mode always exact).
                # Parity bound for 2 measured in docs/perf_journal.md.
                "sky_downsample": 1,
                # serving: probe the scene's instance demand once and
                # rebuild the render at a tight capacity (exact — the
                # overflow guard re-renders any frame that exceeds it)
                "auto_size_capacity": True,
                # double the exceeded capacity when overflow persists
                # (bounded recompiles; see runner.py overflow watchdog)
                "auto_grow_capacity": True,
                # how many doublings the watchdog may apply per capacity
                "grow_budget": 3,
                # when overflow persists and growth is impossible
                # (budget exhausted / ceiling / auto_grow off):
                # 'error' fails loudly like the non-finite-loss path,
                # 'warn' keeps training on dropped instances
                "overflow_policy": "error",
            },
            # SIBR remote viewer bridge (ref: lib/config/config.py:12-13)
            "viewer": {
                "enabled": False,
                "ip": "127.0.0.1",
                "port": 6009,
            },
            "capacity": {
                # fixed-capacity growth headroom (TPU-only knobs)
                "background_growth": 4.0,
                "actor_growth": 4.0,
                "round_to": 256,
            },
        }
    )

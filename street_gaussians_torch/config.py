"""Configuration: defaults, then the YAML file with its parents, then
`KEY VALUE` overrides from the command line.

Port of street_gaussians_tpu/config.py: the nested dict with attribute
access, the reference's tunables with their defaults, the recursive
`parent_cfg` merge, the output paths and the config snapshot. The YAML
is read and written by utils/yaml_subset.py (the subset every file under
configs/ uses, resolved as PyYAML's safe_load resolves it), so this
module needs no PyYAML, which the card's machine is not known to have.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Any, Dict, List, Optional

from street_gaussians_torch.utils import yaml_subset


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

    def to_dict(self) -> Dict:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self.items()}

    def merge(self, other: Dict) -> "Config":
        """Recursive in-place merge (other wins); new keys allowed, like the
        reference's `new_allowed=True` yacs nodes."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = Config.from_dict(v) if isinstance(v, dict) else v
        return self


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


def _parse_value(s: str) -> Any:
    """A CLI override value, read as a one-line YAML document (ints,
    floats, bools, None, lists); the string itself where that fails."""
    try:
        return yaml_subset.loads(s)
    except yaml_subset.YAMLSubsetError:
        return s


def _set_dotted(cfg: Config, key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], Config):
            node[p] = Config()
        node = node[p]
    node[parts[-1]] = Config.from_dict(value) if isinstance(value, dict) else value


def load_yaml_with_parents(path: str) -> Config:
    """A YAML file with its `parent_cfg` chain merged under it (the
    parent relative to the file, else to `workspace`; ref:
    lib/utils/cfg_utils.py:80-89)."""
    current = yaml_subset.load_file(path) or {}
    if "parent_cfg" in current:
        parent_path = current.pop("parent_cfg")
        if not os.path.isabs(parent_path):
            parent_path = os.path.join(os.path.dirname(path), parent_path)
            if not os.path.exists(parent_path):
                parent_path = current.get("workspace", ".") + "/" + parent_path
        base = load_yaml_with_parents(parent_path)
    else:
        base = Config()
    return base.merge(current)


def derive_paths(cfg: Config) -> Config:
    """Output path derivation (ref: lib/utils/cfg_utils.py:35-74)."""
    if not cfg.get("model_path"):
        cfg.model_path = os.path.join("output", cfg.task, cfg.exp_name)
    cfg.trained_model_dir = os.path.join(cfg.model_path, "trained_model")
    cfg.point_cloud_dir = os.path.join(cfg.model_path, "point_cloud")
    if not cfg.get("record_dir"):
        cfg.record_dir = os.path.join(cfg.model_path, "record")
    return cfg


def load_config(
    config_path: Optional[str] = None,
    overrides: Optional[List[str]] = None,
    mode: str = "",
) -> Config:
    """defaults -> YAML (+ parents) -> `KEY VALUE` overrides -> mode
    (ref: lib/config/config.py:150-158)."""
    cfg = default_config()
    if config_path:
        cfg.merge(load_yaml_with_parents(config_path))
    if overrides:
        assert len(overrides) % 2 == 0, "overrides must be KEY VALUE pairs"
        for k, v in zip(overrides[::2], overrides[1::2]):
            _set_dotted(cfg, k, _parse_value(v))
    if mode:
        cfg.mode = mode
    return derive_paths(cfg)


def make_argparser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--mode", type=str, default="")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    return load_config(args.config, args.opts, args.mode)


def save_config(cfg: Config, path: str) -> None:
    """Config snapshot (ref: lib/utils/cfg_utils.py:101-111), in block
    style with lists of scalars in flow style."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(yaml_subset.dumps(cfg.to_dict()))

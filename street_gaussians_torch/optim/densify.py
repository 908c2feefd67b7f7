"""Adaptive density control at static shape.

Port of street_gaussians_tpu/optim/densify.py. The packed buffers never
change shape: clones and splits are written into dead slots of the same
model's slice, pruning clears the alive bit, and the Adam moments and
step counts of every new row are zeroed. The JAX code's `mode="drop"`
scatters (index C means "nowhere") become writes into a buffer with one
trash row at index C that is sliced off afterwards; every real row is
written at most once, so the result does not depend on write order.

Semantics per model kind, as the JAX package's:
  * clone: grad >= thr and max-scale <= percent_dense * extent;
  * split: grad >= thr and max-scale > percent_dense * extent; two
    samples from the Gaussian, scale / 1.6, the original pruned;
  * grad: the norm column, or the AbsGS column where densify_grad_abs_*
    is set (random-init or deformable actors always use the norm);
  * prune: opacity < min_opacity; with prune_big_points also too large
    (background only within 2x the sphere radius; actors also when one
    of two samples falls outside their box).
The random draws (the box test's [C, 2, 3] and the two split samples'
[C, 3] standard normals) come from a torch.Generator, or are passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from street_gaussians_torch.models.gaussians import GaussianAux, GaussianParams, SceneTable
from street_gaussians_torch.optim.adam import AdamState
from street_gaussians_torch.utils.quaternion import quat_normalize, quat_to_rotmat
from street_gaussians_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    densify_grad_threshold: float = 0.0002
    densify_grad_threshold_bkgd: Optional[float] = None
    densify_grad_threshold_obj: Optional[float] = None
    densify_grad_abs_bkgd: bool = False
    densify_grad_abs_obj: bool = False
    percent_dense: float = 0.01
    percent_big_ws: float = 0.1
    min_opacity: float = 0.005


class DensifyNoise(NamedTuple):
    box: torch.Tensor  # [C, 2, 3] standard normal
    split1: torch.Tensor  # [C, 3]
    split2: torch.Tensor  # [C, 3]


def draw_noise(capacity: int, generator: torch.Generator, device) -> DensifyNoise:
    dev = generator.device
    return DensifyNoise(
        *(torch.randn(shape, generator=generator, device=dev).to(device)
          for shape in ((capacity, 2, 3), (capacity, 3), (capacity, 3)))
    )


def step_stats(
    radii: torch.Tensor,
    viewspace_grad: torch.Tensor,
    viewspace_absgrad: torch.Tensor,
    W: int,
    H: int,
):
    """One camera's densification statistics: the pixel-space
    mean-gradient norm and AbsGS sum (scaled by (W/2, H/2), the CUDA
    rasterizer's NDC units) [C, 2], the visibility count [C] and the
    radius [C], each 0 where the Gaussian is not visible."""
    vis = radii > 0.0
    with span("sync/stat_scale"):
        scale = torch.tensor([W / 2.0, H / 2.0], device=radii.device)
    g = viewspace_grad * scale[None, :]
    ga = viewspace_absgrad * scale[None, :]
    add = torch.stack([torch.linalg.norm(g, dim=-1), ga[:, 0] + ga[:, 1]], dim=-1)
    return torch.where(vis[:, None], add, 0.0), vis.to(torch.float32), torch.where(vis, radii, 0.0)


def add_stats(aux: GaussianAux, add: torch.Tensor, denom_add: torch.Tensor, radii: torch.Tensor) -> GaussianAux:
    """Accumulate step_stats' three (summed over cameras, the radius the
    max over them) into aux."""
    return dataclasses.replace(
        aux,
        grad_accum=aux.grad_accum + add,
        denom=aux.denom + denom_add,
        max_radii=torch.maximum(aux.max_radii, radii),
    )


def _rank_in_segment(flags: torch.Tensor, seg_start_row: torch.Tensor) -> torch.Tensor:
    """Exclusive rank of the True entries within their model's slice."""
    f = flags.to(torch.int64)
    excl = torch.cumsum(f, 0) - f
    return excl - excl[seg_start_row]


def _scatter_rows(arr: torch.Tensor, dest: Tuple[torch.Tensor, torch.Tensor], vals) -> torch.Tensor:
    """arr with rows dest[0] <- vals[0], then dest[1] <- vals[1]; index C
    (the trash row) drops a write."""
    buf = torch.cat([arr, arr[:1]])
    for d, v in zip(dest, vals):
        buf[d] = v
    return buf[:-1]


def densify_and_prune(
    params: GaussianParams,
    adam: AdamState,
    aux: GaussianAux,
    table: SceneTable,
    cfg: DensifyConfig,
    prune_big_points: bool,
    generator: Optional[torch.Generator] = None,
    noise: Optional[DensifyNoise] = None,
) -> Tuple[GaussianParams, AdamState, GaussianAux, Dict[str, torch.Tensor]]:
    """One densification round. `adam` holds the Gaussian leaves only,
    keyed by GaussianParams field name. Returns (params, adam, aux,
    diagnostics)."""
    C = table.capacity
    mid = aux.model_id
    dev = mid.device
    M = table.num_models
    is_actor = (mid > 0) & (table.track_id[mid] >= 0)
    is_sky = (mid == table.sky_model) & (table.sky_model >= 0)
    with span("sync/densify_constants"):
        seg_start_row = torch.as_tensor(table.slices[:, 0], device=dev)[mid]
    if noise is None:
        noise = draw_noise(C, generator, dev)

    # per-row grad signal and threshold
    thr = cfg.densify_grad_threshold
    thr_bkgd = thr if cfg.densify_grad_threshold_bkgd is None else cfg.densify_grad_threshold_bkgd
    thr_obj = thr if cfg.densify_grad_threshold_obj is None else cfg.densify_grad_threshold_obj
    plain_actor = table.random_init[mid] | table.deformable[mid]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    with span("sync/densify_constants"):
        thr_row = torch.where(
            is_actor, torch.where(plain_actor, f32(thr), f32(thr_obj)),
            torch.where(is_sky, f32(thr), f32(thr_bkgd)),
        )
    use_abs = torch.where(
        is_actor, ~plain_actor & cfg.densify_grad_abs_obj, ~is_sky & cfg.densify_grad_abs_bkgd
    )
    col = torch.where(use_abs, aux.grad_accum[:, 1], aux.grad_accum[:, 0])
    grads = torch.where(aux.denom > 0, col / torch.clamp(aux.denom, min=1.0), 0.0)

    scaling = torch.exp(params.log_scale)
    max_scale = scaling.max(dim=1).values
    ext_row = table.extent[mid]
    sel = aux.alive & (grads >= thr_row)
    small = max_scale <= cfg.percent_dense * ext_row
    clone = sel & small
    split = sel & ~small

    # prune mask
    opacity = torch.sigmoid(params.opacity_logit)[:, 0]
    prune = aux.alive & (opacity < cfg.min_opacity)
    big_ws = max_scale > ext_row * cfg.percent_big_ws
    with span("sync/densify_constants"):
        center = torch.as_tensor(table.sphere_center, device=dev)
    d_sphere = torch.linalg.norm(params.xyz - center[None, :], dim=-1)
    big_bkgd = big_ws & (d_sphere <= 2.0 * table.sphere_radius)
    samples = noise.box * scaling[:, None, :]
    R = quat_to_rotmat(quat_normalize(params.rot))  # [C, 3, 3]
    pts = torch.einsum("cij,csj->csi", R, samples) + params.xyz[:, None, :]
    half = table.bbox_half[mid][:, None, :]
    inside = ((pts >= -half) & (pts <= half)).all(dim=2).all(dim=1)
    big_actor = big_ws | ~inside
    prune_big = torch.where(is_actor, big_actor, torch.where(is_sky, big_ws, big_bkgd))
    prune = prune | (aux.alive & prune_big & bool(prune_big_points))
    prune = prune | split  # split originals are replaced
    alive_after = aux.alive & ~prune

    # candidates (A: clone copy / split sample 1; B: split sample 2)
    def split_sample(eps):
        return params.xyz + torch.einsum("cij,cj->ci", R, eps * scaling)

    split_log_scale = torch.log(scaling / (0.8 * 2.0))
    valid_a = clone | split
    valid_b = split
    cand_xyz_a = torch.where(split[:, None], split_sample(noise.split1), params.xyz)
    cand_ls_a = torch.where(split[:, None], split_log_scale, params.log_scale)
    cand_xyz_b = split_sample(noise.split2)

    # slot allocation within each model's slice
    free = ~alive_after
    free_rank = _rank_in_segment(free, seg_start_row)
    with span("sync/densify_counts"):  # a boolean mask's length, bincount's largest id
        free_count = torch.bincount(mid[free], minlength=M)
    rows = torch.arange(C, device=dev)
    slot_by_rank = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    slot_by_rank[torch.where(free, seg_start_row + free_rank, C)] = rows
    slot_by_rank = slot_by_rank[:C]
    with span("sync/densify_counts"):
        count_a = torch.bincount(mid[valid_a], minlength=M)
    rank_a = _rank_in_segment(valid_a, seg_start_row)
    rank_b = _rank_in_segment(valid_b, seg_start_row) + count_a[mid]

    def dest_of(valid, rank):
        ok = valid & (rank < free_count[mid])
        slot = slot_by_rank[torch.clamp(seg_start_row + rank, 0, C - 1)]
        return torch.where(ok, slot, C), ok

    dest_a, ok_a = dest_of(valid_a, rank_a)
    dest_b, ok_b = dest_of(valid_b, rank_b)
    dest = (dest_a, dest_b)

    g = params
    same = lambda a: (a, a)  # noqa: E731
    new_params = GaussianParams(
        xyz=_scatter_rows(g.xyz, dest, (cand_xyz_a, cand_xyz_b)),
        feat_dc=_scatter_rows(g.feat_dc, dest, same(g.feat_dc)),
        feat_rest=_scatter_rows(g.feat_rest, dest, same(g.feat_rest)),
        log_scale=_scatter_rows(g.log_scale, dest, (cand_ls_a, split_log_scale)),
        rot=_scatter_rows(g.rot, dest, same(g.rot)),
        opacity_logit=_scatter_rows(g.opacity_logit, dest, same(g.opacity_logit)),
        semantic=_scatter_rows(g.semantic, dest, same(g.semantic)),
    )

    # new rows start with zero moments and a zero step count
    def zero_rows(tree):
        return {k: _scatter_rows(a, dest, (0.0, 0.0)) for k, a in tree.items()}

    # a Python scalar written into rows is copied to the card first
    with span("sync/densify_fill"):
        new_adam = AdamState(mu=zero_rows(adam.mu), nu=zero_rows(adam.nu), count=zero_rows(adam.count))
        new_alive = _scatter_rows(alive_after, dest, (True, True))
    new_aux = dataclasses.replace(
        aux,
        alive=new_alive,
        grad_accum=torch.zeros_like(aux.grad_accum),
        denom=torch.zeros_like(aux.denom),
        max_radii=torch.zeros_like(aux.max_radii),
    )
    diag = dict(
        points_total=new_alive.sum(),
        points_clone=clone.sum(),
        points_split=split.sum(),
        points_pruned=(prune & ~split).sum(),
        points_dropped=(valid_a & ~ok_a).sum() + (valid_b & ~ok_b).sum(),
        points_order_sensitive=((clone | split) & (opacity < cfg.min_opacity)).sum(),
    )
    return new_params, new_adam, new_aux, diag


def reset_opacity(params: GaussianParams, adam: AdamState) -> Tuple[GaussianParams, AdamState]:
    """Clamp opacity to <= 0.01 and zero its Adam moments (step counts
    kept). `adam` holds the Gaussian leaves, keyed by field name."""
    op = torch.sigmoid(params.opacity_logit)
    with span("sync/densify_constants"):
        cap = op.new_tensor(0.01)
    op = torch.minimum(op, cap)
    new_params = dataclasses.replace(params, opacity_logit=torch.log(op / (1.0 - op)))
    zero = lambda t: {**t, "opacity_logit": torch.zeros_like(t["opacity_logit"])}  # noqa: E731
    return new_params, AdamState(mu=zero(adam.mu), nu=zero(adam.nu), count=adam.count)

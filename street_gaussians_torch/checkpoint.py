"""Checkpoints and PLY export.

Port of street_gaussians_tpu/checkpoint.py. Two kinds of artifact:

1. the whole training state under `trained_model/iteration_N/`, a
   directory as the JAX package's (so that search_max_iteration and the
   resume find it the same way), holding one torch.save of a flat
   {name: tensor} dict: every parameter (train_lib.flatten_params
   names under `params.`), the Adam moments and step counts (`adam.mu.`,
   `adam.nu.`, `adam.count.`), every GaussianAux field (`aux.`) and
   `step`. The JAX package writes an orbax pytree there instead; the
   two packages do not read each other's files;
2. multi-element PLY snapshots `point_cloud/iteration_N/point_cloud.ply`
   with one `vertex_<model>` element per sub-model, byte for byte as the
   JAX package writes them (ref: street_gaussian_model.py:94-117).

A state is loaded whole or not at all: leaf names, shapes and dtypes
must equal the template's.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.optim.adam import AdamState
from street_gaussians_torch.train_lib import TrainState, flatten_params, unflatten_params
from street_gaussians_torch.utils import ply as ply_utils

STATE_FILE = "state.pt"
_MOMENTS = ("mu", "nu", "count")


def search_max_iteration(folder: str) -> Optional[int]:
    """(ref: lib/utils/system_utils.py:26-28)"""
    if not os.path.isdir(folder):
        return None
    iters = []
    for name in os.listdir(folder):
        m = re.search(r"iteration_(\d+)", name)
        if m:
            iters.append(int(m.group(1)))
    return max(iters) if iters else None


def state_to_flat(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every leaf of a TrainState under one flat name, `step` as a 0-dim
    int64 tensor."""
    flat = {f"params.{k}": v for k, v in flatten_params(state.params).items()}
    for m in _MOMENTS:
        flat.update({f"adam.{m}.{k}": v for k, v in getattr(state.adam, m).items()})
    for f in dataclasses.fields(state.aux):
        flat[f"aux.{f.name}"] = getattr(state.aux, f.name)
    flat["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    return flat


def state_from_flat(flat: Dict[str, torch.Tensor], template: TrainState) -> TrainState:
    """The TrainState of template's structure holding flat's tensors."""
    pick = lambda prefix: {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}  # noqa: E731
    return TrainState(
        params=unflatten_params(pick("params."), template.params),
        adam=AdamState(**{m: pick(f"adam.{m}.") for m in _MOMENTS}),
        aux=dataclasses.replace(template.aux, **pick("aux.")),
        step=int(flat["step"]),
    )


def save_train_state(ckpt_dir: str, iteration: int, state: TrainState) -> str:
    path = os.path.join(ckpt_dir, f"iteration_{iteration}")
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().cpu() for k, v in state_to_flat(state).items()}
    out = os.path.join(path, STATE_FILE)
    torch.save(flat, out + ".tmp")
    os.replace(out + ".tmp", out)
    return out


def load_train_state(ckpt_dir: str, template: TrainState, iteration: Optional[int] = None):
    """Restore a TrainState onto the template's device; the template
    gives the structure, shapes and dtypes. Returns (state, iteration),
    or (None, 0) when there is nothing to resume. Raises, naming the
    leaves, when the file's leaves differ from the template's."""
    if iteration is None:
        iteration = search_max_iteration(ckpt_dir)
    if iteration is None:
        return None, 0
    want = state_to_flat(template)
    device = template.aux.alive.device
    path = os.path.join(ckpt_dir, f"iteration_{iteration}", STATE_FILE)
    got = torch.load(path, map_location=device, weights_only=True)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    differ = sorted(
        k for k in set(want) & set(got)
        if got[k].shape != want[k].shape or got[k].dtype != want[k].dtype
    )
    if missing or extra or differ:
        raise ValueError(
            f"{path} does not fit the template: missing {missing}, unexpected {extra}, "
            + "shape or dtype differs "
            + str([(k, tuple(got[k].shape), str(got[k].dtype), tuple(want[k].shape), str(want[k].dtype))
                   for k in differ])
        )
    return state_from_flat(got, template), iteration


def gaussians_to_ply_elements(params: G.GaussianParams, aux: G.GaussianAux, table: G.SceneTable):
    """Pack alive rows of every sub-model into PLY structured arrays with
    the reference's attribute list (ref: gaussian_model.py:80-103,
    construct_list_of_attributes); element names `vertex_<model>`
    (street_gaussian_model.py:94-105)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    xyz = host(params.xyz)
    # [C, Fdim, 3] -> the reference's f_dc_{c*Fdim + k} layout
    f_dc = host(params.feat_dc).transpose(0, 2, 1).reshape(xyz.shape[0], -1)
    f_rest = host(params.feat_rest).transpose(0, 2, 1).reshape(xyz.shape[0], -1)
    opacity = host(params.opacity_logit)
    scale = host(params.log_scale)
    rot = host(params.rot)
    semantic = host(params.semantic)
    alive = host(aux.alive)

    elements = {}
    for mi, name in enumerate(table.names):
        s, e = table.slices[mi]
        m = alive[s:e]
        fields = (
            [(k, "f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
            + [(f"f_dc_{i}", "f4") for i in range(f_dc.shape[1])]
            + [(f"f_rest_{i}", "f4") for i in range(f_rest.shape[1])]
            + [("opacity", "f4")]
            + [(f"scale_{i}", "f4") for i in range(3)]
            + [(f"rot_{i}", "f4") for i in range(4)]
            + [(f"semantic_{i}", "f4") for i in range(semantic.shape[1])]
        )
        arr = np.zeros(int(m.sum()), dtype=fields)
        sel = np.where(m)[0] + s
        arr["x"], arr["y"], arr["z"] = xyz[sel, 0], xyz[sel, 1], xyz[sel, 2]
        for i in range(f_dc.shape[1]):
            arr[f"f_dc_{i}"] = f_dc[sel, i]
        for i in range(f_rest.shape[1]):
            arr[f"f_rest_{i}"] = f_rest[sel, i]
        arr["opacity"] = opacity[sel, 0]
        for i in range(3):
            arr[f"scale_{i}"] = scale[sel, i]
        for i in range(4):
            arr[f"rot_{i}"] = rot[sel, i]
        for i in range(semantic.shape[1]):
            arr[f"semantic_{i}"] = semantic[sel, i]
        elements[f"vertex_{name}"] = arr
    return elements


def save_point_cloud(dirpath: str, iteration: int, params, aux, table) -> str:
    out_dir = os.path.join(dirpath, f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "point_cloud.ply")
    ply_utils.write_ply(path, gaussians_to_ply_elements(params, aux, table))
    return path


def load_point_cloud_into(
    path: str, params: G.GaussianParams, aux: G.GaussianAux, table: G.SceneTable
) -> Tuple[G.GaussianParams, G.GaussianAux]:
    """Load a multi-element PLY back into packed buffers on the params'
    device (viewer and export round trip; the training resume reads the
    state checkpoint instead)."""
    elems = ply_utils.read_ply(path)
    host = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
    xyz, f_dc, f_rest = host(params.xyz), host(params.feat_dc), host(params.feat_rest)
    log_scale, rot, opacity = host(params.log_scale), host(params.rot), host(params.opacity_logit)
    semantic = host(params.semantic)
    alive = np.zeros(table.capacity, bool)

    Fdim = f_dc.shape[1]
    K1 = f_rest.shape[1]
    for mi, name in enumerate(table.names):
        v = elems.get(f"vertex_{name}")
        if v is None:
            continue
        s, e = table.slices[mi]
        n = min(len(v), e - s)
        sl = slice(s, s + n)
        xyz[sl] = np.stack([v["x"][:n], v["y"][:n], v["z"][:n]], axis=-1)
        dc = np.stack([v[c][:n] for c in v.dtype.names if c.startswith("f_dc_")], axis=-1)
        f_dc[sl] = dc.reshape(n, 3, Fdim).transpose(0, 2, 1)
        rest_cols = [c for c in v.dtype.names if c.startswith("f_rest_")]
        if rest_cols:
            rest = np.stack([v[c][:n] for c in rest_cols], axis=-1)
            f_rest[sl] = rest.reshape(n, 3, K1).transpose(0, 2, 1)
        opacity[sl, 0] = v["opacity"][:n]
        log_scale[sl] = np.stack([v[f"scale_{i}"][:n] for i in range(3)], axis=-1)
        rot[sl] = np.stack([v[f"rot_{i}"][:n] for i in range(4)], axis=-1)
        sem_cols = [c for c in v.dtype.names if c.startswith("semantic_")]
        if sem_cols:
            semantic[sl, : len(sem_cols)] = np.stack([v[c][:n] for c in sem_cols], axis=-1)
        alive[s : s + n] = True

    dev = params.xyz.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    new_params = G.GaussianParams(
        xyz=t(xyz), feat_dc=t(f_dc), feat_rest=t(f_rest), log_scale=t(log_scale),
        rot=t(rot), opacity_logit=t(opacity), semantic=t(semantic),
    )
    return new_params, dataclasses.replace(aux, alive=t(alive))

"""Row-masked Adam over dictionaries of tensors.

Port of street_gaussians_tpu/optim/adam.py. Per-row semantics are those
of torch Adam under zero_grad(set_to_none=True) with one parameter group
per sub-model: a row whose mask is 0 this step is skipped entirely (its
moments do not decay and its step count does not grow), and each row
keeps its own step count, so an actor that enters the scene late starts
its bias correction at 1. eps is 1e-15, as the reference's. torch.optim.Adam
has neither the row mask nor the per-row counts.

State and parameters are plain `{name: tensor}` dictionaries; a
parameter of a sub-model without rows (the sky, the corrections) has a
scalar count and no mask.

`adam_update` runs the plain version (`adam_update_plain`: `leaf_update`
a leaf, some 22 elementwise kernels each) for CPU tensors, and for CUDA
tensors `csrc/adam.cu`: every leaf's step in one launch, one pass over
p, g, mu and nu, bit-equal to the plain version (it replaces no TPU
kernel: the JAX package's Adam is plain jnp, which XLA fused; see the
source for its bound and design). The kernel takes float32 contiguous
leaves (a gradient in another layout is copied first) with a per-row or
scalar count, a bool per-row mask (per-row counts only) and a float or
per-row lr, as train_lib.apply_gradients passes them; it raises on
anything else (the plain version keeps its wider contract).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Union

import torch

from street_gaussians_torch.kernels import _build

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Tensors  # first moments, keyed as the parameters
    nu: Tensors  # second moments
    count: Tensors  # step counts: [rows] for row-counted leaves, scalar otherwise


def adam_init(params: Tensors, row_counted=()) -> AdamState:
    """Zero moments; per-row [N] counts for the names in row_counted."""
    return AdamState(
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
        count={
            k: p.new_zeros((p.shape[0],) if k in row_counted else ())
            for k, p in params.items()
        },
    )


def _rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row [N] tensor shaped to broadcast against like [N, ...]."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def leaf_update(p, g, mu, nu, cnt, lr, mask, b1=0.9, b2=0.999, eps=1e-15):
    """One leaf's step. lr: a float or a per-row [N] tensor; mask: None
    (always active) or a per-row [N] bool/float tensor. Returns (p, mu,
    nu, cnt), new tensors."""
    m = torch.ones((), dtype=p.dtype, device=p.device) if mask is None else mask.to(p.dtype)
    mb = _rows(m, p) if m.dim() else m
    cnt = cnt + m
    mu = mb * (b1 * mu + (1.0 - b1) * g) + (1.0 - mb) * mu
    nu = mb * (b2 * nu + (1.0 - b2) * g * g) + (1.0 - mb) * nu
    c = _rows(cnt, p) if cnt.dim() else cnt
    stepped = c > 0.0
    one = torch.ones((), dtype=p.dtype, device=p.device)
    bc1 = 1.0 - b1 ** torch.where(stepped, c, one)
    bc2 = 1.0 - b2 ** torch.where(stepped, c, one)
    if isinstance(lr, torch.Tensor) and lr.dim():
        lr = _rows(lr, p)
    upd = torch.where(stepped, lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps), 0.0)
    return p - mb * upd, mu, nu, cnt


def adam_update_plain(
    params: Tensors,
    grads: Tensors,
    state: AdamState,
    lr: Dict[str, Union[float, torch.Tensor]],
    mask: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """Plain PyTorch version: `leaf_update` over every name of params.
    Same contract as `adam_update`."""
    new_p, mu, nu, cnt = {}, {}, {}, {}
    for k, p in params.items():
        m = None if mask is None else mask.get(k)
        new_p[k], mu[k], nu[k], cnt[k] = leaf_update(
            p, grads[k], state.mu[k], state.nu[k], state.count[k], lr[k], m, b1, b2, eps
        )
    return new_p, AdamState(mu=mu, nu=nu, count=cnt)


# csrc/adam.cu AdamLeaf.flags, and the leaves its launch takes
ROW_COUNT = 1
MAX_LEAVES = 32


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    d = ctypes.c_double
    lib.adam_step_f32.argtypes = [ctypes.c_int, p, p, p, p, d, d, d, p, p]
    lib.adam_step_f32.restype = ctypes.c_int


def kernel_leaf(name: str, p, g, mu, nu, cnt, lr, mask):
    """One leaf's entry of the kernel's table: (numel, width, flags,
    Python lr or 0.0). Raises ValueError on a leaf the kernel does not
    take."""
    f32 = torch.float32
    for what, t in (("param", p), ("grad", g), ("mu", mu), ("nu", nu), ("count", cnt)):
        if t.dtype != f32 or not t.is_contiguous() or t.device != p.device:
            raise ValueError(f"adam_update: {name} {what} must be float32, contiguous and on {p.device}, "
                             f"got {t.dtype} {tuple(t.stride())} on {t.device}")
    for what, t in (("grad", g), ("mu", mu), ("nu", nu)):
        if t.shape != p.shape:
            raise ValueError(f"adam_update: {name} {what} shape {tuple(t.shape)} != {tuple(p.shape)}")
    numel = p.numel()
    if numel >= 2**31:
        raise ValueError(f"adam_update: {name} has {numel} >= 2**31 elements")
    rows = p.shape[0] if p.dim() else 1
    width = numel // rows if rows else 1
    flags, lr_scalar = 0, 0.0
    if cnt.dim():
        if cnt.shape != (rows,) or p.dim() == 0 or width == 0:
            raise ValueError(f"adam_update: {name} count {tuple(cnt.shape)} is not one per row of {tuple(p.shape)}")
        flags |= ROW_COUNT
    if mask is not None:
        if not flags & ROW_COUNT:
            raise ValueError(f"adam_update: {name} has a mask but a scalar count")
        if mask.shape != (rows,) or mask.dtype != torch.bool or not mask.is_contiguous() or mask.device != p.device:
            raise ValueError(f"adam_update: {name} mask must be a contiguous bool [{rows}] on "
                             f"{p.device}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    if isinstance(lr, torch.Tensor):
        if lr.dtype != f32 or lr.device != p.device or lr.shape != (rows,) or not lr.is_contiguous():
            raise ValueError(f"adam_update: {name} lr must be a float, or a float32 [{rows}] tensor on "
                             f"{p.device}, got {lr.dtype} {tuple(lr.shape)} on {lr.device}")
    elif isinstance(lr, (int, float)):
        lr_scalar = float(lr)
    else:
        raise ValueError(f"adam_update: {name} lr must be a float or a tensor, got {type(lr).__name__}")
    return numel, width, flags, lr_scalar


def adam_update(
    params: Tensors,
    grads: Tensors,
    state: AdamState,
    lr: Dict[str, Union[float, torch.Tensor]],
    mask: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One Adam step over every name of params. Returns (params, state),
    new tensors (the inputs are not modified). CPU tensors take the plain
    version, CUDA tensors the kernel: one launch for every leaf, at most
    MAX_LEAVES of them."""
    if not params or next(iter(params.values())).device.type == "cpu":
        return adam_update_plain(params, grads, state, lr, mask, b1, b2, eps)
    first = next(iter(params.values()))
    _build.require_cuda(first, "adam_update")
    if len(params) > MAX_LEAVES:
        raise ValueError(f"adam_update: {len(params)} leaves, the kernel takes at most {MAX_LEAVES}")
    new_p, mu, nu, cnt = {}, {}, {}, {}
    ptrs, sizes, flags, lrs = [], [], [], []
    # a gradient may come from autograd in another layout (the semantic
    # leaf's arrives transposed): it is copied to the parameter's, and
    # the copy is held here until the launch is queued, so that no later
    # leaf's output takes its memory before the kernel has read it; the
    # state's own arrays must be contiguous
    grads_c = []
    for k, p in params.items():
        m = None if mask is None else mask.get(k)
        grads_c.append(grads[k].contiguous())
        args = (p, grads_c[-1], state.mu[k], state.nu[k], state.count[k])
        if p.device != first.device:
            raise ValueError(f"adam_update: {k} on {p.device}, the other leaves on {first.device}")
        numel, width, f, lr_scalar = kernel_leaf(k, *args, lr[k], m)
        new_p[k], mu[k], nu[k], cnt[k] = (torch.empty_like(t) for t in (p, args[2], args[3], args[4]))
        lr_t = lr[k] if isinstance(lr[k], torch.Tensor) else None
        ptrs += [t.data_ptr() for t in (*args[:4], new_p[k], mu[k], nu[k], args[4], cnt[k])]
        ptrs += [0 if m is None else m.data_ptr(), 0 if lr_t is None else lr_t.data_ptr()]
        sizes += [numel, width]
        flags.append(f)
        lrs.append(lr_scalar)
    n = len(flags)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_sizes = (ctypes.c_longlong * len(sizes))(*sizes)
    c_flags = (ctypes.c_int * n)(*flags)
    c_lrs = (ctypes.c_double * n)(*lrs)
    launched = ctypes.c_int(0)
    lib = _build.load("adam", _bind)
    err = lib.adam_step_f32(
        n, *(ctypes.addressof(a) for a in (c_ptrs, c_sizes, c_flags, c_lrs)), b1, b2, eps,
        ctypes.addressof(launched), _build.stream_of(first),
    )
    _build.check(err, "adam_update")
    adam_update.launches += launched.value
    return new_p, AdamState(mu=mu, nu=nu, count=cnt)


adam_update.launches = 0

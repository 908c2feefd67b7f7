"""Plain PyTorch reference of the street-scene render.

Written from the method's equations, not from the program: a scene
graph of a static background and rigid actors (Street Gaussians,
Yan et al. 2024), 3D Gaussian splatting's EWA projection and front-to-back
alpha compositing over 16x16 tiles (Kerbl et al. 2023), a sky cubemap
sampled bilinearly. It imports nothing of the program and takes nothing
the program made: it reads the benchmark's scene (harness/scene.py) and
parameters held in its own dict of tensors.

Conventions that decide which Gaussian reaches which pixel are the
system's documented ones, since a reference that differed there would
not be comparing the same function: the 0.2 m near plane, the 0.3 px
low-pass, the 1.3 tan(fov) clamp of the Jacobian, radius ceil(3 sqrt
lambda_max), the opacity-aware ellipse bounding box in tiles, alpha =
min(0.99, opacity exp(-q/2)) kept from 1/255 on, the stop at
transmittance 1e-4 (the Gaussian that would cross it is not blended),
depth order with ties by row, the actors' symmetry flip across their box's
y axis (a half turn about y for the orientation), the Fourier colour
of the actors, the cubemap's face layout (nvdiffrast's) with its
border taps. Where the tile walk is long, a pair is left out when its
alpha cannot reach 1/255 anywhere in the tile (it cannot change the
image), with a margin.

The compositing runs per instance and pixel in float32, with the
running sums of log(1 - alpha) and of the weighted features taken in
float64 within each tile's run, a block of tiles at a time under
torch.utils.checkpoint, so that autograd gives every gradient and the
memory stays that of one block. Every matrix product goes through
`mm`, which `precise(False)` turns to TF32 (the control).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
PIX = TILE * TILE
NEAR = 0.2
LOWPASS = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
LOG_T_MIN = math.log(1e-4)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
# instances per checkpointed block of tiles
BLOCK = 1 << 16


_TF32 = [False]


def precise(on: bool) -> None:
    """Matrix products in float32 (on) or in TF32 (off: the control),
    the precision below the float32 with TF32 off that the program
    states: each product's inputs rounded to TF32's 10-bit mantissa, as
    the tensor cores take them, and summed in float32."""
    _TF32[0] = not on
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (the nearest value with a 10-bit mantissa, ties
    away from zero); its gradient passes through unchanged."""
    b = x.contiguous().view(torch.int32)
    r = ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul in the reference's precision (see precise)."""
    if _TF32[0] and a.dtype == torch.float32:
        a, b = tf32(a), tf32(b)
    return torch.matmul(a, b)


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z), normalised here -> [..., 3, 3]."""
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, o], -1), torch.stack([s, c, o], -1), torch.stack([o, o, i], -1)], -2)


def actor_world_pose(scene, p: Dict[str, torch.Tensor], view):
    """World rotation [A, 3, 3] and translation [A, 3] of every actor at
    the view's frame: the tracklet's ego-frame pose, its learnable
    residual (a translation and a yaw: the quaternion residual
    (cos t, 0, 0, sin t) turns by 2t), then the ego pose."""
    f = view.frame_idx
    dev = p["gaussians.xyz"].device
    trans = scene.track_trans[f] + p["actor_pose.opt_trans"][f]
    R = mm(quat_rotmat(scene.track_rots[f]), rot_z(2.0 * p["actor_pose.opt_rots"][f, :, 0]))
    Re = torch.tensor(view.ego_pose[:3, :3], dtype=torch.float32, device=dev)
    te = torch.tensor(view.ego_pose[:3, 3], dtype=torch.float32, device=dev)
    return mm(Re, R), mm(trans, Re.T) + te


def compose(scene, p: Dict[str, torch.Tensor], view, flip: Optional[torch.Tensor], models=None, alive=None):
    """World-space Gaussians of one view: (means [C, 3], rotations
    [C, 3, 3], scales [C, 3], opacity [C], dc colour coefficient [C, 3],
    visible [C]). models: the model ids to keep (None: all); alive: the
    live rows (None: the scene's)."""
    m = scene.models
    mid = scene.model_id
    dev = mid.device
    A = len(m.names) - 1
    frame = view.frame
    in_range = torch.tensor([(m.start_frame[i] <= frame <= m.end_frame[i]) for i in range(A + 1)], device=dev)
    visible = (scene.alive if alive is None else alive) & in_range[mid]
    if models is not None:
        keep = torch.zeros(A + 1, dtype=torch.bool, device=dev)
        keep[list(models)] = True
        visible = visible & keep[mid]
    is_actor = mid > 0
    x = p["gaussians.xyz"]
    Rl = quat_rotmat(p["gaussians.rot"])
    if flip is not None:
        x = torch.where(flip[:, None], x * torch.tensor([1.0, -1.0, 1.0], device=dev), x)
        half_turn_y = torch.diag(torch.tensor([-1.0, 1.0, -1.0], device=dev))
        Rl = torch.where(flip[:, None, None], mm(half_turn_y, Rl), Rl)
    Ra, ta = actor_world_pose(scene, p, view)
    Ra = torch.cat([torch.eye(3, device=dev)[None], Ra])
    ta = torch.cat([torch.zeros(1, 3, device=dev), ta])
    R_row = Ra[mid]
    means = torch.where(is_actor[:, None], mm(R_row, x[:, :, None])[..., 0] + ta[mid], x)
    rots = torch.where(is_actor[:, None, None], mm(R_row, Rl), Rl)
    # colour: coefficient 0 for the background, the Fourier series in the
    # model's normalised time for an actor
    fd = p["gaussians.feat_dc"]
    K = fd.shape[1]
    start = torch.tensor(m.start_frame, dtype=torch.float32, device=dev)
    end = torch.tensor(m.end_frame, dtype=torch.float32, device=dev)
    t = scene.cfg["fourier_scale"] * (frame - start) / (end - start).clamp(min=1.0)
    k = torch.arange(K, device=dev, dtype=torch.float32)
    basis = torch.where(k.long() % 2 == 0, torch.cos(math.pi * k * t[:, None]), torch.sin(math.pi * (k + 1) * t[:, None]))
    basis = torch.where(is_actor[:, None], basis[mid], (k == 0).float()[None, :])
    dc = (basis[:, :, None] * fd).sum(1)
    return dict(means=means, rots=rots, scales=torch.exp(p["gaussians.log_scale"]),
                opacity=torch.sigmoid(p["gaussians.opacity_logit"])[:, 0], dc=dc, visible=visible)


def camera(scene, view, device):
    """(w2c rotation [3, 3], translation [3], centre [3], fx, fy, cx, cy)."""
    w2c = torch.tensor(view.w2c, dtype=torch.float32, device=device)
    c2w = torch.linalg.inv(torch.tensor(view.w2c, dtype=torch.float64))
    K = scene.K
    return (w2c[:3, :3], w2c[:3, 3], c2w[:3, 3].float().to(device),
            float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))


def project(scene, g: Dict[str, torch.Tensor], feat_rest: torch.Tensor, view, m2d_off=None):
    """Screen space: mean2d [C, 2] (pixel centres at integer + 0, the
    rasteriser's convention), conic [C, 3], depth [C], rgb [C, 3],
    opacity [C], valid [C], radius [C] (0 where not valid), tile rect
    min/max [C, 2] (exclusive max). m2d_off: [C, 2] zeros added to
    mean2d, whose gradient is the view-space mean gradient."""
    dev = g["means"].device
    H, W = scene.H, scene.W
    Rw, tw, centre, fx, fy, cx, cy = camera(scene, view, dev)
    pc = mm(g["means"], Rw.T) + tw
    z = pc[:, 2]
    in_front = z > NEAR
    zs = torch.where(in_front, z, torch.ones_like(z))
    mean2d = torch.stack([fx * pc[:, 0] / zs + cx - 0.5, fy * pc[:, 1] / zs + cy - 0.5], -1)
    if m2d_off is not None:
        mean2d = mean2d + m2d_off
    # EWA: cov2d = J W Sigma W^T J^T + 0.3 I, J at the clamped position
    tanx, tany = W / (2 * fx), H / (2 * fy)
    u = (pc[:, 0] / zs).clamp(-1.3 * tanx, 1.3 * tanx)
    v = (pc[:, 1] / zs).clamp(-1.3 * tany, 1.3 * tany)
    zero = torch.zeros_like(zs)
    J = torch.stack([torch.stack([fx / zs, zero, -fx * u / zs], -1),
                     torch.stack([zero, fy / zs, -fy * v / zs], -1)], -2)  # [C, 2, 3]
    M = g["rots"] * g["scales"][:, None, :]
    T = mm(mm(J, Rw), M)
    cov = mm(T, T.transpose(1, 2)) + LOWPASS * torch.eye(2, device=dev)
    a, b, c = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    det = a * c - b * b
    ok_det = det != 0
    inv = 1.0 / torch.where(ok_det, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt((mid * mid - det).clamp(min=0.1))
    r3 = 3.0 * torch.sqrt(lam.clamp(min=0.0))
    op = g["opacity"]
    q = (2.0 * torch.log((255.0 * op).clamp(min=1e-12))).clamp(min=0.0)
    hx = torch.minimum(r3, torch.sqrt(q * a.clamp(min=0.0))) + 0.01
    hy = torch.minimum(r3, torch.sqrt(q * c.clamp(min=0.0))) + 0.01
    gx, gy = -(-W // TILE), -(-H // TILE)

    def tile(v, n):
        return torch.nan_to_num(v, nan=0.0).clamp(0.0, float(n)).to(torch.int64)

    with torch.no_grad():
        rmin = torch.stack([tile((mean2d[:, 0] - hx) / TILE, gx), tile((mean2d[:, 1] - hy) / TILE, gy)], -1)
        rmax = torch.stack([tile((mean2d[:, 0] + hx + TILE - 1) / TILE, gx),
                            tile((mean2d[:, 1] + hy + TILE - 1) / TILE, gy)], -1)
        touched = (rmax - rmin).prod(-1)
        valid = in_front & ok_det & (touched > 0) & g["visible"]
    # SH degree 1 along the camera -> mean direction, + 0.5, >= 0
    d = g["means"] - centre
    d = d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    rgb = (SH_C0 * g["dc"] - SH_C1 * d[:, 1:2] * feat_rest[:, 0] + SH_C1 * d[:, 2:3] * feat_rest[:, 1]
           - SH_C1 * d[:, 0:1] * feat_rest[:, 2] + 0.5).clamp(min=0.0)
    radius = torch.where(valid, torch.ceil(r3.detach()), torch.zeros_like(r3.detach()))
    return dict(mean2d=mean2d, conic=conic, depth=z, rgb=rgb, opacity=op, valid=valid, rmin=rmin, rmax=rmax,
                touched=torch.where(valid, touched, 0), grid=(gx, gy), radius=radius)


@torch.no_grad()
def instances(s):
    """Every (Gaussian, tile) pair of the valid Gaussians' rects that the
    Gaussian's alpha can reach 1/255 in, ordered by tile, then depth, then
    row: (gaussian [S], tile [S], run start per tile [T + 1],
    generated pairs before the cut)."""
    dev = s["depth"].device
    gx, gy = s["grid"]
    cnt = s["touched"]
    total = int(cnt.sum())
    gid = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(total, device=dev) - first[gid]
    w = (s["rmax"][gid, 0] - s["rmin"][gid, 0]).clamp(min=1)
    tx = s["rmin"][gid, 0] + k % w
    ty = s["rmin"][gid, 1] + k // w
    # the pair's alpha stays under 1/255 outside the ellipse of radius^2
    # 2 ln(255 op) / lambda_min around the mean (a relative margin 1e-4)
    ca, cb, cc = s["conic"].unbind(-1)
    lam_min = (0.5 * (ca + cc) - torch.sqrt((0.25 * (ca - cc) ** 2 + cb * cb).clamp(min=0.0))) * (1 - 1e-5)
    op = s["opacity"]
    r2 = torch.where(op >= ALPHA_MIN,
                     torch.where(lam_min > 0,
                                 (2.0 * torch.log(op.clamp(min=ALPHA_MIN) * 255.0) / lam_min.clamp(min=1e-30)
                                  * (1 + 1e-4) + 1e-6).clamp(max=1e30),
                                 torch.full_like(op, 1e30)),
                     torch.full_like(op, -1.0))
    m = s["mean2d"]
    px0, py0 = tx.float() * TILE, ty.float() * TILE
    dx = torch.minimum(torch.maximum(m[gid, 0], px0), px0 + TILE - 1) - m[gid, 0]
    dy = torch.minimum(torch.maximum(m[gid, 1], py0), py0 + TILE - 1) - m[gid, 1]
    keep = dx * dx + dy * dy <= r2[gid]
    gid, tid = gid[keep], (ty * gx + tx)[keep]
    # depth order (ties by row), then a stable sort by tile
    order = torch.sort(s["depth"][gid], stable=True).indices
    gid, tid = gid[order], tid[order]
    order = torch.sort(tid, stable=True).indices
    gid, tid = gid[order], tid[order]
    starts = torch.searchsorted(tid, torch.arange(gx * gy + 1, device=dev))
    return gid, tid, starts, total


class _AbsTap(torch.autograd.Function):
    """Identity on a block's per-pair offsets [n, 256] of one mean2d
    coordinate; its backward adds each pair's |gradient| summed over the
    tile's pixels into sink[rows, col] (AbsGS's per-pixel absolute
    gradient) and passes the gradient on unchanged."""

    @staticmethod
    def forward(ctx, d, sink, rows, col):
        ctx.sink, ctx.rows, ctx.col = sink, rows, col
        return d.view_as(d)

    @staticmethod
    def backward(ctx, grad):
        ctx.sink.select(1, ctx.col).index_add_(0, ctx.rows, grad.abs().sum(1).double())
        return grad, None, None, None


def _blend_block(mx, my, ca, cb, cc, op, feat, px, py, first, begins, ends, tap=None):
    """Composite one block of tiles' runs. Per instance i and pixel p of
    its tile: alpha, the run's transmittance before i (exp of the sum of
    log(1 - alpha) of the instances before it), i blended while the
    transmittance after it stays >= 1e-4 (past that the pixel is done).
    first: each instance's run start; begins, ends: each run's rows.
    tap: (sink [C, 2], rows [n]) to collect the per-pixel absolute mean
    gradient (_AbsTap). Returns per run [R, 256, F + 1] (the blended
    features, the log of the final transmittance) and the evaluated and
    blended pair counts."""
    dx = mx[:, None] - px
    dy = my[:, None] - py
    if tap is not None:
        dx = _AbsTap.apply(dx, tap[0], tap[1], 0)
        dy = _AbsTap.apply(dy, tap[0], tap[1], 1)
    power = -0.5 * (ca[:, None] * dx * dx + cc[:, None] * dy * dy) - cb[:, None] * dx * dy
    alpha = (op[:, None] * torch.exp(power.clamp(max=0.0))).clamp(max=ALPHA_MAX)
    active = (power <= 0) & (alpha >= ALPHA_MIN)
    a = torch.where(active, alpha, torch.zeros_like(alpha))
    logs = torch.log1p(-a).double()
    cs = torch.cumsum(logs, 0)
    incl = cs - (cs - logs)[first]
    excl = incl - logs
    blended = active & (incl >= LOG_T_MIN)
    w = torch.where(blended, a.double() * torch.exp(excl), torch.zeros_like(excl))
    contrib = torch.cat([w[:, :, None] * feat.double()[:, None, :],
                         torch.where(blended, logs, torch.zeros_like(logs))[:, :, None]], -1)
    cum0 = torch.cat([torch.zeros_like(contrib[:1]), torch.cumsum(contrib, 0)])
    runs = (cum0[ends] - cum0[begins]).float()
    return runs, (excl >= LOG_T_MIN).sum(), blended.sum()


def rasterize(s, features: torch.Tensor, bg: torch.Tensor, count: bool = False, abs_sink=None):
    """Composite the valid Gaussians over the image: {"features" [H, W,
    F], "T" [H, W]} and, with count, the evaluated and blended pairs.
    abs_sink: [C, 2] float64 zeros that the backward fills with each
    Gaussian's per-pixel absolute mean2d gradient, summed."""
    dev = features.device
    H, W = s["grid"][1] * TILE, s["grid"][0] * TILE
    gid, tid, starts, total = instances(s)
    T_tiles = starts.shape[0] - 1
    F = features.shape[1]
    out = torch.zeros((T_tiles, PIX, F + 1), device=dev)
    out[:, :, F] = 1.0
    lengths = (starts[1:] - starts[:-1]).cpu()
    counts = {"evaluated": 0, "blended": 0, "instances_generated": total, "instances": int(gid.shape[0]),
              "tiles": T_tiles}
    # blocks of whole tiles, about BLOCK instances each
    cum = torch.cumsum(lengths, 0)
    t0 = 0
    blocks = []
    while t0 < T_tiles:
        lim = (cum[t0 - 1] if t0 else 0) + BLOCK
        t1 = max(t0 + 1, int(torch.searchsorted(cum, torch.as_tensor(lim), right=True)))
        t1 = min(t1, T_tiles)
        blocks.append((t0, t1))
        t0 = t1
    m2, co, op, dp = s["mean2d"], s["conic"], s["opacity"], features
    pix = torch.arange(PIX, device=dev)
    pieces = []
    for t0, t1 in blocks:
        i0, i1 = int(starts[t0]), int(starts[t1])
        if i1 == i0:
            continue
        g = gid[i0:i1]
        tl = tid[i0:i1]
        px = ((tl % s["grid"][0]) * TILE)[:, None] + (pix % TILE)[None, :]
        py = ((tl // s["grid"][0]) * TILE)[:, None] + (pix // TILE)[None, :]
        first = starts[tl] - i0  # each instance's run start within the block
        ends = starts[t0 + 1:t1 + 1] - i0  # exclusive run ends per tile
        begins = starts[t0:t1] - i0

        tap = None if abs_sink is None else (abs_sink, g)

        def block(mx, my, ca, cb, cc, o, f, px=px.float(), py=py.float(), first=first, begins=begins, ends=ends,
                  tap=tap):
            return _blend_block(mx, my, ca, cb, cc, o, f, px, py, first, begins, ends, tap)

        args = (m2[g, 0], m2[g, 1], co[g, 0], co[g, 1], co[g, 2], op[g], dp[g])
        if torch.is_grad_enabled():
            runs, n_eval, n_blend = checkpoint(block, *args, use_reentrant=False)
        else:
            runs, n_eval, n_blend = block(*args)
        if count:
            counts["evaluated"] += int(n_eval)
            counts["blended"] += int(n_blend)
        feat = runs[:, :, :F]
        Tr = torch.exp(runs[:, :, F])
        pieces.append((t0, t1, torch.cat([feat, Tr[:, :, None]], -1)))
    if pieces:
        idx = torch.cat([torch.arange(a, b, device=dev) for a, b, _ in pieces])
        vals = torch.cat([v for _, _, v in pieces])
        out = out.index_put((idx,), vals)
    gx, gy = s["grid"]
    img = out.reshape(gy, gx, TILE, TILE, F + 1).permute(0, 2, 1, 3, 4).reshape(H, W, F + 1)
    return img, counts


def sky_rays(scene, view, jitter: Optional[torch.Tensor], device):
    """Unit world directions [H, W, 3] through the pixel centres (+ the
    train-time jitter)."""
    H, W = scene.H, scene.W
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    if jitter is not None:
        xs = xs + jitter[..., 0]
        ys = ys + jitter[..., 1]
    K = torch.tensor(scene.K, dtype=torch.float32, device=device)
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], -1)
    d = mm(pix, torch.linalg.inv(K).T)
    Rc2w = torch.tensor(view.w2c[:3, :3], dtype=torch.float32, device=device).T
    d = mm(d, Rc2w.T)
    return d / d.norm(dim=-1, keepdim=True)


def sample_sky(cubemap: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of a [3, 6 R R] cubemap in directions d [..., 3]
    (nvdiffrast's faces: +x (1, -v, -u), -x (-1, -v, u), +y (u, 1, v),
    -y (u, -1, -v), +z (u, -v, 1), -z (-u, -v, -1)); the taps are
    texel floor(p) clamped to the face and the next one clamped,
    clamped to [0, 1]."""
    R = int(round(math.sqrt(cubemap.shape[1] // 6)))
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    isx = (ax >= ay) & (ax >= az)
    isy = ~isx & (ay >= az)
    face = torch.where(isx, torch.where(x > 0, 0, 1), torch.where(isy, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    major = torch.where(isx, ax, torch.where(isy, ay, az)).clamp(min=1e-12)
    u = torch.where(isx, torch.where(x > 0, -z, z), torch.where(isy, x, torch.where(z > 0, x, -x))) / major
    v = torch.where(isx, -y, torch.where(isy, torch.where(y > 0, z, -z), -y)) / major
    px = (u + 1) * 0.5 * R - 0.5
    py = (v + 1) * 0.5 * R - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    xi0 = x0.long().clamp(0, R - 1)
    yi0 = y0.long().clamp(0, R - 1)
    xi1 = (xi0 + 1).clamp(max=R - 1)
    yi1 = (yi0 + 1).clamp(max=R - 1)
    base = face.long() * R * R
    cm = cubemap.t()  # [T, 3]

    def tap(yi, xi):
        return cm[(base + yi * R + xi).reshape(-1)].reshape(*d.shape[:-1], 3)

    w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1)  # [..., 4]
    taps = torch.stack([tap(yi0, xi0), tap(yi0, xi1), tap(yi1, xi0), tap(yi1, xi1)], -2)  # [..., 4, 3]
    # the weighted taps summed per channel: a product with a 0/1 [12, 3]
    weighted = (w[..., None] * taps).reshape(-1, 12)
    collapse = (torch.arange(12, device=d.device)[:, None] % 3 == torch.arange(3, device=d.device)[None, :]).float()
    out = mm(weighted, collapse).reshape(*d.shape[:-1], 3)
    return out.clamp(0.0, 1.0)


def render(scene, p: Dict[str, torch.Tensor], view, *, train: bool, flip=None, jitter=None,
           models=None, with_sky: bool = True, white_background: bool = False, count: bool = False,
           alive=None, m2d_off=None, abs_sink=None):
    """One view: {"rgb", "depth", "acc", "T", "radius"} [H, W(, 3)], [C]
    and, with count, the blend's pair counts. m2d_off, abs_sink: the
    densification statistics' taps (project, rasterize)."""
    g = compose(scene, p, view, flip if train else None, models, alive)
    s = project(scene, g, p["gaussians.feat_rest"], view, m2d_off)
    dev = s["depth"].device
    feats = torch.cat([s["rgb"], s["depth"][:, None]], -1)
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    img, counts = rasterize(s, feats, bg, count=count, abs_sink=abs_sink)
    img = img[: scene.H, : scene.W]
    Tr = img[..., 4]
    rgb = img[..., :3] + Tr[..., None] * bg
    if with_sky and "sky.cubemap" in p:
        sky = sample_sky(p["sky.cubemap"], sky_rays(scene, view, jitter if train else None, dev))
        rgb = rgb + sky * Tr[..., None]
    if not train:
        rgb = rgb.clamp(0.0, 1.0)
    out = {"rgb": rgb, "depth": img[..., 3], "acc": 1.0 - Tr, "T": Tr, "radius": s["radius"]}
    if count:
        out["counts"] = counts
        out["alive_rows"] = int(g["visible"].sum())
    return out

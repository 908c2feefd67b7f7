"""Port parity for the per-Gaussian math: SH, quaternions, camera and
rays, actor poses, and preprocess_gaussians, each against the JAX
package's function on the same numpy inputs.

Tolerance: rtol = 1e-5, atol = 1e-6 unless stated. Both compute in f32;
they differ by the order of f32 sums inside small matrix products (a
few ulp). Integer tile rects must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_torch.models import actor_pose as tpose
from street_gaussians_torch.ops import preprocess as tpre
from street_gaussians_torch.utils import camera as tcam
from street_gaussians_torch.utils import knn as tknn
from street_gaussians_torch.utils import quaternion as tq
from street_gaussians_torch.utils import sh as tsh
from street_gaussians_tpu.models import actor_pose as jpose
from street_gaussians_tpu.ops import preprocess as jpre
from street_gaussians_tpu.utils import camera as jcam
from street_gaussians_tpu.utils import knn as jknn
from street_gaussians_tpu.utils import quaternion as jq
from street_gaussians_tpu.utils import sh as jsh

TOL = dict(rtol=1e-5, atol=1e-6)


def close(got, want, **tol):
    np.testing.assert_allclose(
        np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), **(tol or TOL)
    )


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_sh_basis_and_time_basis(rng):
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for deg in range(4):
        close(tsh.sh_basis(deg, T(dirs)), jsh.sh_basis(deg, jnp.asarray(dirs)))
    t = rng.uniform(0, 1, 17).astype(np.float32)
    close(tsh.idft_basis(T(t), 5), jsh.idft_basis(jnp.asarray(t), 5))
    rgb = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(T(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))


def test_quaternion_ops(rng):
    a = rng.normal(size=(32, 4)).astype(np.float32)
    b = rng.normal(size=(32, 4)).astype(np.float32)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (32, 1)).astype(np.float32)
    s = np.exp(rng.normal(size=(32, 3))).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    na = jq.quat_normalize(ja)
    close(tq.quat_normalize(T(a)), na)
    close(tq.quat_multiply(T(a), T(b)), jq.quat_multiply(ja, jb))
    close(tq.quat_rotate(T(np.asarray(na)), T(v)), jq.quat_rotate(na, jnp.asarray(v)))
    close(tq.quat_to_rotmat(T(np.asarray(na))), jq.quat_to_rotmat(na))
    close(tq.quat_slerp(T(a), T(b), T(t)), jq.quat_slerp(ja, jb, jnp.asarray(t)), atol=1e-5)
    # nearly parallel pair: the lerp branch
    close(tq.quat_slerp(T(a), T(a * 1.0000001), T(t)), jq.quat_slerp(ja, ja * 1.0000001, jnp.asarray(t)))
    close(tq.build_scaling_rotation(T(s), T(a)), jq.build_scaling_rotation(jnp.asarray(s), ja))


def _camera_pair(H=40, W=72):
    K = np.array([[60.0, 0, W / 2 + 1.5], [0, 64.0, H / 2 - 2.0], [0, 0, 1]], np.float32)
    ang = 0.3
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    w2c[:3, 3] = [0.2, -0.1, 0.5]
    return tcam.make_camera(K, w2c, H, W, frame=3, image_id=5, device="cpu"), jcam.make_camera(
        K, w2c, H, W, frame=3, image_id=5
    )


@pytest.mark.parametrize("downsample", [1, 2])
def test_camera_and_rays(downsample):
    tc, jc = _camera_pair(H=41)  # odd height: the last half-res row overhangs
    for name in ("w2c", "proj", "cam_center", "K", "full_proj", "tan_fovx", "tan_fovy",
                 "focal_x", "focal_y"):
        close(getattr(tc, name), getattr(jc, name))
    assert (tc.H, tc.W, tc.frame, tc.image_id) == (jc.H, jc.W, int(jc.frame), int(jc.image_id))
    close(tcam.camera_rays(tc, downsample=downsample), jcam.camera_rays(jc, downsample=downsample))


def test_actor_poses_and_interp_table(rng):
    F, O, A = 6, 3, 2
    tracklets = np.zeros((F, O, 8), np.float32)
    tracklets[..., 0] = -1
    ts = np.linspace(0, 1, F).astype(np.float32)
    for a in range(A):
        for f in range(F):
            q = rng.normal(size=4)
            tracklets[f, a] = [10 + a, *rng.normal(size=3), *(q / np.linalg.norm(q))]
    ego_q = np.array([0.9, 0.1, -0.2, 0.3], np.float32)
    ego_q /= np.linalg.norm(ego_q)
    ego_R = np.asarray(jq.quat_to_rotmat(jnp.asarray(ego_q)))
    ego_t = np.array([1.0, -2.0, 0.5], np.float32)
    for is_val in (False, True):
        kw = dict(actor_track_ids=[10, 11], timestamp=0.37, is_val=is_val,
                  train_timestamps_in_range=lambda tid: ts[::2], opt_track=True)
        ji = jpose.build_interp_table(tracklets, ts, **kw)
        ti = tpose.build_interp_table(tracklets, ts, device="cpu", **kw)
        jd, jp = jpose.init_actor_pose(tracklets)
        td, tp = tpose.init_actor_pose(tracklets, device="cpu")
        res_t = rng.normal(size=(F, O, 3)).astype(np.float32) * 0.1
        res_r = rng.normal(size=(F, O, 1)).astype(np.float32) * 0.1
        jp = jpose.ActorPoseParams(opt_trans=jnp.asarray(res_t), opt_rots=jnp.asarray(res_r))
        tp = tpose.ActorPoseParams(opt_trans=T(res_t), opt_rots=T(res_r))
        jout = jpose.actor_poses(jd, jp, ji, jnp.asarray(ego_q), jnp.asarray(ego_R), jnp.asarray(ego_t))
        tout = tpose.actor_poses(td, tp, ti, T(ego_q), T(ego_R), T(ego_t))
        for g, w in zip(tout, jout):
            close(g, w, atol=1e-5)


def test_initial_log_scales(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    close(tknn.initial_log_scales(pts), jknn.initial_log_scales(pts), rtol=1e-5, atol=1e-5)


def test_cov3d(rng):
    s = np.exp(rng.normal(size=(50, 3))).astype(np.float32)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    close(tpre.compute_cov3d(T(s), T(q), 1.3), jpre.compute_cov3d(jnp.asarray(s), jnp.asarray(q), 1.3))


@pytest.mark.parametrize("max_tiles", [None, 4])
def test_preprocess_matches_jax(rng, max_tiles):
    """Includes one Gaussian far off-screen (its rect clamps), one
    behind the near plane and one huge one covering the image."""
    tc, jc = _camera_pair()
    n = 200
    xyz = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(0.5, 10, n)], -1
    ).astype(np.float32)
    xyz[0] = [400.0, -300.0, 2.0]  # far off-screen: mean2d ~ 1e4 px away
    xyz[1] = [0.0, 0.0, -1.0]  # behind the near plane
    xyz[2] = [0.0, 0.0, 3.0]
    scales = np.exp(rng.uniform(-4, -1, (n, 3))).astype(np.float32)
    scales[2] = 5.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.01, 0.99, n).astype(np.float32)
    shs = rng.normal(size=(n, 16, 3)).astype(np.float32) * 0.3
    alive = rng.uniform(size=n) < 0.9
    alive[:3] = True
    args = (xyz, scales, quats, op, shs)
    common = dict(H=tc.H, W=tc.W, sh_degree=3, alive=None, max_tiles_per_gaussian=max_tiles)
    want = jpre.preprocess_gaussians(
        *[jnp.asarray(a) for a in args], jc.w2c, jc.full_proj, jc.cam_center,
        focal_x=jc.focal_x, focal_y=jc.focal_y, tan_fovx=jc.tan_fovx, tan_fovy=jc.tan_fovy,
        **{**common, "alive": jnp.asarray(alive)},
    )
    got = tpre.preprocess_gaussians(
        *[T(a) for a in args], tc.w2c, tc.full_proj, tc.cam_center,
        focal_x=tc.focal_x, focal_y=tc.focal_y, tan_fovx=tc.tan_fovx, tan_fovy=tc.tan_fovy,
        **{**common, "alive": T(alive)},
    )
    assert abs(float(want.mean2d[0, 0])) > 1e3 and not bool(want.valid[1])
    for name in ("rect_min", "rect_max", "tiles_touched", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    for name in ("mean2d", "depth", "radius", "rgb", "opacity"):
        close(getattr(got, name), getattr(want, name), rtol=1e-5, atol=1e-4)
    # the conic scales as 1/cov: compare relative to each row's magnitude
    gc, wc = got.conic.numpy(), np.asarray(want.conic)
    scale = np.abs(wc).max(axis=1, keepdims=True) + 1e-12
    np.testing.assert_allclose(gc / scale, wc / scale, atol=1e-5)

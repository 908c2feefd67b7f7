"""Port parity for the whole serving slice: render_frame in eval mode
(compose -> preprocess -> binning -> payload -> tile blend -> sky) on
the JAX package's scenes carried across with convert.scene_from_numpy,
against the JAX render_frame (Pallas in interpret mode).

Tolerance: rtol = atol = 1e-5 on rgb, depth, acc and T. Both paths are
f32 with the same operations; they differ by the order of f32 sums
(small matrix products, the blend's prefix sums), a few ulp of values up
to the depth's ~10. Integer diagnostics (instance count, overflow)
must be equal.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from street_gaussians_torch import serve
from street_gaussians_torch.convert import frame_from_numpy, scene_from_numpy
from street_gaussians_torch.data import synthetic as tsyn
from street_gaussians_torch.models import renderer as trend
from street_gaussians_torch.models.sky_cubemap import build_sky_table
from street_gaussians_torch.ops.sh_color import sh_table
from street_gaussians_torch.utils import trace
from street_gaussians_tpu.data.synthetic import make_synthetic_scene
from street_gaussians_tpu.models import renderer as jrend
from street_gaussians_tpu.models.sky_cubemap import SkyParams

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def numpy_tree(obj):
    """A JAX dataclass as nested dicts of numpy arrays / Python values."""
    if obj is None or isinstance(obj, (bool, int, float, str, list)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def carry(scene, params, frame):
    p, aux, table, pose = scene_from_numpy(
        numpy_tree(params), numpy_tree(scene.aux), numpy_tree(scene.table),
        numpy_tree(scene.pose_data), "cpu",
    )
    return p, aux, table, pose, frame_from_numpy(numpy_tree(frame), "cpu")


def port_opts(jopts, **kw):
    fields = {f.name for f in dataclasses.fields(trend.RenderOptions)}
    return trend.RenderOptions(
        **{k: v for k, v in dataclasses.asdict(jopts).items() if k in fields}, **kw
    )


def assert_same_render(got, want):
    for k in ("rgb", "depth", "acc", "T", "radii"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    for k in ("num_instances", "overflow", "overflow_instance", "overflow_tile"):
        assert int(got[k]) == int(want[k]), k


def test_toy_entry_render_matches_jax():
    """__graft_entry__.entry()'s composite forward (32x48, 1 actor, sky)."""
    scene, params, opts = graft._toy_setup()
    frame = scene.frames[2]
    want = jrend.render_frame(
        params, scene.aux, scene.table, scene.pose_data, frame, step=jnp.asarray(0), opts=opts
    )
    p, aux, table, pose, f = carry(scene, params, frame)
    got = trend.render_frame(p, aux, table, pose, f, 0, opts=port_opts(opts))
    assert_same_render(got, want)
    assert int(want["num_instances"]) > 0


@pytest.fixture(scope="module")
def sky_scene():
    """64x96, 2 actors, a random 16-texel sky cubemap."""
    scene = make_synthetic_scene(num_bkgd=300, num_actors=2, H=64, W=96, seed=3, round_to=128)
    rng = np.random.default_rng(4)
    params = jrend.SceneParams(
        gaussians=scene.params_init,
        actor_pose=scene.pose_params_init,
        sky=SkyParams(cubemap=jnp.asarray(rng.uniform(0, 1, (3, 6 * 16 * 16)).astype(np.float32))),
        color_correction=None,
        pose_correction=None,
    )
    return scene, params


@pytest.mark.parametrize("sky_downsample", [1, 2])
def test_sky_scene_render_matches_jax(sky_scene, sky_downsample):
    """Eval render at full SH degree, with and without a prebuilt sky
    table (the JAX table path is bit-identical to its default path)."""
    scene, params = sky_scene
    frame = scene.frames[5]
    jopts = jrend.RenderOptions(
        mode="eval", tile_capacity=256, instance_capacity=2**14,
        interpret=True, sky_downsample=sky_downsample,
    )
    want = jrend.render_frame(
        params, scene.aux, scene.table, scene.pose_data, frame,
        step=jnp.asarray(10**9), opts=jopts,
    )
    p, aux, table, pose, f = carry(scene, params, frame)
    opts = port_opts(jopts)
    got = trend.render_frame(p, aux, table, pose, f, 10**9, opts=opts)
    assert_same_render(got, want)
    port_scene = types.SimpleNamespace(aux=aux, table=table, pose_data=pose)
    (served,) = serve.render_views(
        port_scene, p, [f], opts, device="cpu", sky_table=build_sky_table(p.sky.cubemap)
    )
    assert_same_render(served, want)
    # the sky shows through: some pixels are mostly transmittance
    assert float(np.asarray(want["T"]).max()) > 0.5


def test_synthetic_scene_matches_jax():
    """Same seed, same scene: the port's numpy draws follow the JAX
    package's. log_scale may come from a native 3-NN on the JAX side
    (float32 distances), hence its tolerance."""
    kw = dict(num_bkgd=200, num_actors=2, H=32, W=48, seed=7, round_to=128)
    jscene = make_synthetic_scene(**kw)
    tscene = tsyn.make_synthetic_scene(device="cpu", **kw)
    jg = numpy_tree(jscene.params_init)
    for f in dataclasses.fields(tscene.params_init):
        got = getattr(tscene.params_init, f.name).numpy()
        tol = dict(rtol=1e-5, atol=1e-6) if f.name == "log_scale" else dict(rtol=0, atol=0)
        np.testing.assert_allclose(got, jg[f.name], err_msg=f.name, **tol)
    np.testing.assert_array_equal(tscene.aux.model_id.numpy(), np.asarray(jscene.aux.model_id))
    assert tscene.table.names == jscene.table.names
    np.testing.assert_array_equal(tscene.tracklets, jscene.tracklets)
    for tf, jf in zip(tscene.frames, jscene.frames):
        np.testing.assert_allclose(tf.cam.w2c.numpy(), np.asarray(jf.cam.w2c), rtol=0, atol=0)
        np.testing.assert_array_equal(tf.interp.frame_idx.numpy(), np.asarray(jf.interp.frame_idx))


def test_compose_with_corrections_and_sky_model_matches_jax():
    """compose_frame with pose correction and a sky-as-Gaussians model,
    and the color correction, against the JAX package (no blend here)."""
    from street_gaussians_torch.models.corrections import apply_color_correction
    from street_gaussians_tpu.models import corrections as jcorr

    rng = np.random.default_rng(5)
    sky_pts = rng.normal(size=(40, 3)).astype(np.float32) * 10.0
    scene = make_synthetic_scene(
        num_bkgd=100, num_actors=2, H=32, W=48, seed=5, round_to=128,
        sky_points=sky_pts, sky_colors=rng.uniform(0, 1, (40, 3)).astype(np.float32),
    )
    n_img = len(scene.frames)
    q = rng.normal(size=(n_img, 4)).astype(np.float32)
    params = jrend.SceneParams(
        gaussians=scene.params_init,
        actor_pose=scene.pose_params_init,
        sky=None,
        color_correction=jcorr.ColorCorrectionParams(
            affine=jnp.asarray(rng.normal(size=(n_img, 3, 4)).astype(np.float32)),
            affine_sky=jnp.asarray(rng.normal(size=(n_img, 3, 4)).astype(np.float32)),
        ),
        pose_correction=jcorr.PoseCorrectionParams(
            trans=jnp.asarray(rng.normal(size=(n_img, 3)).astype(np.float32) * 0.1),
            rots=jnp.asarray(q),
        ),
    )
    frame = scene.frames[3]
    want = jrend.compose_frame(
        params, scene.aux, scene.table, scene.pose_data, frame, jnp.asarray(2500),
        opts=jrend.RenderOptions(mode="eval"),
    )
    p, aux, table, pose, f = carry(scene, params, frame)
    assert table.sky_model == len(table.names) - 1
    got = trend.compose_frame(p, aux, table, pose, f, 2500, opts=trend.RenderOptions(mode="eval"))
    # the port's compose hands the SH colour its inputs; their table is the JAX package's shs
    got["shs"] = sh_table(*got["sh"])
    for k in ("means3d", "scales", "quats", "opacity", "shs", "visible"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    rgb = rng.uniform(0, 1, (8, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(
        apply_color_correction(p.color_correction, f.cam.image_id, torch.as_tensor(rgb)).numpy(),
        np.asarray(jcorr.apply_color_correction(params.color_correction, frame.cam.image_id, jnp.asarray(rgb))),
        **TOL,
    )


def test_render_views_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tsyn.make_synthetic_scene(num_bkgd=50, num_actors=1, H=32, W=48, device="cpu")
    params = trend.SceneParams(scene.params_init, scene.pose_params_init, None, None, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.render_views(scene, params, scene.frames[:1], serve.SERVE_OPTS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsyn.make_synthetic_scene(num_bkgd=50)


def test_trace_summary_counts_busy_time_and_stages(tmp_path):
    """utils.trace.trace_summary on a hand-made Chrome trace: overlapping
    kernels count once, stage spans collect the kernels inside them, and
    a host range collects the kernels launched while it was open."""
    events = [
        {"cat": "kernel", "name": "k1", "ts": 0.0, "dur": 100.0, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k2", "ts": 50.0, "dur": 100.0, "args": {"correlation": 2}},  # overlaps k1
        {"cat": "gpu_memset", "name": "set", "ts": 300.0, "dur": 50.0},
        {"cat": "gpu_user_annotation", "name": "binning", "ts": 0.0, "dur": 160.0},
        {"cat": "user_annotation", "name": "binning", "ts": -20.0, "dur": 40.0},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 10.0, "dur": 5.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": -10.0, "dur": 1.0, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30.0, "dur": 1.0, "args": {"correlation": 2}},
        {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 1.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace.trace_summary(str(path), wall_ms=1.0, views=2)
    assert got["device_busy_ms"] == pytest.approx(0.2)
    assert got["idle_share"] == pytest.approx(0.8)
    b = got["per_view"]["binning"]
    assert b == pytest.approx(dict(span_ms=0.08, kernel_ms=0.1, kernels=1.0, launched_kernel_ms=0.05,
                                   launched_kernels=0.5, host_ms=0.02, host_syncs=0.5))
    assert got["per_view"]["sky"]["kernels"] == 0
    assert [k["name"] for k in got["top_kernels_per_view"]] == ["k1", "k2", "set"]


def test_trace_stats_totals_per_step(tmp_path):
    """utils.trace.trace_stats (script.trace_stats' numbers) on a
    hand-made trace of 2 steps: busy time as the union of device
    intervals, every kernel and host sync counted, and the named
    kernels' time and launches."""
    events = [
        {"cat": "kernel", "name": "segsum_tiles_kernel(float*)", "ts": 0.0, "dur": 100.0},
        {"cat": "kernel", "name": "segsum_fixup_kernel(float*)", "ts": 50.0, "dur": 100.0},
        {"cat": "kernel", "name": "expand_runs_kernel(float*)", "ts": 400.0, "dur": 20.0},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 300.0, "dur": 50.0},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 10.0, "dur": 5.0},
        {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 20.0, "dur": 5.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30.0, "dur": 1.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace.trace_stats(str(path), 2, ["segsum", "expand_runs", "absent"])
    assert got["busy_ms"] == pytest.approx(0.11)
    assert (got["kernels"], got["host_syncs"]) == (1.5, 1.0)
    assert got["named"]["segsum"] == pytest.approx({"ms": 0.1, "launches": 1.0})
    assert got["named"]["expand_runs"] == pytest.approx({"ms": 0.01, "launches": 0.5})
    assert got["named"]["absent"] == {"ms": 0.0, "launches": 0.0}


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports with jax,
    jaxlib, yaml and street_gaussians_tpu made unimportable, and loads
    none of them (the card's machine has no JAX and no PyYAML)."""
    code = (
        "import sys, importlib.abc, pkgutil, importlib\n"
        "BLOCKED = ('jax', 'jaxlib', 'yaml', 'street_gaussians_tpu')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import street_gaussians_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'street_gaussians_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr
    imported = set(r.stdout.split())
    for mod in ("train_lib", "train", "config", "optim.adam", "optim.densify", "optim.schedule",
                "ops.segsum", "utils.losses"):
        assert f"street_gaussians_torch.{mod}" in imported, mod

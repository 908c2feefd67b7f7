"""The port's SIBR viewer bridge (street_gaussians_torch/network_gui.py and
runner.ViewerBridge) against the JAX package's (network_gui.py,
runner.ViewerBridge): the protocol round trip on an ephemeral port,
camera_from_message within 1e-6 of JAX's on three messages (and None at
resolution 0), the bridge's frame equal bit for bit to the port's own
render_frame of that camera on a small Waymo-format sequence, a client
that drops mid-message returning control from poll (the port's and
JAX's), and runner.training with viewer.enabled, without a client and
with one that takes two frames and drops. Every socket call of the test
clients has a timeout and none is retried."""

import json
import math
import dataclasses
import queue
import socket
import threading

import numpy as np
import pytest
import torch

from street_gaussians_torch import network_gui as tgui
from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.data.synthetic_waymo import write_synthetic_waymo
from street_gaussians_torch.models.renderer import render_frame
from street_gaussians_torch.train_lib import init_train_state

TIMEOUT = 20.0  # seconds, every socket call and thread join


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tiny tensors (as
    tests/test_torch_runner.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def message(H, W, w2c=None, fov_x=60.0, fov_y=40.0, train=True, keep_alive=False):
    """A SIBR camera message: the TRANSPOSED world->view matrix with its
    y/z columns negated (ref: lib/models/network_gui.py:73-76)."""
    if w2c is None:
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = 4.0
    wvt = np.asarray(w2c, np.float32).T.copy()
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    return {"resolution_x": W, "resolution_y": H, "fov_x": math.radians(fov_x), "fov_y": math.radians(fov_y),
            "z_near": 0.01, "z_far": 100.0, "train": train, "keep_alive": keep_alive, "scaling_modifier": 1.0,
            "view_matrix": wvt.reshape(-1).tolist(),
            "view_projection_matrix": np.eye(4, dtype=np.float32).reshape(-1).tolist()}


def send_json(sock, obj):
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(len(data).to_bytes(4, "little") + data)


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def recv_frame(sock, H, W):
    img = recv_exact(sock, H * W * 3)
    n = int.from_bytes(recv_exact(sock, 4), "little")
    return img, recv_exact(sock, n)


def connect(port):
    return socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)


def test_protocol_roundtrip():
    gui = tgui.NetworkGUI("127.0.0.1", 0)
    H, W = 24, 32
    client = connect(gui.port)
    try:
        assert gui.port > 0 and gui.try_connect()
        gui.conn.settimeout(TIMEOUT)
        send_json(client, message(H, W))
        cam, do_training, keep_alive, scaling = gui.receive(device="cpu")
        assert cam is not None and (cam.H, cam.W) == (H, W)
        assert do_training is True and keep_alive is False and abs(scaling - 1.0) < 1e-6
        np.testing.assert_allclose(cam.cam_center.numpy(), [0.0, 0.0, -4.0], atol=1e-5)
        rgb = torch.zeros(H, W, 3)
        rgb[..., 0] = 0.5
        rgb[0, 0, 1] = 1.7  # clipped to 255
        gui.send_image(rgb, verify="ok")
        img, verify = recv_frame(client, H, W)
        img = np.frombuffer(img, np.uint8).reshape(H, W, 3)
        assert img[..., 0].min() == img[..., 0].max() == 127 and img[0, 0, 1] == 255 and verify == b"ok"
        gui.send(None, "again")
        n = int.from_bytes(recv_exact(client, 4), "little")
        assert recv_exact(client, n) == b"again"
    finally:
        client.close()
        gui.close()
    assert gui.conn is None and gui.listener is None


def test_frame_bytes_tensor_equals_numpy():
    """A tensor is clipped, scaled and cast where it lies: the bytes of
    (clip(rgb, 0, 1) * 255).astype(uint8), also one float32 step either
    side of every k / 255 and outside [0, 1]."""
    v = np.arange(256, dtype=np.float32) / np.float32(255)
    vals = np.concatenate([np.nextafter(v, np.float32(-1)), v, np.nextafter(v, np.float32(2)),
                           np.float32([-3.0, -0.0, 1.5, 7.0, 0.5, 0.25])])
    rgb = vals[: len(vals) // 3 * 3].reshape(-1, 1, 3)
    want = (np.clip(rgb, 0, 1) * 255).astype(np.uint8).tobytes()
    assert tgui.frame_bytes(rgb) == want and tgui.frame_bytes(torch.from_numpy(rgb)) == want


def _w2c(yaw, t):
    c, s = math.cos(yaw), math.sin(yaw)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    m[:3, 3] = t
    return m


MESSAGES = [message(24, 32), message(1280, 1920, _w2c(0.3, [1.5, -0.2, 7.0]), 70.0, 50.0),
            message(886, 1920, _w2c(-1.1, [-3.0, 2.0, 0.5]), 90.0, 45.0, keep_alive=True)]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_camera_from_message_matches_jax(i):
    from street_gaussians_tpu import network_gui as jgui

    got = tgui.camera_from_message(MESSAGES[i], device="cpu")
    want = jgui.camera_from_message(MESSAGES[i])
    assert (got.H, got.W) == (want.H, want.W)
    for name in ("w2c", "full_proj", "K", "cam_center"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_zero_resolution_gives_no_camera():
    from street_gaussians_tpu import network_gui as jgui

    msg = dict(MESSAGES[0], resolution_x=0)
    assert tgui.camera_from_message(msg, device="cpu") is None and jgui.camera_from_message(msg) is None


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("viewer_seq") / "seq")
    write_synthetic_waymo(root, num_frames=2, cameras=(0,), actor_in_view=True)
    return root


def small_cfg(root, model_path, iterations, *extra):
    return t_load_config(None, [
        "source_path", root, "model_path", model_path, "data.type", "Waymo", "data.split_train", "1",
        "data.cameras", "[0]", "model.nsg.include_sky", "false", "optim.densify_until_iter", "0",
        "optim.opacity_reset_interval", "1000000", "train.iterations", str(iterations),
        "train.test_iterations", "[]", "train.save_iterations", "[]", "train.checkpoint_iterations", "[]",
        "render.tile_capacity", "0", "render.instance_capacity", "32768", "capacity.background_growth", "1",
        "capacity.actor_growth", "1", "viewer.enabled", "true", "viewer.port", "0", *extra])


def view_message(view, H, W, **kw):
    """The message of a camera at the view's pose, focal lengths from its K
    scaled to H x W."""
    K = view.frame_input.cam.K.numpy()
    fov_x = 2 * math.degrees(math.atan(view.W / (2 * K[0, 0])))
    fov_y = 2 * math.degrees(math.atan(view.H / (2 * K[1, 1])))
    return message(H, W, view.frame_input.cam.w2c.numpy(), fov_x, fov_y, **kw)


def test_bridge_serves_the_ports_render(seq, tmp_path):
    """ViewerBridge.poll: receive a camera, render the scene with the
    current parameters, stream its bytes; they equal
    (clip(render_frame(...)["rgb"], 0, 1) * 255).astype(uint8) of the same
    camera; a 'train' request without keep_alive returns control."""
    torch.manual_seed(0)
    np.random.seed(0)
    cfg = small_cfg(seq, str(tmp_path / "out"), 1)
    scene = trunner.build_scene(cfg, device="cpu")
    state = init_train_state(trunner.build_initial_params(cfg, scene, device="cpu"), scene.aux_init)
    bridge = trunner.ViewerBridge(cfg, scene)
    view = scene.train_views[0]
    H, W = 40, 56
    result = {}
    # the frame (6.7 KB) fits the socket's buffer: one poll serves it
    # before the client reads
    with connect(bridge.gui.port) as c:
        try:
            send_json(c, view_message(view, H, W))
            assert bridge.poll(state, view, training_done=False, iteration=1)
            result["img"], result["verify"] = recv_frame(c, H, W)
        finally:
            bridge.close()
    assert bridge.frames == 1 and bridge.disconnects == 0
    cam = tgui.camera_from_message(view_message(view, H, W), device="cpu")
    tpl = view.frame_input
    cam = dataclasses.replace(cam, frame=tpl.cam.frame, timestamp=tpl.cam.timestamp, cam_id=tpl.cam.cam_id,
                              image_id=tpl.cam.image_id)
    with torch.no_grad():
        rgb = render_frame(state.params, state.aux, scene.table, scene.pose_data, dataclasses.replace(tpl, cam=cam),
                           trunner.EVAL_STEP, opts=trunner.render_opts_from_cfg(cfg, "eval"))["rgb"]
    want = (np.clip(rgb.numpy(), 0, 1) * 255).astype(np.uint8)
    assert result["img"] == want.tobytes() and want.std() > 0
    assert result["verify"] == cfg.source_path.encode()


def _drop_mid_message(port):
    c = connect(port)
    c.sendall((200).to_bytes(4, "little") + b'{"resolution_x": ')
    c.close()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_dropped_client_returns_control(package, seq, tmp_path):
    """A client that sends part of a message and drops: poll disconnects
    it and returns, the listener ready for the next viewer."""
    if package == "jax":
        from street_gaussians_tpu import network_gui as jgui
        from street_gaussians_tpu.runner import ViewerBridge

        bridge = ViewerBridge.__new__(ViewerBridge)
        bridge.gui = jgui
        jgui.init("127.0.0.1", 0)
        port = jgui.listener.getsockname()[1]
    else:
        np.random.seed(0)
        cfg = small_cfg(seq, str(tmp_path / "out"), 1)
        bridge = trunner.ViewerBridge(cfg, trunner.build_scene(cfg, device="cpu"))
        port = bridge.gui.port
    try:
        _drop_mid_message(port)
        t = threading.Thread(target=bridge.poll, args=(None, None, False), daemon=True)
        t.start()
        t.join(TIMEOUT)
        assert not t.is_alive()
        assert bridge.gui.conn is None
        if package == "torch":
            assert bridge.disconnects == 1 and bridge.frames == 0
    finally:
        if package == "jax":
            jgui.disconnect()
            jgui.listener.close()
            jgui.listener = None
        else:
            bridge.close()


def test_training_without_a_client(seq, tmp_path):
    np.random.seed(0)
    cfg = small_cfg(seq, str(tmp_path / "out"), 2)
    final = trunner.training(cfg, progress=False, device="cpu")
    assert final["iterations"] == 2 and final["viewer"]["frames"] == 0 and final["viewer"]["events"] == []


def test_training_serves_a_client_that_drops(seq, tmp_path, monkeypatch):
    """A viewer attaches to the bound port during training, asks for two
    frames with train and keep_alive set (each returns control to
    training), then drops: training reaches its last iteration, and the
    bridge counts the two frames and the disconnect."""
    np.random.seed(0)
    cfg = small_cfg(seq, str(tmp_path / "out"), 12)
    ports = queue.Queue()
    init = trunner.ViewerBridge.__init__

    def recording_init(self, *a, **k):
        init(self, *a, **k)
        ports.put(self.gui.port)

    monkeypatch.setattr(trunner.ViewerBridge, "__init__", recording_init)
    H, W = 24, 36
    got = []

    def client():
        with connect(ports.get(timeout=120)) as c:
            for _ in range(2):
                send_json(c, message(H, W, train=True, keep_alive=True))
                got.append(recv_frame(c, H, W))

    t = threading.Thread(target=client, daemon=True)
    t.start()
    final = trunner.training(cfg, progress=False, device="cpu")
    t.join(TIMEOUT)
    assert not t.is_alive() and len(got) == 2
    v = final["viewer"]
    assert final["iterations"] == 12 and v["frames"] == 2 and v["disconnects"] == 1
    kinds = [what for _, what in v["events"]]
    assert kinds == ["connected", f"frame {W}x{H}", f"frame {W}x{H}", "disconnected"]
    assert v["events"][-1][0] < 12  # dropped before the last iteration, training went on

# Port of street_gaussians_tpu/network_gui.py (lines 1-140): the listener and the
# connection held by a NetworkGUI object instead of module globals, and the
# viewer's camera made by utils/camera.make_camera on a torch device.
"""SIBR remote-viewer TCP protocol.

Port of the reference's `network_gui` (ref: lib/models/network_gui.py:
26-85, the standard 3DGS viewer bridge — dormant in the reference's
train loop but a first-class capability): a non-blocking listener that
receives JSON camera messages (`{resolution_x/y, fov_x/y, z_near/far,
view_matrix, view_projection_matrix, ...}`) and replies with raw RGB
bytes + a verification string.

The camera arrives as transposed row-major torch-style matrices with
the SIBR y/z flips (network_gui.py:73-76); `camera_from_message`
converts to this framework's un-transposed math convention
(utils/camera.py docstring) and returns a renderable Camera on a device
(the CUDA card unless the caller asks for the CPU).

One NetworkGUI holds one listener and at most one viewer connection, so
two bridges (or two tests) never share socket state.
"""

from __future__ import annotations

import json
import socket
import traceback
from typing import Optional, Tuple

import numpy as np
import torch

from street_gaussians_torch.utils.camera import Camera, make_camera

HOST = "127.0.0.1"
PORT = 6009


class NetworkGUI:
    """The listener (non-blocking accept) and the viewer's connection
    (blocking reads once connected). `port` is the port actually bound,
    so port 0 asks the system for a free one."""

    def __init__(self, host: str = HOST, port: int = PORT):
        self.host = host
        self.conn: Optional[socket.socket] = None
        self.addr = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.port = self.listener.getsockname()[1]

    def try_connect(self) -> bool:
        if self.listener is None:
            return False
        try:
            self.conn, self.addr = self.listener.accept()
            print(f"\nConnected by {self.addr}")
            self.conn.settimeout(None)
            return True
        except Exception:
            return False

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self, device=None) -> Tuple[Optional[Camera], Optional[bool], Optional[bool], Optional[float]]:
        """-> (camera on `device`, do_training, keep_alive, scaling_modifier)."""
        message = self.read()
        try:
            cam = camera_from_message(message, device=device)
        except Exception:
            traceback.print_exc()
            raise
        if cam is None:
            return None, None, None, None
        return (
            cam,
            bool(message.get("train", False)),
            bool(message.get("keep_alive", True)),
            float(message.get("scaling_modifier", 1.0)),
        )

    def send_image(self, rgb, verify: str = "") -> None:
        """rgb [H, W, 3] float in [0, 1] (numpy or a tensor) -> raw bytes to
        the viewer."""
        self.send(frame_bytes(rgb), verify)

    def disconnect(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self) -> None:
        """Drop the connection and the listener."""
        self.disconnect()
        if self.listener is not None:
            self.listener.close()
            self.listener = None


def frame_bytes(rgb) -> bytes:
    """(clip(rgb, 0, 1) * 255).astype(uint8) of [H, W, 3], as bytes. A
    tensor is clipped, scaled and cast where it lies (the same float32
    product and truncation), so a card sends a quarter of the bytes to
    the host."""
    if isinstance(rgb, torch.Tensor):
        data = (rgb.detach().clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    else:
        data = (np.clip(np.asarray(rgb), 0, 1) * 255).astype(np.uint8)
    return memoryview(np.ascontiguousarray(data)).tobytes()


def camera_from_message(message: dict, device=None) -> Optional[Camera]:
    """JSON message -> Camera on `device` (ref: network_gui.py:57-81
    receive)."""
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width == 0 or height == 0:
        return None
    fovy = message["fov_y"]
    fovx = message["fov_x"]
    # SIBR sends the TRANSPOSED world->view matrix with y/z columns
    # negated (network_gui.py:73-75); undo both.
    wvt = np.array(message["view_matrix"], np.float32).reshape(4, 4)
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    w2c = wvt.T  # un-transpose to the math convention

    fx = width / (2.0 * np.tan(fovx / 2.0))
    fy = height / (2.0 * np.tan(fovy / 2.0))
    K = np.array(
        [[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]], np.float32
    )
    return make_camera(
        K,
        w2c,
        int(height),
        int(width),
        znear=message.get("z_near", 0.01),
        zfar=message.get("z_far", 100.0),
        device=device,
    )

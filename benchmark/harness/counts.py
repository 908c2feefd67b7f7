"""The work of a step or a view, counted from the cell's own inputs.

Frozen here so that a change to the program or to its check script
cannot move a roofline: the counts depend only on what the inputs need
(the pairs of pixels and Gaussians a front-to-back blend that stops at
transmittance 1e-4 must evaluate and blend, the rows in play, the
pixels), not on how a kernel does it. Peaks: one NVIDIA H100 SXM, dense,
67 TFLOP/s float32 off the tensor cores and 3.35 TB/s of HBM (NVIDIA's
data sheet, at its 700 W power limit).

Operation counts are float32 operations with exp, log1p, sqrt and a
division counted as one each.
"""

from __future__ import annotations

from typing import Dict

F32_PEAK = 67e12  # float32 operations a second
HBM_PEAK = 3.35e12  # bytes a second


def payload_rows(F: int) -> int:
    """Payload channels a Gaussian carries into the blend: 6 header
    rows (mean x, y, conic a, b, c, opacity), F features, 2 AbsGS rows,
    padded to a multiple of 8."""
    return -(-(6 + F + 2) // 8) * 8


def blend_fwd_work(evaluated: int, blended: int, live: int, tiles: int, F: int = 4) -> Dict[str, int]:
    """Kernel 2.1, the blend forward:
        ops   = 17 * evaluated + (9 + 2 F) * blended
        bytes = 4 * (live (6 + F) + tiles 256 (F + 1) + 2 tiles)
    17 per evaluated pair (the offset, the quadratic form, exp, the
    opacity product, clamp, the tests, log1p and the running sum), 9 + 2F
    more per blended pair (the weight from the transmittance, F products
    and sums into the accumulators); bytes: each live instance's header
    and features read once, the [tiles, 256, F + 1] output written once,
    the run starts and counts read once."""
    return {"ops": 17 * evaluated + (9 + 2 * F) * blended,
            "bytes": 4 * (live * (6 + F) + tiles * 256 * (F + 1) + 2 * tiles)}


def blend_bwd_work(evaluated: int, blended: int, live: int, tiles: int, F: int = 4) -> Dict[str, int]:
    """Kernel 2.2, the blend backward:
        ops   = 17 * evaluated + (47 + 6 F) * blended
        bytes = 4 * (live (6 + F) + 2 tiles 256 (F + 1) + live payload_rows(F))
    the forward's re-walk (17, 9 + 2F) plus a blended pair's gradient
    terms (30 + 3F) and its share of the 256-pixel sums (8 + F); bytes:
    the payload in, the forward's output and its cotangent in, the
    payload's gradient out (one row set a live instance)."""
    return {"ops": 17 * evaluated + (47 + 6 * F) * blended,
            "bytes": 4 * (live * (6 + F) + 2 * tiles * 256 * (F + 1) + live * payload_rows(F))}


def segsum_work(rows: int, channels: int, segments: int) -> Dict[str, int]:
    """Kernel 2.4, one segmented row-sum over `rows` sorted rows of
    `channels` float32 channels into `segments` sums:
        bytes = 4 * (channels rows + rows + channels segments)
    the rows and their keys read once, the sums written once; its adds
    (channels rows) are far below its bytes' time."""
    return {"ops": channels * rows, "bytes": 4 * (channels * rows + rows + channels * segments)}


def payload_segsum_work(live: int, capacity: int, F: int = 4) -> Dict[str, int]:
    """The payload gather's gradient: the live instances' payload rows
    summed into every Gaussian row of the table."""
    return segsum_work(live, payload_rows(F), capacity)


def sky_segsum_work(pixels: int, texels: int) -> Dict[str, int]:
    """The sky lookup's gradient: a pixel's 4 taps x 3 channels summed
    into the cubemap's texels."""
    return segsum_work(pixels, 12, texels)


# per-row and per-pixel counts of the stages around the kernels
COMPOSE_PRE_OPS = 300
"""Compose and preprocess, a row in play, forward: the actor transform
(a 3x3 product and a translation, 15; the rotation composed, 27), the
quaternion to a matrix (~25), Sigma = M M^T (~45), the projection (15 +
4 for mean2d), the Jacobian and J W Sigma W^T J^T (~60), the conic,
eigenvalue, radius and rect (~35), SH degree 1 along the view direction
(~30), the Fourier colour (~40 for 5 terms), sigmoid and exp (4)."""
COMPOSE_PRE_BWD_OPS = 2 * COMPOSE_PRE_OPS
"""Their backward: about twice the forward's operations."""
LOSS_PIXEL_OPS = 700
"""L1 and SSIM a pixel, forward: 5 blurred maps x 3 channels x 2
separable passes x 11 taps x 2 (660), the map and L1 (~40)."""
LOSS_PIXEL_BWD_OPS = 2 * LOSS_PIXEL_OPS
SKY_PIXEL_OPS = 60
"""The sky a pixel: the ray (~20), the face and its coordinates (~20),
4 taps x 3 channels (~20)."""
ADAM_ELEMENT_OPS = 12
"""Adam an element of a row in play: the moments (6), the bias
corrections and the step (6)."""


def step_ops(parts: Dict[str, int], F: int = 4) -> int:
    """A train step's operations from its counted parts: `rows` in play,
    `pixels`, `adam_elements`, `sky_pixels`, the blend's `evaluated` and
    `blended` pairs (over every render of the step):
        rows (COMPOSE_PRE_OPS + COMPOSE_PRE_BWD_OPS)
        + blend_fwd_work ops + blend_bwd_work ops
        + pixels (LOSS_PIXEL_OPS + LOSS_PIXEL_BWD_OPS)
        + sky_pixels 2 SKY_PIXEL_OPS + adam_elements ADAM_ELEMENT_OPS"""
    ev, bl = parts["evaluated"], parts["blended"]
    return (parts["rows"] * (COMPOSE_PRE_OPS + COMPOSE_PRE_BWD_OPS)
            + blend_fwd_work(ev, bl, 0, 0, F)["ops"] + blend_bwd_work(ev, bl, 0, 0, F)["ops"]
            + parts["pixels"] * (LOSS_PIXEL_OPS + LOSS_PIXEL_BWD_OPS)
            + parts["sky_pixels"] * 2 * SKY_PIXEL_OPS
            + parts["adam_elements"] * ADAM_ELEMENT_OPS)


def view_ops(parts: Dict[str, int], F: int = 4) -> int:
    """A served view's operations:
        rows COMPOSE_PRE_OPS + blend_fwd_work ops + sky_pixels SKY_PIXEL_OPS"""
    return (parts["rows"] * COMPOSE_PRE_OPS + blend_fwd_work(parts["evaluated"], parts["blended"], 0, 0, F)["ops"]
            + parts["sky_pixels"] * SKY_PIXEL_OPS)


def roofline_share(work: Dict[str, int], seconds: float) -> float:
    """The least time the work can take on the card, as a percentage of
    `seconds`: the larger of operations / F32_PEAK and bytes / HBM_PEAK."""
    least = max(work["ops"] / F32_PEAK, work["bytes"] / HBM_PEAK)
    return 100.0 * least / seconds

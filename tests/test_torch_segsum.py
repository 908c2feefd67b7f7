"""Port parity: street_gaussians_torch.ops.segsum.segment_rowsum (plain
version on the CPU) against the JAX package's segment_rowsum (Pallas in
interpret mode), with identity and explicit segments, empty segments,
padding keys and one segment spanning many of the JAX kernel's chunks.

Tolerance: rtol = atol = 1e-5. Both sum f32 rows; the JAX kernel as a
0/1 matrix product over 128-row chunks, the port's plain version in key
order, so the two differ by the order of their sums (a few ulp of sums of a few
standard-normal rows, up to 512 rows in the spanning case).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_torch.ops import segsum as tseg
from street_gaussians_tpu.ops import segsum as jseg

TOL = dict(rtol=1e-5, atol=1e-5)
CAP, GROUP = 128, 16


def _explicit_case(rng, n_seg, n_rows, empty_frac):
    """Contiguous segments [offs, ends) over sorted keys 0..used-1; the
    rest of the rows are padding (key BIG), both padded to JAX's
    multiples."""
    sizes = rng.integers(0, 7, size=n_seg)
    sizes[rng.random(n_seg) < empty_frac] = 0
    while sizes.sum() > n_rows:
        sizes[rng.integers(n_seg)] = 0
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ends = (offs + sizes).astype(np.int32)
    used = int(sizes.sum())
    L = -(-n_rows // CAP) * CAP
    keys = np.full(L, int(tseg.BIG), np.int32)
    keys[:used] = np.arange(used)
    d = rng.standard_normal((5, L)).astype(np.float32)
    Np = -(-n_seg // GROUP) * GROUP
    offs = np.pad(offs, (0, Np - n_seg), constant_values=ends[-1])
    ends = np.pad(ends, (0, Np - n_seg), constant_values=ends[-1])
    return d, keys, offs, ends


def _both(d, keys, offs=None, ends=None, num_segments=None, skip_empty=False):
    j = [jnp.asarray(x) for x in (d, keys)]
    t = [torch.as_tensor(x) for x in (d, keys)]
    if offs is not None:
        j += [jnp.asarray(offs), jnp.asarray(ends)]
        t += [torch.as_tensor(offs), torch.as_tensor(ends)]
    want = np.asarray(jseg.segment_rowsum(
        *j, num_segments=num_segments, cap=CAP, group=GROUP, skip_empty=skip_empty, interpret=True
    ))
    got = tseg.segment_rowsum(*t, num_segments=num_segments, skip_empty=skip_empty).numpy()
    return got, want


@pytest.mark.parametrize("empty_frac,skip_empty", [(0.0, False), (0.6, True)])
def test_explicit_segments_match_jax(empty_frac, skip_empty):
    d, keys, offs, ends = _explicit_case(np.random.default_rng(0), 75, 300, empty_frac)
    got, want = _both(d, keys, offs, ends, skip_empty=skip_empty)
    np.testing.assert_allclose(got, want, **TOL)
    empty = offs == ends
    assert empty.any() and (got[:, empty] == 0).all()


@pytest.mark.parametrize("skip_empty", [False, True])
def test_identity_segments_match_jax(skip_empty):
    """Keys clustered in the low half of the segment space (the high
    half is empty), repeated keys, padding rows with non-zero values."""
    rng = np.random.default_rng(3)
    N, L = 96, 384
    keys = np.sort(rng.integers(0, N // 2, size=300)).astype(np.int32)
    keys = np.pad(keys, (0, L - 300), constant_values=int(tseg.BIG))
    d = rng.standard_normal((5, L)).astype(np.float32)
    got, want = _both(d, keys, num_segments=N, skip_empty=skip_empty)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[:, N // 2:] == 0).all()


def test_one_segment_spans_chunks():
    """One segment owning all 512 rows: four of the JAX kernel's
    128-row chunks."""
    L = 512
    d = np.random.default_rng(2).standard_normal((4, L)).astype(np.float32)
    offs = np.zeros(GROUP, np.int32)
    ends = np.zeros(GROUP, np.int32)
    ends[0] = L
    got, want = _both(d, np.arange(L, dtype=np.int32), offs, ends)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got[:, 1:] == 0).all()


def test_plain_sums_in_key_order_exactly():
    """The plain version adds each segment's rows in key order from 0
    (as the kernel does for explicit segments; for identity segments it
    adds a segment cut by its partition in parts, see
    tests/test_torch_merge_path.py): equal to a sequential f32 sum bit
    for bit."""
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 20, size=200)).astype(np.int32)
    d = (rng.standard_normal((3, 200)) * 10.0 ** rng.integers(-3, 4, (3, 200))).astype(np.float32)
    got = tseg.segment_rowsum(torch.as_tensor(d), torch.as_tensor(keys), num_segments=20).numpy()
    want = np.zeros((3, 20), np.float32)
    for j, k in enumerate(keys):
        want[:, k] = want[:, k] + d[:, j]
    np.testing.assert_array_equal(got, want)


def test_rejects_bad_arguments():
    d = torch.zeros((2, 8))
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tseg.segment_rowsum(d, k)  # identity without num_segments
    with pytest.raises(ValueError):
        tseg.segment_rowsum(d, k.long(), num_segments=4)
    with pytest.raises(ValueError):
        tseg.segment_rowsum(d, k, torch.zeros(4, dtype=torch.int32), None)

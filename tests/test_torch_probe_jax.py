"""The blend probe's two kernels held against the JAX package's own
kernel bodies, on the CPU.

The JAX script's `call_variant` (script/probe_kernel.py) unpacks five
step tables where tile_raster2._flatten_steps now returns two packed
words, so it cannot be called as it stands. Its kernel bodies,
`_floor_kernel` and `_mxu_kernel`, still run: the script is loaded here by
file path, and each body goes through `pl.pallas_call(...,
interpret=True)` with the five tables built below from the tiles' runs as
_flatten_steps lays them out (one grid step per payload block of a run,
one for an empty tile; the block id carried forward as a running
maximum, so an empty tile's step points at the last block before it, or
block 0).

Held against them: the port's `probe_floor` on the CPU (its plain
version), the blend's plain version that `probe_blend_mma` runs on the
CPU, and the plain repetition of the variant's segment algebra
(`probe_blend_mma_split_plain`, with runs cut into segments of one and
two blocks). Tolerances: the floor within FLOOR_RTOL (1e-5) x the sum of
|values| (f32 sums in another order), the blend by
chip_smoke.compare_blend (B_TOL = 1e-5 relative, a stop that lands
within rounding of 1e-4 may move by one Gaussian in at most one pixel).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import FLOOR_RTOL, compare_blend, random_blend_case
from street_gaussians_torch.ops import tile_raster2
from street_gaussians_torch.ops.tile_raster2 import CHUNK, PIX
from street_gaussians_torch.script import probe_kernel

F = 4
GRID_X = 3
# a 3x2 grid: an empty first tile (its JAX step points at block 0), an
# empty tile between runs (its step points at the block before it), and
# runs of one to four payload blocks, the first not block-aligned
COUNTS = (0, 153, 226, 0, 285, 43)
EMPTY = [t for t, c in enumerate(COUNTS) if c == 0]


def _jax_script():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "script", "probe_kernel.py")
    spec = importlib.util.spec_from_file_location("jax_script_probe_kernel", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def make_case():
    return random_blend_case(1, "cpu", grid_x=GRID_X, grid_y=2, F=F, counts=COUNTS)


def step_tables(tile_start, tile_count):
    """The five tables of the JAX probe's grid, one entry a step: tile,
    global payload block, block in the tile's run, last step of the tile,
    first step writing its block (tile_raster2._flatten_steps before
    packing)."""
    start = np.asarray(tile_start, np.int64)
    cnt = np.asarray(tile_count, np.int64)
    nb = np.where(cnt > 0, (start % CHUNK + cnt + CHUNK - 1) // CHUNK, 0)
    tables = ([], [], [], [], [])
    carried, prev, seen_real = 0, -1, False
    for t in range(start.size):
        for i in range(max(int(nb[t]), 1)):
            real = i < nb[t]
            if real:
                carried = max(carried, int(start[t] // CHUNK + i))
            write_first = real and (carried > prev or not seen_real)
            seen_real |= bool(real)
            for table, v in zip(tables, (t, carried, i, i == max(int(nb[t]), 1) - 1, write_first)):
                table.append(int(v))
            prev = carried
    return [jnp.asarray(np.array(a, np.int32)) for a in tables]


def run_jax_body(kernel, scratch, payload, tile_start, tile_count, num_tiles):
    """One of the JAX script's kernel bodies over the step tables, in
    interpret mode, as its call_variant launches it."""
    tables = step_tables(tile_start, tile_count)
    c_pad = payload.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=7,
        grid=(int(tables[0].shape[0]),),
        in_specs=[pl.BlockSpec((1, c_pad, CHUNK), lambda s, ts, blk, *_: (blk[s], 0, 0))],
        out_specs=pl.BlockSpec((1, PIX, F + 1), lambda s, ts, *_: (ts[s], 0, 0)),
        scratch_shapes=scratch,
    )
    out = pl.pallas_call(
        functools.partial(kernel, num_features=F, grid_x=GRID_X),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((num_tiles, PIX, F + 1), jnp.float32),
        interpret=True,
    )(*tables, jnp.asarray(tile_start.numpy()), jnp.asarray(tile_count.numpy()), jnp.asarray(payload.numpy()))
    return torch.as_tensor(np.array(out))


@functools.lru_cache(maxsize=None)
def jax_floor():
    payload, starts, counts, _, _, T = make_case()
    return run_jax_body(_jax_script()._floor_kernel, [pltpu.VMEM((PIX, F), jnp.float32)], payload, starts,
                        counts, T)


@functools.lru_cache(maxsize=None)
def jax_mxu():
    payload, starts, counts, _, _, T = make_case()
    scratch = [pltpu.VMEM((PIX, 1), jnp.float32), pltpu.VMEM((PIX, 1), jnp.float32),
               pltpu.VMEM((PIX, F), jnp.float32)]
    return run_jax_body(_jax_script()._mxu_kernel, scratch, payload, starts, counts, T)


def test_step_tables_cover_every_block_of_every_run():
    """Integers, exact: a step for each block of each run in order, one
    for an empty tile, the last flag on each tile's final step."""
    _, starts, counts, _, _, T = make_case()
    ts, blks, ios, lasts, wfs = (np.asarray(a) for a in step_tables(starts, counts))
    nb = tile_raster2.run_blocks(starts, counts).numpy()
    assert ts.tolist() == [t for t in range(T) for _ in range(max(int(nb[t]), 1))]
    assert int(lasts.sum()) == T and (np.diff(blks) >= 0).all()
    for t in range(T):
        mine = ts == t
        assert ios[mine].tolist() == list(range(max(int(nb[t]), 1)))
        if nb[t]:
            assert blks[mine].tolist() == list(range(int(starts[t]) // CHUNK, int(starts[t]) // CHUNK + int(nb[t])))
    assert blks[ts == 0].tolist() == [0] and blks[ts == 3].tolist() == [blks[ts == 2][-1]]
    assert wfs[0] == 0 and wfs[1] == 1  # an empty tile's step claims no block


def test_floor_cpu_path_matches_the_jax_floor_body():
    """Every tile with a run: the sums of rows 0..7 of the blocks it
    touches, in all [256, F] outputs, T = 1, within FLOOR_RTOL x the sum
    of |values|."""
    case = make_case()
    want = jax_floor()
    got = probe_kernel.probe_floor(*case)
    bound = FLOOR_RTOL * probe_kernel.probe_floor_plain(case[0].abs(), *case[1:])
    ran = [t for t in range(case[5]) if t not in EMPTY]
    assert ((got[ran] - want[ran]).abs() <= bound[ran] + 1e-30).all()
    assert (want[..., F] == 1).all() and (got[..., F] == 1).all()
    assert float(want[ran, :, :F].abs().min()) > 0


def test_floor_on_empty_tiles():
    """The JAX body runs an empty tile's one step with its state reset
    and adds the rows of the block that step points at (block 0 for the
    first tile, the block before it for the other); the port holds the
    floor's documented contract instead: an empty tile reads nothing,
    0 in every feature and T = 1."""
    payload, starts, counts, _, _, T = make_case()
    want = jax_floor()
    got = probe_kernel.probe_floor(*make_case())
    ts, blks = (np.asarray(a) for a in step_tables(starts, counts)[:2])
    rows = payload[:, :8, :].double().sum(dim=(1, 2))
    for t in EMPTY:
        (b,) = blks[ts == t]
        assert abs(float(want[t, 0, 0]) - float(rows[b])) <= FLOOR_RTOL * float(payload[b, :8].abs().sum())
        assert float(want[t, 0, 0]) != 0.0
        assert (got[t, :, :F] == 0).all() and (got[t, :, F] == 1).all()


def test_variant_plain_matches_the_jax_mxu_body():
    """The blend's plain version, which probe_blend_mma runs on the CPU,
    against the JAX tensor-core body: compare_blend's rule."""
    case = make_case()
    want = jax_mxu()
    got = probe_kernel.probe_blend_mma(*case)
    assert torch.equal(got, tile_raster2.tile_blend_plain(*case))
    compare_blend(got, want, F, "probe_blend_mma (CPU) against the JAX _mxu_kernel")
    assert (want[EMPTY, :, :F] == 0).all() and (want[EMPTY, :, F] == 1).all()
    assert float(want[..., F].min()) < 0.5  # pixels the runs cover


@pytest.mark.parametrize("seg_blocks", [1, 2])
def test_split_form_matches_the_jax_mxu_body(seg_blocks):
    """The variant's segment algebra, runs cut every one or two blocks
    (the four-block run into four and two segments), against the JAX
    tensor-core body."""
    case = make_case()
    got, st = probe_kernel.probe_blend_mma_split_plain(*case, seg_blocks, return_state=True)
    assert st["plan"]["n_long"] > 0
    compare_blend(got, jax_mxu(), F, f"split form at {seg_blocks} block(s) a segment against the JAX _mxu_kernel")

"""The tile plan of the ``conv_s8`` kernel (bpbreid_tpu_torch/ops/cuda/
conv_s8.py ``plan_conv_tiles``) and its halo addressing, on the CPU,
where no card runs the kernel.

- For the int8 serving step's conv shapes and ragged ones, the planned
  tiles cover every output pixel exactly once, every TMA box dimension is
  at most 256, the inner box is one swizzle span, and the shared memory a
  CTA asks for is at most 227 KB.
- A plain walk of the planned tiles, in the kernel's order (per channel
  chunk one zero-filled halo box and one B box, then the k x k taps read
  from the halo, shifted by the tap and scaled by the stride), gives the
  exact int32 sums: bit-equal to ``conv_s8_accumulate`` and to JAX's
  int8 ``lax.conv_general_dilated`` (what ``bpbreid_tpu/ops/quant.py
  quant_conv`` runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu_torch.ops.cuda.conv_s8 import (
    SERVING_STEP_CONVS, SMEM_LIMIT, TMA_BOX_LIMIT, check_conv_plan,
    conv_layout, conv_s8_accumulate, conv_tiles, halo_box, pack_weight_s8,
    padded_channels, plan_conv_tiles, rows_groupable, tma_box)
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

# the int8 serving step's 33 conv shapes: (N, Cin, H, W, Co, k, stride)
STEP_SHAPES = sorted({key[:7] for key in SERVING_STEP_CONVS})
# chip_smoke.py INT8_RAGGED, and halo edge cases: N = 1, Ho and Wo not
# multiples of the tile, odd H and W at stride 2, Cp 32 to 1024, Co not a
# multiple of BN
RAGGED_SHAPES = [(2, 3, 17, 9, 64, 3, 2), (3, 40, 7, 5, 5, 3, 1),
                 (2, 64, 13, 11, 130, 1, 2), (1, 96, 6, 4, 72, 3, 2),
                 (1, 32, 97, 33, 33, 3, 1), (1, 1024, 13, 5, 200, 1, 1),
                 (2, 512, 25, 9, 96, 3, 2), (1, 160, 3, 130, 40, 3, 1)]
SWIZZLE_SPANS = (32, 64, 128)     # TMA's swizzle modes, bytes


def _out_size(h, k, stride):
    return (h + 2 * (k // 2) - k) // stride + 1


def _plan(shape):
    n, cin, h, w, co, k, stride = shape
    ho, wo = _out_size(h, k, stride), _out_size(w, k, stride)
    return plan_conv_tiles(n, h, w, padded_channels(cin), co, k, stride,
                           k // 2), ho, wo


@pytest.mark.parametrize('shape', STEP_SHAPES + RAGGED_SHAPES)
def test_plan_covers_each_output_pixel_once_and_fits(shape):
    n, cin, h, w, co, k, stride = shape
    plan, ho, wo = _plan(shape)
    cp = padded_channels(cin)
    assert plan.th * plan.tw in (64, 128) and plan.bn in (32, 64, 128)
    tiles_h, tiles_w = conv_tiles(plan, ho, wo)
    seen = np.zeros((ho, wo), np.int64)
    for ty in range(tiles_h):
        for tx in range(tiles_w):
            seen[ty * plan.th:(ty + 1) * plan.th,
                 tx * plan.tw:(tx + 1) * plan.tw] += 1
    assert (seen == 1).all()
    assert -(-co // plan.bn) * plan.bn >= co
    # TMA: A's halo box, (128, units, rows, 1) over 128-byte units of the
    # image rows or (kc, cols, rows, 1) over [N, H, W, Cp]; its inner box
    # one swizzle span (the swizzle is box[0] bytes), every dimension at
    # most 256; it covers the halo
    rows, cols = halo_box(plan, k, stride)
    assert rows == (plan.th - 1) * stride + k
    box = tma_box(plan, k, stride, k // 2, cp)
    assert max(box) <= TMA_BOX_LIMIT and box[2:] == (rows, 1)
    assert box[0] in SWIZZLE_SPANS
    assert cp % plan.kc == 0
    assert plan.grouped == (rows_groupable(plan.kc, cp, w) and not (
        cp == 64 and k > 1 and stride == 1))
    if plan.grouped:
        per_unit = 128 // cp
        assert (-(k // 2)) % per_unit + cols <= box[1] * per_unit
        assert plan.tw * stride % per_unit == 0
    else:
        assert box[:2] == (plan.kc, cols)
    assert plan.stages in (2, 3)
    layout = check_conv_plan(plan, k, stride, k // 2, cp, w)
    assert layout.smem <= SMEM_LIMIT
    assert plan.th * plan.tw * plan.bn // 32 <= 1024    # threads per CTA


@pytest.mark.parametrize('shape', STEP_SHAPES + RAGGED_SHAPES)
@pytest.mark.parametrize('out_bf16', [True, False])
def test_layout_regions_hold_what_the_kernel_stores(shape, out_bf16):
    """The checks the C entry point makes of the layout it is given:
    each region holds what the kernel puts there, in order, aligned, with
    no overlap."""
    n, cin, h, w, co, k, stride = shape
    plan, _, _ = _plan(shape)
    cp = padded_channels(cin)
    lay = conv_layout(plan, k, stride, k // 2, cp, out_bf16)
    rows, cols = halo_box(plan, k, stride)
    assert lay.box_inner == (128 if plan.grouped else plan.kc)
    assert lay.box_rows >= rows
    if not plan.grouped:
        assert lay.box_cols >= cols
    tx = lay.box_inner * lay.box_cols * lay.box_rows
    b_chunk = plan.bn * lay.b_ld
    assert lay.b_ld >= k * k * (cp if lay.b_resident else plan.kc)
    assert lay.b_ld % 16 == 0
    assert lay.b_resident or cp > plan.kc
    assert tx <= lay.halo_bytes and lay.halo_bytes % 1024 == 0
    assert lay.stage_bytes >= lay.halo_bytes + (
        0 if lay.b_resident else b_chunk)
    assert lay.stage_bytes % 1024 == 0 and lay.b_offset % 1024 == 0
    assert lay.b_offset >= plan.stages * lay.stage_bytes
    assert lay.tile_offset >= lay.b_offset + (
        b_chunk if lay.b_resident else 0)
    bm = plan.th * plan.tw
    tile = plan.bn * (bm + 8) * 2 if out_bf16 else plan.bn * (bm + 4) * 4
    assert lay.tile_offset % 16 == 0 and lay.bar_offset % 8 == 0
    assert lay.bar_offset >= lay.tile_offset + tile
    assert lay.bar_offset + 8 * plan.stages + 1024 <= lay.smem <= SMEM_LIMIT


def test_check_conv_plan_refuses_what_tma_cannot_load():
    # grouped rows need whole 128-byte units of an image row (W * Cp)
    plan = plan_conv_tiles(1, 8, 6, 32, 32, 3, 1, 1)
    assert not plan.grouped
    with pytest.raises(ValueError, match='grouped'):
        check_conv_plan(plan._replace(grouped=True), 3, 1, 1, 32, 6)
    # a box dimension over 256 elements
    wide = plan._replace(th=1, tw=256)
    with pytest.raises(ValueError, match='TMA box'):
        check_conv_plan(wide, 3, 1, 1, 32, 6)


def tile_walk(xq, w, k, stride, pad, plan, ho, wo):
    """The kernel's sums, tile by tile: per output tile and channel
    chunk, the halo box with zero fill where it leaves the image and the
    B box with zero fill past Co, then the taps read from the halo."""
    n, h, wd, cp = xq.shape
    co = w.shape[0]
    rows, cols = halo_box(plan, k, stride)
    tiles_h, tiles_w = conv_tiles(plan, ho, wo)
    ctiles = -(-co // plan.bn)
    wk = torch.zeros(ctiles * plan.bn, k * k, cp, dtype=torch.float64)
    wk[:co] = w.view(co, k * k, cp).double()
    out = torch.zeros(n, ctiles * plan.bn, tiles_h * plan.th,
                      tiles_w * plan.tw, dtype=torch.float64)
    x = xq.double()
    for img in range(n):
        for ty in range(tiles_h):
            for tx in range(tiles_w):
                h0 = ty * plan.th * stride - pad
                w0 = tx * plan.tw * stride - pad
                hs, he = max(h0, 0), min(h0 + rows, h)
                ws, we = max(w0, 0), min(w0 + cols, wd)
                for c0 in range(0, cp, plan.kc):
                    halo = torch.zeros(rows, cols, plan.kc,
                                       dtype=torch.float64)
                    if hs < he and ws < we:
                        halo[hs - h0:he - h0, ws - w0:we - w0] = \
                            x[img, hs:he, ws:we, c0:c0 + plan.kc]
                    for n0 in range(0, ctiles * plan.bn, plan.bn):
                        b = wk[n0:n0 + plan.bn, :, c0:c0 + plan.kc]
                        acc = torch.zeros(plan.bn, plan.th, plan.tw,
                                          dtype=torch.float64)
                        for r in range(k):
                            for q in range(k):
                                a = halo[r:r + (plan.th - 1) * stride + 1:
                                         stride,
                                         q:q + (plan.tw - 1) * stride + 1:
                                         stride]
                                acc += torch.einsum('yxc,oc->oyx', a,
                                                    b[:, r * k + q])
                        out[img, n0:n0 + plan.bn,
                            ty * plan.th:(ty + 1) * plan.th,
                            tx * plan.tw:(tx + 1) * plan.tw] += acc
    return out[:, :co, :ho, :wo].to(torch.int32)


@pytest.mark.parametrize('shape', [
    (2, 40, 9, 7, 20, 3, 1), (1, 64, 13, 11, 30, 1, 2),
    (1, 96, 11, 6, 72, 3, 2), (2, 32, 5, 18, 8, 1, 1),
    (1, 130, 6, 5, 140, 3, 1), (1, 32, 12, 4, 256, 3, 1)])
def test_tile_walk_matches_conv_s8_accumulate_and_jax(shape):
    n, cin, h, w, co, k, stride = shape
    rng = np.random.default_rng(sum(shape))
    cp = padded_channels(cin)
    x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wt = rng.integers(-127, 128, (co, cin, k, k)).astype(np.int8)
    xq = torch.zeros(n, h, w, cp, dtype=torch.int8)
    xq[..., :cin] = torch.from_numpy(x)
    wp = pack_weight_s8(torch.from_numpy(wt), cp)
    plan, ho, wo = _plan(shape)
    got = tile_walk(xq, wp, k, stride, k // 2, plan, ho, wo)
    want = conv_s8_accumulate(xq, wp, k, stride, k // 2, cin)
    assert got.shape == (n, co, ho, wo)
    assert torch.equal(got, want)
    jax_acc = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wt.transpose(2, 3, 1, 0)),
        (stride, stride), ((k // 2, k // 2),) * 2,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    assert np.array_equal(np.asarray(jax_acc).transpose(0, 3, 1, 2),
                          got.numpy())

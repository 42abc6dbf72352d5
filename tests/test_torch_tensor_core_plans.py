"""The tile plan of K8's bf16 route and the weight packings of K8's and K7's
bf16 routes (`ops/generator_tail.py`, `ops/attention.py`), on the CPU.

K8's bf16 kernel walks tiles of 8 x 16 planar positions (one per wgmma row)
that own 12 x 28 output pixels, reads a 9 x 17 window of x for the four
shifted taps, and takes its tap weights as (tap, 64-column group, Cin padded
to 16, 64) tiles. K7's bf16 kernel projects x through one GEMM with the
three weights packed K-major beside their float32 biases. These tests hold
the tile arithmetic and the packings against the twins with a numpy
emulation of the kernels' index arithmetic and roundings; the kernels
themselves are held against the twins on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from contextual_image_compression_tpu_torch.ops.attention import (
    _pack_qkv,
    _project,
    attention_block_plain,
    sagan_block_plain,
)
from contextual_image_compression_tpu_torch.ops.generator_tail import (
    TC_PLANAR_TILE,
    _pack_tap_tiles,
    _pack_taps,
    fused_tail_plain,
    tc_tile_grid,
)

PR, PC = TC_PLANAR_TILE


def _round_bf16(a):
    """float32 -> nearest bf16 (ties to even), kept in float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _tiles(b, h, w):
    ty_n, tx_n, _, _ = tc_tile_grid(h, w)
    for bi in range(b):
        for ty in range(ty_n):
            for tx in range(tx_n):
                yield bi, ty * (PR - 2), tx * (PC - 2)


@pytest.mark.parametrize("h,w", [(128, 128), (12, 12), (7, 9), (1, 1), (40, 15)])
def test_k8_tiles_cover_each_output_pixel_once(h, w):
    """Tile (ty, tx) owns output rows 2 M0 .. 2 M0 + 11 and columns
    2 J0 .. 2 J0 + 27 of the image's (2h, 2w); together the tiles cover
    each pixel exactly once, the ragged last row and column of tiles
    included."""
    _, _, th, tw = tc_tile_grid(h, w)
    assert (th, tw) == (2 * (PR - 2), 2 * (PC - 2)) and PR * PC == 128
    cover = np.zeros((2 * h, 2 * w), np.int64)
    for _, m0, j0 in _tiles(1, h, w):
        cover[2 * m0:2 * m0 + th, 2 * j0:2 * j0 + tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("h,w", [(128, 128), (12, 20), (5, 3)])
def test_k8_tile_halo_lies_in_its_planar_tile_and_x_window(h, w):
    """Every output pixel of a tile reads z rows P - 1 .. P + 2 and columns
    Q - 1 .. Q + 2, whose planar positions ((P + 1) >> 1, (Q + 1) >> 1) lie
    in the tile's PR x PC positions; every tap (r, s) of those positions
    reads x[m + r - 1, j + s - 1] inside the (PR + 1) x (PC + 1) window from
    (M0 - 1, J0 - 1)."""
    _, _, th, tw = tc_tile_grid(h, w)
    for _, m0, j0 in _tiles(1, h, w):
        pp, qq = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
        rows = 2 * m0 + pp[..., None] - 1 + np.arange(4)
        cols = 2 * j0 + qq[..., None] - 1 + np.arange(4)
        ml, jl = ((rows + 1) >> 1) - m0, ((cols + 1) >> 1) - j0
        assert ml.min() >= 0 and ml.max() < PR and jl.min() >= 0 and jl.max() < PC
        for r in (0, 1):
            for s in (0, 1):
                xr = (m0 + np.arange(PR) + r - 1) - (m0 - 1)
                xc = (j0 + np.arange(PC) + s - 1) - (j0 - 1)
                assert xr.min() >= 0 and xr.max() <= PR and xc.min() >= 0 and xc.max() <= PC


@pytest.mark.parametrize("cin,cmid", [(128, 32), (40, 8), (24, 5), (3, 20)])
def test_k8_tap_tiles_hold_the_packed_taps(cin, cmid):
    """The tap tiles are `_pack_taps`' (4, Cin, 4 Cmid) cut into 64-column
    groups with Cin padded to a multiple of 16, zeros in the padding."""
    folded = torch.randn(cin, cmid, 4, 4, generator=torch.Generator().manual_seed(cin))
    tiles = _pack_tap_tiles(folded)
    nc, ng, cin_pad = 4 * cmid, -(-4 * cmid // 64), -(-cin // 16) * 16
    assert tiles.shape == (4, ng, cin_pad, 64) and tiles.is_contiguous()
    flat = tiles.permute(0, 2, 1, 3).reshape(4, cin_pad, ng * 64)
    assert torch.equal(flat[:, :cin, :nc], _pack_taps(folded))
    assert not flat[:, cin:].any() and not flat[:, :, nc:].any()


def _emulate_tc_tail(x, tiles, shift, wo, bias, slope, bf16):
    """K8's bf16 route in numpy, tile by tile as the kernel walks them: the
    x window, per tap a float32 product of the shifted window and the tap
    tile rounded to bf16, the TPU combine order by planar column parity,
    + shift, LeakyReLU, zeros out of the image, then the out-conv of the
    planar tile in float32 and tanh. bf16=False drops the roundings."""
    rnd = _round_bf16 if bf16 else (lambda a: a.astype(np.float32))
    b, cin, h, w = x.shape
    _, ng, cin_pad, _ = tiles.shape
    cmid, co = shift.shape[0], wo.shape[0]
    nc = 4 * cmid
    wmat = tiles.transpose(0, 2, 1, 3).reshape(4, cin_pad, ng * 64)[:, :, :nc]
    _, _, th, tw = tc_tile_grid(h, w)
    out = np.full((b, co, 2 * h, 2 * w), np.nan, np.float32)
    n = np.arange(nc)
    slab, o = n // cmid, n % cmid
    p = np.arange(PR * PC)
    for bi, m0, j0 in _tiles(b, h, w):
        win = np.zeros((PR + 1, PC + 1, cin_pad), np.float32)
        rows, cols = m0 - 1 + np.arange(PR + 1), j0 - 1 + np.arange(PC + 1)
        rv, cv = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
        win[np.ix_(rv, cv, np.arange(cin))] = x[bi][:, rows[rv]][:, :, cols[cv]].transpose(1, 2, 0)
        d = []
        for t in range(4):
            r, s = divmod(t, 2)
            a = win[r:r + PR, s:s + PC].reshape(PR * PC, cin_pad)
            d.append(rnd(a.astype(np.float64) @ wmat[t].astype(np.float64)))
        y = rnd(d[0] + d[1])
        odd = ((j0 + p % PC) % 2 == 1)[:, None]
        y = np.where(odd, rnd(rnd(y + d[2]) + d[3]), rnd(rnd(y + d[3]) + d[2]))
        v = rnd(y + shift[o])
        v = rnd(np.where(v >= 0, v, np.float32(slope) * v))
        m, j = (m0 + p // PC)[:, None], (j0 + p % PC)[:, None]
        pz, qz = 2 * m - slab // 2, 2 * j - slab % 2
        ys = np.where((pz < 0) | (pz >= 2 * h) | (qz < 0) | (qz >= 2 * w), 0.0, v)
        pp, qq = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
        P, Q = 2 * m0 + pp, 2 * j0 + qq
        acc = np.zeros((th, tw, co), np.float64)
        for dy in range(4):
            for dx in range(4):
                rz, cz = P - 1 + dy, Q - 1 + dx
                pos = (((rz + 1) >> 1) - m0) * PC + ((cz + 1) >> 1) - j0
                z = ys[pos[..., None], ((rz & 1) * 2 + (cz & 1))[..., None] * cmid + np.arange(cmid)]
                acc += z.astype(np.float64) @ wo[:, :, dy, dx].T.astype(np.float64)
        res = np.tanh(acc.astype(np.float32) + bias).transpose(2, 0, 1)
        inside = (P < 2 * h) & (Q < 2 * w)
        sel = out[bi][:, P[inside], Q[inside]]
        assert np.isnan(sel).all()  # each pixel written once
        out[bi][:, P[inside], Q[inside]] = res[:, inside]
    assert not np.isnan(out).any()
    return rnd(out)


@pytest.mark.parametrize("b,cin,cmid,h,w", [
    (2, 40, 8, 12, 20),
    (1, 24, 5, 7, 9),
    (1, 128, 32, 10, 16),
], ids=["cin40-ragged", "cmid5-odd", "full-width-channels"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_tile_emulation_matches_the_twin(b, cin, cmid, h, w, dtype):
    """The emulation from the tap tiles against `fused_tail_plain`. Bars as
    the card's: float32 2e-5; bf16 1.6e-2 absolute (two ulps of a tanh
    output) and identical on >= 99% of outputs: both round each tap, but
    their float32 sums may fall on either side of a bf16 boundary."""
    gen = torch.Generator().manual_seed(b * 1000 + cin * 10 + cmid)
    x = (torch.randn(b, cin, h, w, generator=gen) * 0.5).to(dtype)
    folded = (torch.randn(cin, cmid, 4, 4, generator=gen) * 0.1).to(dtype)
    shift = (torch.randn(cmid, generator=gen) * 0.1).to(dtype)
    wo = (torch.randn(3, cmid, 4, 4, generator=gen) * 0.1).to(dtype)
    bias = torch.randn(3, generator=gen) * 0.1
    want = fused_tail_plain(x, folded, shift, wo, bias).float().numpy()
    got = _emulate_tc_tail(x.float().numpy(), _pack_tap_tiles(folded).float().numpy(),
                           shift.float().numpy(), wo.float().numpy(), bias.numpy(), 0.2,
                           dtype == torch.bfloat16)
    err = np.abs(got - want)
    if dtype == torch.float32:
        assert err.max() <= 2e-5
    else:
        assert err.max() <= 1.6e-2 and (err == 0).mean() >= 0.99


def _sagan_params(c, inner, seed):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen) * 0.1

    return [r(c, inner), r(inner), r(c, inner), r(inner), r(c, c), r(c)]


@pytest.mark.parametrize("c,inner", [(256, 32), (64, 8), (192, 24), (128, 5)])
def test_k7_qkv_packing_holds_the_three_projections(c, inner):
    """The packed weight is [Wq | Wk | Wv]^T in the compute dtype, K-major,
    and the float32 biases in the same order; one
    GEMM through it, + bias in float32, rounded to bf16, gives the twin's
    three projections: bit for bit where the float32 sums agree, which is
    all but a few entries."""
    wq, bq, wk, bk, wv, bv = _sagan_params(c, inner, c + inner)
    w, bias = _pack_qkv(wq, bq, wk, bk, wv, bv, torch.bfloat16)
    nout = 2 * inner + c
    assert w.shape == (nout, c) and w.dtype == torch.bfloat16 and w.is_contiguous()
    assert bias.shape == (nout,) and bias.dtype == torch.float32 and bias.is_contiguous()
    assert torch.equal(w.t(), torch.cat([wq, wk, wv], 1).to(torch.bfloat16))
    assert torch.equal(bias, torch.cat([bq, bk, bv]))
    x = (torch.randn(2, 100, c, generator=torch.Generator().manual_seed(c)) * 0.5).to(torch.bfloat16)
    y = (x.double() @ w.double().t() + bias.double()).float().to(torch.bfloat16)
    q, k, v = y[..., :inner], y[..., inner:2 * inner], y[..., 2 * inner:nout]
    for got, (wt, bt) in zip((q, k, v), ((wq, bq), (wk, bk), (wv, bv))):
        want = _project(x, wt, bt)
        assert (got.float() - want.float()).abs().max().item() <= 2 * 2.0 ** -8 * want.float().abs().max().item()
        assert (got == want).float().mean().item() >= 0.99
    block = attention_block_plain(q, k, v, x, torch.tensor(0.5))
    want = sagan_block_plain(x, wq, bq, wk, bk, wv, bv, torch.tensor(0.5))
    rel = ((block.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert rel <= 2e-2


def test_k7_qkv_packing_in_float32_is_exact():
    """In float32 the packing only moves values: the GEMM through it is the
    three projections to float32 rounding."""
    wq, bq, wk, bk, wv, bv = _sagan_params(64, 8, 3)
    w, bias = _pack_qkv(wq, bq, wk, bk, wv, bv, torch.float32)
    x = torch.randn(1, 50, 64, generator=torch.Generator().manual_seed(4))
    y = x @ w.t() + bias
    for got, (wt, bt) in zip((y[..., :8], y[..., 8:16], y[..., 16:80]),
                             ((wq, bq), (wk, bk), (wv, bv))):
        assert torch.allclose(got, _project(x, wt, bt), rtol=1e-6, atol=1e-6)

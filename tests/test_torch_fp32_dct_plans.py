"""The arithmetic of the float32 attention route of K2 / K6 and of K5's
kernel (`csrc/attention.cu` namespace tf, `csrc/dct.cu`), on the CPU.

The float32 attention kernel forms every product on the tensor cores as three
TF32 passes, a_hi b_hi + a_hi b_lo + a_lo b_hi, with hi = cvt.rna.tf32(x) and
lo = cvt.rna.tf32(x - hi), and takes e = exp(s - m) from the accumulator of S
as the A operand of e.V, with V^T's keys stored in the order in which that
accumulator hands them over. K5 walks the tiles of the planes in one
flattened order, 4 tiles a warp, and forms each 8-term sum as an fmaf chain
in index order. These tests emulate both in numpy and hold them against the
twins (`attention_block_plain`, `attention_core_plain`, `dct_strips_plain`)
at the bars the card holds the kernels to; the kernels themselves are held
against the twins on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from contextual_image_compression_tpu_torch.ops.attention import (
    TF32_KEY_TILE,
    _tf32_scratch_elems,
    attention_block_plain,
    attention_core_plain,
)
from contextual_image_compression_tpu_torch.ops.dct import (
    _dct_matrix,
    dct_strips_plain,
    quality_tables,
)

CSRC = Path(__file__).resolve().parent.parent / "contextual_image_compression_tpu_torch" / "csrc"


def _constant(source, name, namespace=None):
    text = (CSRC / source).read_text()
    if namespace is not None:
        text = text[text.index(f"namespace {namespace} {{"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# ------------------------------------------------------------ three-pass TF32

def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero (add
    half an ulp of TF32 to the magnitude bits, clear the 13 low bits)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    x = np.asarray(x, np.float32)
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(a, b, passes):
    """a @ b as the tensor cores form it from TF32 operands, summed exactly
    (float64) and rounded once to float32: three passes a_hi b_hi + (a_hi b_lo
    + a_lo b_hi), or one, a_hi b_hi."""
    ah, al = _split(a)
    bh, bl = _split(b)
    f = np.float64
    out = ah.astype(f) @ bh.astype(f)
    if passes == 3:
        out = out + (ah.astype(f) @ bl.astype(f) + al.astype(f) @ bh.astype(f))
    return out.astype(np.float32)


def _acc_fragment(lane, i):
    """(row, column) within a warp's 16 rows of d[i] of a wgmma float32
    accumulator (m64nN): row lane / 4 + 8 ((i / 2) % 2), column
    8 (i / 4) + 2 (lane % 4) + i % 2 (`csrc/hopper.cuh`)."""
    return lane // 4 + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * (lane % 4) + i % 2


def _a_fragment_tf32(lane, reg):
    """(row, k position) of register reg of the A fragment of m64nNk8 .tf32
    from registers: a[0] (r, c), a[1] (r + 8, c), a[2] (r, c + 4), a[3]
    (r + 8, c + 4), r = lane / 4, c = lane % 4."""
    return lane // 4 + 8 * (reg % 2), lane % 4 + 4 * (reg // 2)


# softmax_tile's choice: A register reg of slice j takes s[4 j + SOURCE[reg]]
SOURCE = (0, 2, 1, 3)


def _fragment_key_order():
    """The key that each k position of an 8-key slice holds when the A
    fragment is filled from the accumulator as softmax_tile fills it; fails
    if the fill mixes rows or gives one position two keys."""
    order = {}
    for lane in range(32):
        for reg in range(4):
            a_row, pos = _a_fragment_tf32(lane, reg)
            s_row, key = _acc_fragment(lane, SOURCE[reg])
            assert a_row == s_row
            assert order.setdefault(pos, key) == key
    return [order[p] for p in range(8)]


def _prepass_key_order():
    """split_kernel's order of V^T's keys in a group of 8, as in its source."""
    text = (CSRC / "attention.cu").read_text()
    assert "(p & ~7) + (e < 4 ? 2 * e : 2 * e - 7)" in text
    return [2 * e if e < 4 else 2 * e - 7 for e in range(8)]


def test_fragment_key_order_matches_the_prepass():
    """S's accumulator gives a thread the keys 2t, 2t + 1 of each group of 8,
    the A fragment wants k positions t, t + 4: so position t holds key 2t and
    t + 4 key 2t + 1, the order in which the pre-pass stores V^T."""
    assert _fragment_key_order() == [0, 2, 4, 6, 1, 3, 5, 7] == _prepass_key_order()


def test_key_tile_and_scratch_match_the_kernel():
    assert TF32_KEY_TILE == _constant("attention.cu", "KEYS", "tf")
    # q, k hi and lo at DK padded to 32 / 64, V^T hi and lo at N padded to 32
    assert _tf32_scratch_elems(16, 1024, 32, 256) == 4 * 16 * 1024 * 32 + 2 * 16 * 256 * 1024
    assert _tf32_scratch_elems(3, 100, 33, 64) == 4 * 3 * 100 * 64 + 2 * 3 * 64 * 128


def _key_perm(n):
    """Every key's position in the fragment order, N padded to a multiple of 8."""
    pad = -n % 8
    return np.arange(n + pad) // 8 * 8 + np.tile(_fragment_key_order(), (n + pad) // 8), pad


def tf32_attention(q, k, v, residual=None, gamma=None, passes=3):
    """The float32 route's arithmetic in numpy: S = Q K^T from TF32 passes,
    m the row's max over all keys, e = exp(s - m) and l = sum(e) in float32,
    O = e V from TF32 passes with e's columns and V's rows taken in the
    fragment's key order within each group of 8, then K2's (gamma / l) O +
    residual or K6's O / l."""
    q, k, v = (np.asarray(t, np.float32) for t in (q, k, v))
    b, n, _ = q.shape
    perm, pad = _key_perm(n)
    out = []
    for i in range(b):
        s = _product(q[i], k[i].T, passes)
        e = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
        l = e.sum(-1, keepdims=True, dtype=np.float32)
        ep = np.pad(e, ((0, 0), (0, pad)))[:, perm]
        vp = np.pad(v[i], ((0, pad), (0, 0)))[perm]
        o = _product(ep, vp, passes)
        recip = (np.float32(1.0) / l).astype(np.float32)
        if residual is None:
            out.append(o * recip)
        else:
            g = np.float32(gamma)
            out.append((g * recip).astype(np.float32) * o + np.asarray(residual[i], np.float32))
    return np.stack(out).astype(np.float32)


def _attention_inputs(b, n, dk, dv, scale, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, n, dk) * scale).astype(np.float32)
    k = (rng.randn(b, n, dk) * scale).astype(np.float32)
    v = rng.randn(b, n, dv).astype(np.float32)
    r = rng.randn(b, n, dv).astype(np.float32)
    return q, k, v, r


def _twin(kind, q, k, v, r):
    t = [torch.from_numpy(a) for a in (q, k, v, r)]
    if kind == "K2":
        return attention_block_plain(*t[:3], t[3], 0.5).numpy()
    return attention_core_plain(*t[:3]).numpy()


def _emulated(kind, q, k, v, r, passes=3):
    if kind == "K2":
        return tf32_attention(q, k, v, r, 0.5, passes)
    return tf32_attention(q, k, v, passes=passes)


SHAPES = [(2, 100, 8, 64, 0.5), (2, 1024, 32, 256, 0.4)]
SHAPE_IDS = ["card-test-2x100x8x64", "path-2x1024x32x256"]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", ["K2", "K6"])
def test_three_pass_tf32_matches_the_twins(kind, shape):
    """Three TF32 passes in the fragment's key order stay within the float32
    route's 1e-5 bar of the float32 twin."""
    b, n, dk, dv, scale = shape
    ins = _attention_inputs(b, n, dk, dv, scale, n + dk)
    err = np.abs(_emulated(kind, *ins) - _twin(kind, *ins)).max()
    assert err <= 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", ["K2", "K6"])
def test_one_pass_tf32_misses_the_bar(kind, shape):
    """A single TF32 pass (a_hi b_hi) misses 1e-5: the bar tells one pass
    from three."""
    b, n, dk, dv, scale = shape
    ins = _attention_inputs(b, n, dk, dv, scale, n + dk)
    err = np.abs(_emulated(kind, *ins, passes=1) - _twin(kind, *ins)).max()
    assert err > 1e-5


def test_v_in_natural_key_order_breaks_the_product():
    """e taken from the accumulator in fragment order against V^T in natural
    key order pairs e with the wrong keys: far off the twin."""
    ins = _attention_inputs(2, 100, 8, 64, 0.5, 108)
    q, k, v, r = ins
    perm, pad = _key_perm(q.shape[1])
    s = np.einsum("bnd,bmd->bnm", q, k)
    e = np.exp(s - s.max(-1, keepdims=True))
    ep = np.pad(e, ((0, 0), (0, 0), (0, pad)))[..., perm]
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0)))
    wrong = np.einsum("bnm,bmd->bnd", ep, vp) / e.sum(-1, keepdims=True)
    right = np.einsum("bnm,bmd->bnd", ep, vp[:, perm]) / e.sum(-1, keepdims=True)
    twin = _twin("K6", *ins)
    assert np.abs(right - twin).max() <= 1e-5
    assert np.abs(wrong - twin).max() > 1e-2


# ---------------------------------------------------------------------- K5

def _fma_chain(terms):
    """sum of a_i * b_i as fmaf(a_i, b_i, acc) in index order from 0: each
    step's product is exact in float64, and the sum is rounded to float32."""
    acc = np.float32(0)
    for a, b in terms:
        acc = (a.astype(np.float64) * b + acc).astype(np.float32)
    return acc


def k5_emulated(planes, tables):
    """The kernel's per-thread arithmetic on every tile: t = D X on a column,
    coef = t D^T on a row, rint(coef / q) with IEEE division, deq = sym q,
    u = deq D on a row, rec = D^T u on a column; each sum an fmaf chain."""
    planes = np.asarray(planes, np.float32)
    b, c, h, w = planes.shape
    d = _dct_matrix()
    x = planes.reshape(b, c, h // 8, 8, w // 8, 8).transpose(0, 1, 2, 4, 3, 5)  # (..., row, col)
    q = np.asarray(tables, np.float32)[None, :, None, None]
    # T[i][col] = sum_m D[i][m] X[m][col]
    t = _fma_chain((d[:, m][:, None], x[..., m, None, :]) for m in range(8))
    # coef[r][j] = sum_w T[r][w] D[j][w]
    coef = _fma_chain((t[..., :, w, None], d[:, w][None, :]) for w in range(8))
    sym = np.rint(coef / q).astype(np.float32)
    deq = (sym * q).astype(np.float32)
    # U[r][w] = sum_j deq[r][j] D[j][w]
    u = _fma_chain((deq[..., :, j, None], d[j, :][None, :]) for j in range(8))
    # rec[i][col] = sum_m D[m][i] U[m][col]
    rec = _fma_chain((d[m, :][:, None], u[..., m, None, :]) for m in range(8))

    def back(a):
        return a.transpose(0, 1, 2, 4, 3, 5).reshape(b, c, h, w)

    return back(rec), back(sym)


@pytest.mark.parametrize("b,h,w,quality", [
    (1, 8, 8, 75), (2, 16, 264, 75), (2, 64, 64, 1), (2, 64, 64, 100),
], ids=["one-tile", "w264", "quality-1", "quality-100"])
def test_k5_order_of_sums_holds_the_bars(b, h, w, quality):
    """The card test's four cases: symbols within +-1 and identical on
    >= 99.99%; rec within 1e-4 on blocks whose symbols agree."""
    rng = np.random.RandomState(w + quality)
    planes = (rng.rand(b, 3, h, w) * 255 - 128).astype(np.float32)
    tables = quality_tables(quality)
    rec, sym = k5_emulated(planes, tables)
    rec_p, sym_p = (a.numpy() for a in dct_strips_plain(torch.from_numpy(planes),
                                                        torch.from_numpy(tables)))
    assert np.abs(sym - sym_p).max() <= 1.0
    assert (sym == sym_p).mean() >= 0.9999
    agree = (sym == sym_p).reshape(b, 3, h // 8, 8, w // 8, 8).all(5).all(3)
    err = np.abs(rec - rec_p).reshape(b, 3, h // 8, 8, w // 8, 8).max((3, 5))
    assert err[agree].max() <= 1e-4


def k5_walk(b, c, h, w, sms=132):
    """(element offset, channel) of every tile row the kernel's persistent
    grid stores, in the order of cic_dct_strips' grid and the kernel's loop:
    block x, warp y takes tasks y + 8 x, then + the grid's warps; a task is 4
    tiles of the flattened (strip, tile column) order, lane k * 8 + r row r
    of its tile k."""
    threads = _constant("dct.cu", "THREADS")
    per_sm = _constant("dct.cu", "BLOCKS_PER_SM")
    per_warp = _constant("dct.cu", "TILES_PER_WARP")
    warps = threads // 32
    tiles_w, strips_c = w // 8, h // 8
    ntiles = b * c * strips_c * tiles_w
    tasks = -(-ntiles // per_warp)
    blocks = min(-(-ntiles // (per_warp * warps)), per_sm * sms)
    stride = blocks * warps
    rows = []
    for block in range(blocks):
        for warp in range(warps):
            for task in range(block * warps + warp, tasks, stride):
                for lane in range(32):
                    k, r = lane >> 3, lane & 7
                    t = task * per_warp + k
                    if t >= ntiles:
                        continue
                    strip, tc = divmod(t, tiles_w)
                    rows.append(((strip * 8 + r) * w + tc * 8, (strip // strips_c) % c))
    return rows


@pytest.mark.parametrize("b,h,w,sms", [(1, 8, 8, 132), (2, 16, 264, 132), (3, 24, 264, 2),
                                       (5, 40, 48, 1)],
                         ids=["one-tile", "w264", "w264-wraps", "many-tasks-a-warp"])
def test_k5_walk_stores_each_pixel_once(b, h, w, sms):
    """Every tile, a ragged W of 33 tiles a strip included, is visited once:
    each pixel of rec and sym is written exactly once, each row with its own
    channel's table. Few SMs make the persistent loop wrap many times."""
    c = 3
    cover = np.zeros(b * c * h * w, np.int64)
    for off, ch in k5_walk(b, c, h, w, sms):
        cover[off:off + 8] += 1
        assert ch == off // (h * w) % c
    assert (cover == 1).all()


# ------------------------------------------------- K7 and K8 in float32 (TF32)
#
# K7's float32 route (csrc/sagan_block.cu, namespace tfp) projects x through
# one three-pass GEMM with the packed weights of `_pack_qkv_tf32`, adds the
# float32 bias and hands the TF32 hi and lo of Q, K and V^T to K2's float32
# kernel, which forms K7's scores with the lo terms first and e.V in
# segments of TF32_SEG_TILES key tiles. K8's (csrc/packed_tail.cu,
# namespace tf) forms each of the four tap products by three passes from the
# packed taps of `_pack_taps_tf32` (channels of each group of 8 in
# TF32_CHANNEL_ORDER), combines them in the TPU order, applies shift,
# LeakyReLU and the out-of-image zeros, and runs the out-conv by three
# passes from `_pack_out_conv_tf32`. The emulations below take the packed
# tensors as the kernels do, so a wrong index map shows as a miss of the bar.
#
# The tensor cores' float32 sums are not exact. `_tc_step` models one k8
# step of wgmma as the card behaves: the 8 products are exact, every term
# (the accumulator too) is aligned to the largest one and cut toward zero 3
# bits below float32's 24, and the sum is cut toward zero to float32. Each
# step thus drops bits at the scale of the running sum: that is what the
# kernels' order of accumulation is for (hi.hi apart from the lo terms, the
# sums restarted and added in float32). With this model the emulations
# reproduce the card's errors of the kernels and of the one-accumulator
# design they replaced (PERF.md, scripts/torch_k7_f32_error.py); where a
# shape is too large for it, `_packed_product` sums the passes exactly and
# rounds once: a best case, which the card tests hold the kernel to at that
# shape.

from contextual_image_compression_tpu_torch.ops.attention import (  # noqa: E402
    TF32_SEG_TILES,
    _pack_qkv_tf32,
    sagan_block_plain,
)
from contextual_image_compression_tpu_torch.ops.cuda_kernels import tf32_split  # noqa: E402
from contextual_image_compression_tpu_torch.ops.generator_tail import (  # noqa: E402
    TF32_CHANNEL_ORDER,
    _pack_out_conv_tf32,
    _pack_taps,
    _pack_taps_tf32,
    fused_tail_plain,
)

_F64 = torch.float64


def _packed_product(a, packed_t, passes):
    """a @ b^T from a float32 a and b's packed TF32 halves (2, rows, K): the
    passes summed exactly, rounded once to float32 (a best case)."""
    ah, al = _split(a)
    bh, bl = (np.asarray(t, np.float64) for t in packed_t)
    f = np.float64
    out = ah.astype(f) @ bh.T
    if passes == 3:
        out = out + (ah.astype(f) @ bl.T + al.astype(f) @ bh.T)
    return out.astype(np.float32)


def _tc_step(acc, a, b):
    """One k8 step of the tensor cores, acc (M, N) float64 holding float32
    values or None (a fresh accumulator) + a (M, 8) @ b (8, N) of TF32
    values: terms aligned to the largest and cut 3 bits below float32's 24,
    the sum cut toward zero to float32."""
    p = a[:, :, None] * b[None, :, :]
    if acc is not None:
        p = torch.cat([acc[:, None, :], p], dim=1)
    _, e = torch.frexp(p.abs().amax(dim=1))
    scale = torch.ldexp(torch.ones_like(e, dtype=_F64), 27 - e)
    s = (p * scale[:, None, :]).trunc_().sum(dim=1) / scale
    f = s.float().double()
    over = f.abs() > s.abs()
    f[over] = torch.nextafter(f[over].float(), torch.zeros(1)).double()
    return f


def _f32_add(a, b):
    return (a.float() + b.float()).double()


def _tc_product(a, bh, bl, passes=3, restart=None):
    """a (M, K) float32 @ b (K, N) from b's TF32 halves on the modelled
    tensor cores, as the kernels accumulate: per k8 step the lo terms
    (a_lo b_hi, then a_hi b_lo) into one accumulator, a_hi b_hi into
    another; with `restart`, the hi.hi accumulator starts afresh every
    `restart` channels and its sums add in float32; the two accumulators
    add in float32 at the end. K a multiple of 8. Returns float64 holding
    float32 values."""
    ah, al = (torch.from_numpy(np.ascontiguousarray(t)).double() for t in _split(a))
    bh, bl = (torch.as_tensor(np.ascontiguousarray(t)).double() for t in (bh, bl))
    lo = hi = total = None
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            lo = _tc_step(lo, al[:, ks], bh[ks])
            lo = _tc_step(lo, ah[:, ks], bl[ks])
        hi = _tc_step(hi if not restart or k0 % restart else None, ah[:, ks], bh[ks])
        if restart and (k0 + 8) % restart == 0:
            total = hi if total is None else _f32_add(total, hi)
    out = total if restart else hi
    return out if lo is None else _f32_add(out, lo)


def _tc_scores(q, k, passes, apart):
    """S = Q K^T by K2's kernel: per k8 slice lo.hi, hi.lo, hi.hi into one
    accumulator (K2); or the lo terms of every slice first, then the hi.hi
    ones (K7, score_mma_apart)."""
    qh, ql = (torch.from_numpy(t).double() for t in _split(q))
    kh, kl = (torch.from_numpy(t.T.copy()).double() for t in _split(k))
    s = None
    steps = range(0, q.shape[1], 8)
    for k0 in steps:
        ks = slice(k0, k0 + 8)
        if passes == 3:
            s = _tc_step(s, qh[:, ks], kl[ks])
            s = _tc_step(s, ql[:, ks], kh[ks])
        if not apart or passes == 1:
            s = _tc_step(s, qh[:, ks], kh[ks])
    if apart and passes == 3:
        for k0 in steps:
            s = _tc_step(s, qh[:, k0:k0 + 8], kh[k0:k0 + 8])
    return s.float().numpy()


def tc_attention(q, k, v, x, gamma, passes=3, segments=True):
    """K7's attention rows q (R, DKP) over keys k (N, DKP), v (N, DV) with
    residual rows x (R, DV): the scores as K7 forms them, e = exp(s - m) in
    float32, e.V by TF32 passes a 32-key tile at a time (lo.hi, hi.lo,
    hi.hi per k8 slice, one accumulator) restarted every TF32_SEG_TILES
    tiles, the segments added in float32 in order (segments=False: one
    accumulator over all keys), then (gamma (1 / l)) e.V + x. The order of
    the keys within a slice does not change the modelled sum."""
    n = k.shape[0]
    s = _tc_scores(q, k, passes, apart=segments)
    e = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    l = e.sum(-1, keepdims=True, dtype=np.float32)
    pad = -n % 8
    eh, el = (torch.from_numpy(np.pad(t, ((0, 0), (0, pad)))).double() for t in _split(e))
    vh, vl = (torch.from_numpy(np.pad(t, ((0, pad), (0, 0)))).double() for t in _split(v))
    o = total = None
    for k0 in range(0, n + pad, 8):
        if segments and k0 and k0 % (TF32_SEG_TILES * TF32_KEY_TILE) == 0:
            total = o if total is None else _f32_add(total, o)
            o = None
        ks = slice(k0, k0 + 8)
        if passes == 3:
            o = _tc_step(o, el[:, ks], vh[ks])
            o = _tc_step(o, eh[:, ks], vl[ks])
        o = _tc_step(o, eh[:, ks], vh[ks])
    if total is not None:
        o = _f32_add(total, o)
    sc = (np.float32(gamma) * (np.float32(1.0) / l)).astype(np.float32)
    return ((sc * o.float().numpy()).astype(np.float32) + x).astype(np.float32)


def k7_emulated(x, wq, bq, wk, bk, wv, bv, gamma, rows=None, passes=3, design="kernel"):
    """K7's float32 route on the modelled tensor cores: x . [Wq | Wk | Wv]
    from the packed halves (hi.hi restarted every 64-channel chunk of the
    depth and added in float32; design="one accumulator": one hi.hi sum
    over the whole depth, K2's scores and e.V over all keys, the design
    this route had first), + the float32 bias, then the attention of the
    query rows `rows` (all by default) of each image with x as the
    residual."""
    w, bias = (t.numpy() for t in _pack_qkv_tf32(*(torch.from_numpy(a)
                                                  for a in (wq, bq, wk, bk, wv, bv))))
    inner, c = wq.shape[1], x.shape[-1]
    dkp = w.shape[1] - c >> 1
    kernel = design == "kernel"
    out = []
    for xi in x:
        y = _tc_product(xi, w[0].T, w[1].T, passes, restart=64 if kernel else None)
        y = (y.float() + torch.from_numpy(bias)).numpy()
        q, k, v = y[:, :dkp], y[:, dkp:2 * dkp], y[:, 2 * dkp:]
        assert not y[:, inner:dkp].any() and not y[:, dkp + inner:2 * dkp].any()
        r = slice(None) if rows is None else rows
        out.append(tc_attention(q[r], k, v, xi[r], gamma, passes, segments=kernel))
    return np.stack(out)


def _k7_inputs(b, n, c, x_std, seed):
    """The card tests' weights (`_sagan_params`: weights and biases ~ N(0,
    0.01)) with x ~ N(0, x_std^2)."""
    rng = np.random.RandomState(seed)
    inner = c // 8
    x = (rng.randn(b, n, c) * x_std).astype(np.float32)
    shapes = [(c, inner), (inner,), (c, inner), (inner,), (c, c), (c,)]
    return x, tuple((rng.randn(*s) * 0.1).astype(np.float32) for s in shapes)


def _k7_error(shape, **kw):
    b, n, c, x_std, rows = shape
    x, params = _k7_inputs(b, n, c, x_std, n + c)
    want = sagan_block_plain(*(torch.from_numpy(a) for a in (x, *params)), torch.tensor(0.5))
    got = k7_emulated(x, *params, 0.5, rows=rows, **kw)
    return np.abs(got - want.numpy()[:, slice(None) if rows is None else rows]).max()


# (B, N, C, std of x, query rows emulated): the card test's shape and inputs
# (test_k7a_ragged_matches_twin, DK 8), and scripts/torch_tree_times.py's
# scales at the path's width, every 21st query row
K7_SHAPES = [(2, 100, 64, 1.0, None), (1, 1024, 256, 0.5, np.arange(0, 1024, 21))]
K7_IDS = ["card-test-2x100x64", "path-1x1024x256"]


@pytest.mark.parametrize("shape", K7_SHAPES, ids=K7_IDS)
def test_k7_three_pass_tf32_matches_the_twin(shape):
    """Three-pass projections with the float32 bias, then three-pass
    attention, on the modelled tensor cores in the kernel's order of
    accumulation: within K7's float32 bar, 1e-5, of `sagan_block_plain`."""
    assert _k7_error(shape) <= 1e-5


@pytest.mark.parametrize("shape", K7_SHAPES, ids=K7_IDS)
def test_k7_one_pass_tf32_misses_the_bar(shape):
    assert _k7_error(shape, passes=1) > 1e-5


def test_k7_segments_and_scratch_match_the_kernel():
    """TF32_SEG_TILES is attention.cuh's; K7's scratch holds e.V of every
    segment but the last past the K2 scratch, none where N takes one."""
    assert TF32_SEG_TILES == _constant("attention.cuh", "TF32_SEG_TILES")
    base = _tf32_scratch_elems(16, 1024, 32, 256)
    assert _tf32_scratch_elems(16, 1024, 32, 256, with_acc=True) == base + 3 * 16 * 1024 * 256
    assert _tf32_scratch_elems(2, 256, 8, 64, with_acc=True) == _tf32_scratch_elems(2, 256, 8, 64)
    assert _tf32_scratch_elems(2, 257, 8, 64, with_acc=True) == (
        _tf32_scratch_elems(2, 257, 8, 64) + 2 * 257 * 64)


def test_k7_one_accumulator_misses_the_bar():
    """At the card tests' inputs for DK 16 and N 1024 (x ~ N(0, 1)), the
    first design, each sum in one tensor-core accumulator, misses 1e-5 in
    the model as it did on the card; the kernel's order holds it."""
    shape = (1, 1024, 128, 1.0, np.arange(0, 1024, 21))
    assert _k7_error(shape, design="one accumulator") > 1e-5
    assert _k7_error(shape) <= 1e-5


def _tail_product(a, packed, passes, model):
    """a (M, K) @ the packed halves (2, N, K)^T: on the modelled tensor cores
    as K8 accumulates (hi.hi apart from the lo terms, added once), or summed
    exactly (model "exact")."""
    if model == "exact":
        return _packed_product(a, packed, passes)
    return _tc_product(a, packed[0].T, packed[1].T, passes).float().numpy()


def _tap_product(win, taps, t, passes, model):
    """Tap t's product at every planar position: the window in the packed
    channel order times the packed tap (2, 4, 128, cin_pad)."""
    cin_pad = taps.shape[-1]
    order = (np.arange(cin_pad) // 8 * 8).reshape(-1, 8) + np.array(TF32_CHANNEL_ORDER)
    a = win[..., order.reshape(-1)]
    shape = a.shape[:-1]
    return _tail_product(a.reshape(-1, cin_pad), taps[:, t], passes, model).reshape(*shape, -1)


def k8_emulated(x, folded, shift, ow, ob, slope=0.2, passes=3, model="tc"):
    """K8's float32 route over whole images: planar position (m, j), m in
    0..H, j in 0..W, slab (a, b) is output pixel (2m - a, 2j - b); tap (r,
    s) reads x[m + r - 1, j + s - 1]. The four tap products by three passes
    from the packed taps, combined in the TPU order, + shift, LeakyReLU,
    zeros outside the image, then the out-conv by three passes from the
    packed out-conv weights a tap at a time, the taps summed in order, +
    bias, tanh. model: "tc" (the modelled tensor cores) or "exact"."""
    b, cin, h, w = x.shape
    cmid, co = folded.shape[1], ow.shape[0]
    taps = _pack_taps_tf32(torch.from_numpy(folded)).numpy()
    wo = _pack_out_conv_tf32(torch.from_numpy(ow)).numpy()
    cin_pad = taps.shape[-1]
    xp = np.zeros((b, h + 2, w + 2, cin_pad), np.float32)
    xp[:, 1:h + 1, 1:w + 1, :cin] = x.transpose(0, 2, 3, 1)
    prod = {}
    for t in range(4):
        r, s = divmod(t, 2)
        prod[r, s] = _tap_product(xp[:, r:r + h + 1, s:s + w + 1], taps, t, passes, model)
    y = (prod[0, 0] + prod[0, 1]).astype(np.float32)
    odd = (np.arange(w + 1) % 2 == 1)[None, None, :, None]
    y = np.where(odd, (y + prod[1, 0]).astype(np.float32) + prod[1, 1],
                 (y + prod[1, 1]).astype(np.float32) + prod[1, 0]).astype(np.float32)
    y = y.reshape(b, h + 1, w + 1, 4, 32)
    sh = np.zeros(32, np.float32)
    sh[:cmid] = shift
    v = (y + sh).astype(np.float32)
    v = np.where(v >= 0, v, np.float32(slope) * v).astype(np.float32)
    # z at output pixel (R, S), R in -1 .. 2h + 1: planar ((R + 1) >> 1), slab
    # R & 1; zero outside the image (the planar grid ends at m = h)
    rr, ss = np.arange(-1, 2 * h + 2), np.arange(-1, 2 * w + 2)
    z = v[:, np.minimum((rr + 1) >> 1, h)][:, :, np.minimum((ss + 1) >> 1, w)]
    z = z[:, np.arange(rr.size)[:, None], np.arange(ss.size)[None, :],
          ((rr & 1)[:, None] * 2 + (ss & 1)[None, :])]
    inside = ((rr >= 0) & (rr < 2 * h))[:, None] & ((ss >= 0) & (ss < 2 * w))[None, :]
    z = np.where(inside[None, :, :, None], z, 0.0).astype(np.float32)
    # T = z . W_o a tap at a time (three passes, one float32 rounding), the 16
    # taps summed in float32 in tap order
    acc = np.zeros((b, 2 * h, 2 * w, 4), np.float32)
    for dy in range(4):
        for dx in range(4):
            zt = z[:, dy:dy + 2 * h, dx:dx + 2 * w]
            t = _tail_product(zt.reshape(-1, 32), wo[:, dy * 4 + dx], passes, model)
            acc = (acc + t.reshape(acc.shape)).astype(np.float32)
    out = acc[..., :co] + ob
    return np.tanh(out.astype(np.float32)).transpose(0, 3, 1, 2)


# (B, H, Cin, Cmid, model): the ragged narrow shape on the modelled tensor
# cores; one image at full width, too large for the model, as the exact sum
# of the passes (a best case: the card test full-path-f32 holds the kernel
# there)
K8_SHAPES = [(1, 12, 40, 8, "tc"), (1, 128, 128, 32, "exact")]
K8_IDS = ["ragged-narrow-1x12x40x8", "full-width-1x128x128x32"]


def _k8_inputs(b, h, cin, cmid):
    rng = np.random.RandomState(b * h + cin)
    x = (rng.randn(b, cin, h, h) * 0.5).astype(np.float32)
    folded = (rng.randn(cin, cmid, 4, 4) * 0.1).astype(np.float32)
    shift = (rng.randn(cmid) * 0.1).astype(np.float32)
    ow = (rng.randn(3, cmid, 4, 4) * 0.1).astype(np.float32)
    ob = (rng.randn(3) * 0.1).astype(np.float32)
    return x, folded, shift, ow, ob


@pytest.mark.parametrize("shape", K8_SHAPES, ids=K8_IDS)
def test_k8_three_pass_tf32_matches_the_twin(shape):
    """Within K8's float32 bar, 2e-5, of `fused_tail_plain`."""
    ins = _k8_inputs(*shape[:4])
    want = fused_tail_plain(*(torch.from_numpy(a) for a in ins)).numpy()
    assert np.abs(k8_emulated(*ins, model=shape[-1]) - want).max() <= 2e-5


@pytest.mark.parametrize("shape", K8_SHAPES, ids=K8_IDS)
def test_k8_one_pass_tf32_misses_the_bar(shape):
    ins = _k8_inputs(*shape[:4])
    want = fused_tail_plain(*(torch.from_numpy(a) for a in ins)).numpy()
    assert np.abs(k8_emulated(*ins, passes=1, model=shape[-1]) - want).max() > 2e-5


def _check_halves(packed, want):
    """hi has its 13 low bits clear (lo too), hi + lo is want to within
    2^-22 of |want|, and the halves are `_split`'s (cvt.rna twice)."""
    hi, lo = packed.numpy()
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(hi.astype(np.float64) + lo - want)
    assert (err <= 2.0 ** -22 * np.abs(want)).all()
    eh, el = _split(want)
    assert np.array_equal(hi, eh) and np.array_equal(lo, el)


def test_tf32_split_is_the_kernels_split():
    rng = np.random.RandomState(0)
    a = np.concatenate([rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096),
                        [0.0, -0.0, 1.0, -1.5, 2.0 ** -20]]).astype(np.float32)
    _check_halves(tf32_split(torch.from_numpy(a)), a)


@pytest.mark.parametrize("c,inner", [(256, 32), (64, 8), (128, 5), (192, 40)])
def test_k7_tf32_packing_holds_the_three_projections(c, inner):
    """(2, 2 dkp + C, C): rows [Wq^T; 0; Wk^T; 0; Wv^T] with Q's and K's
    rows zero-padded to dkp (32, or 64 past 32), as TF32 hi and lo; the
    float32 biases in the same rows, zeros in the padding."""
    gen = torch.Generator().manual_seed(c + inner)
    wq, wk, wv = (torch.randn(c, m, generator=gen) for m in (inner, inner, c))
    bq, bk, bv = (torch.randn(m, generator=gen) for m in (inner, inner, c))
    w, bias = _pack_qkv_tf32(wq, bq, wk, bk, wv, bv)
    dkp = 32 if inner <= 32 else 64
    assert w.shape == (2, 2 * dkp + c, c) and w.is_contiguous() and bias.shape == (2 * dkp + c,)
    want = np.zeros((2 * dkp + c, c), np.float32)
    want[:inner], want[dkp:dkp + inner], want[2 * dkp:] = (t.t().numpy() for t in (wq, wk, wv))
    _check_halves(w, want)
    want_b = np.zeros(2 * dkp + c, np.float32)
    want_b[:inner], want_b[dkp:dkp + inner], want_b[2 * dkp:] = (t.numpy() for t in (bq, bk, bv))
    assert np.array_equal(bias.numpy(), want_b)


@pytest.mark.parametrize("cin,cmid", [(128, 32), (40, 8), (24, 5), (3, 20)])
def test_k8_tf32_packings_hold_the_taps_and_the_out_conv(cin, cmid):
    """The taps: `_pack_taps`' (4, Cin, 4 Cmid) as (2, 4, 128, Cin padded to
    32), planar column slab * 32 + o, input channel k at K position
    8 (k // 8) + TF32_CHANNEL_ORDER.index(k % 8), zeros in the padding; the
    out-conv: (2, 16, 4, 32) at tap dy * 4 + dx, output channel, channel."""
    gen = torch.Generator().manual_seed(cin * cmid)
    folded = torch.randn(cin, cmid, 4, 4, generator=gen)
    ow = torch.randn(3, cmid, 4, 4, generator=gen)
    taps = _pack_taps_tf32(folded)
    cin_pad = -(-cin // 32) * 32
    assert taps.shape == (2, 4, 128, cin_pad) and taps.is_contiguous()
    wpk = _pack_taps(folded).numpy()
    want = np.zeros((4, 128, cin_pad), np.float32)
    for k in range(cin):
        pos = k // 8 * 8 + TF32_CHANNEL_ORDER.index(k % 8)
        for slab in range(4):
            want[:, slab * 32:slab * 32 + cmid, pos] = wpk[:, k, slab * cmid:(slab + 1) * cmid]
    _check_halves(taps, want)
    wo = _pack_out_conv_tf32(ow)
    assert wo.shape == (2, 16, 4, 32) and wo.is_contiguous()
    want = np.zeros((16, 4, 32), np.float32)
    want[:, :3, :cmid] = ow.permute(2, 3, 0, 1).reshape(16, 3, cmid).numpy()
    _check_halves(wo, want)


def test_k8_channel_order_is_the_fragments():
    """Lane t of stage A's A fragment reads channel 2 t into registers 0, 1
    (k position t) and 2 t + 1 into 2, 3 (k position t + 4), as the kernel's
    source has it: the packed taps' channel order follows."""
    text = (CSRC / "packed_tail.cu").read_text()
    assert "win + 2 * qd * CH" in text and "tf32_split(p[CH], ah[kk][2], al[kk][2]);" in text
    order = {}
    for lane in range(32):
        for reg in range(4):
            _, pos = _a_fragment_tf32(lane, reg)
            order[pos] = 2 * (lane % 4) + reg // 2
    assert tuple(order[p] for p in range(8)) == TF32_CHANNEL_ORDER


def test_k7_key_slots_invert_the_prepass_order():
    """The GEMM's epilogue writes key e of a group of 8 to slot key_slot(e),
    the inverse of the order in which the pre-pass stores V^T."""
    text = (CSRC / "sagan_block.cu").read_text()
    assert "return (e >> 1) + ((e & 1) << 2);" in text
    prepass = _prepass_key_order()
    assert [prepass[(e >> 1) + ((e & 1) << 2)] for e in range(8)] == list(range(8))

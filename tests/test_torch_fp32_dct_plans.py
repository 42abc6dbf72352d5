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

"""K9, HiFiC's ChannelNorm as one kernel (ops/channel_norm.py,
csrc/channel_norm.cu), and its plain twin.

On the CPU: the wrapper is the twin, which is the eager body
`ChannelNorm.forward` had before K9, bit for bit, at every (C, relu) HiFiC
uses, and launches nothing; K9's tile plan fits the card's shared memory;
an emulation of K9's order of sums against the twin at the card tests'
bars. On the card (marker `cuda`; they skip elsewhere): K9's NCHW and NHWC
routes against the twin run on the card at all six channel widths, the NHWC
route's element path, a HiFiC call's 29 launches (all NHWC), and what K9
refuses.

Bars, K9 against the twin: bfloat16, at least 99.9% of outputs identical
and the rest within one bf16 ulp of the twin's value or 1e-4, whichever is
larger. The two sum in other orders (K9: each thread's channels in turn,
then the warp, then the warps; the twin: var_mean's Welford reduction), so
a mean or a variance may differ in its last float32 bits, which moves a
value across a bf16 rounding boundary now and then, and more often where
x sits near the mean (cancellation). Float32 outputs carry those last bits
themselves, so there the bar is the second one on every output.

The file imports torch and the port only, so it runs on the card's machine:

    python -m pytest tests/test_torch_channel_norm.py --noconftest -q
"""

import re

import numpy as np
import pytest
import torch

from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.config import HiFiCConfig
from contextual_image_compression_tpu_torch.models.hific import ChannelNorm, HiFiCCodec
from contextual_image_compression_tpu_torch.ops import channel_norm as cn
from contextual_image_compression_tpu_torch.ops import cuda_kernels

EPS = HiFiCConfig().norm_eps
# (C, relu) of HiFiC's 29 norms: E's five with ReLU; G's norm_in (220) and
# head (960) without, the blocks' 960 with and without, the upsampling's
# four with
HIFIC_NORMS = [(60, True), (120, True), (240, True), (480, True), (960, True), (220, False),
               (960, False)]
WIDTHS = (60, 120, 220, 240, 480, 960)
SMEM_PER_SM = 233472      # bytes an H100 SM holds for its blocks
SMEM_PER_BLOCK = 232448   # the most one block may take
SMEM_RESERVED = 1024      # the card's own share of each block


def _source_constant(name):
    text = (cuda_kernels.CSRC_DIR / "channel_norm.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _inputs(b, c, h, w, dtype, seed):
    """Conv-like activations: per-channel offsets and spreads, so each
    pixel's mean is off zero; alpha and beta as the benchmark draws them."""
    rng = np.random.RandomState(seed)
    offset = rng.uniform(-1.0, 1.0, (1, c, 1, 1))
    spread = rng.uniform(0.2, 2.0, (1, c, 1, 1))
    x = rng.standard_normal((b, c, h, w)) * spread + offset
    alpha = rng.uniform(0.75, 1.25, c)
    beta = rng.uniform(-0.1, 0.1, c)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return t(x).to(dtype), t(alpha).to(dtype), t(beta).to(dtype)


def _forward_before_k9(x, weight, bias, eps, relu):
    """ChannelNorm.forward's body as it was before K9."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = torch.addcmul(bias.float()[:, None, None], y, weight.float()[:, None, None])
    if relu:
        y = torch.relu_(y)
    return y.to(x.dtype)


def _gaps(got, want):
    """(share identical, largest difference, whether every difference is
    within one bf16 ulp of the wanted value or 1e-4)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    within = bool((d <= torch.maximum(ulp, torch.full_like(ulp, 1e-4))).all())
    return float((d == 0).float().mean()), float(d.max()), within


def _check(got, want, dtype, label):
    same, worst, within = _gaps(got, want)
    assert within, f"{label}: largest difference {worst:.3e}, identical {same:.5f}"
    if dtype == torch.bfloat16:
        assert same >= 0.999, f"{label}: identical {same:.5f} (largest difference {worst:.3e})"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,relu", HIFIC_NORMS)
def test_cpu_wrapper_is_the_eager_body(c, relu, dtype):
    x, alpha, beta = _inputs(2, c, 6, 10, dtype, seed=c + relu)
    before = tops.launch_counts()
    got = cn.channel_norm(x, alpha, beta, EPS, relu)
    norm = ChannelNorm(c, EPS).to(dtype)
    with torch.no_grad():
        norm.weight.copy_(alpha)
        norm.bias.copy_(beta)
        from_module = norm(x, relu=relu)
    want = _forward_before_k9(x, alpha, beta, EPS, relu)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want) and torch.equal(from_module, want)
    assert tops.launch_counts() == before and tops.launch_counts()["K9"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,relu", HIFIC_NORMS)
def test_twin_on_channels_last_is_the_same_bits_in_channels_last(c, relu, dtype):
    x, alpha, beta = _inputs(2, c, 6, 10, dtype, seed=c + relu)
    xl = x.contiguous(memory_format=torch.channels_last)
    got = cn.channel_norm(xl, alpha, beta, EPS, relu)
    want = cn.channel_norm_plain(x, alpha, beta, EPS, relu)
    assert got.is_contiguous(memory_format=torch.channels_last) and not got.is_contiguous()
    assert want.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_twin_leaves_padding_channels_out(dtype):
    """Channels of a channels_last x past alpha's C are padding: the first
    C outputs are those of x without them, the rest 0, whatever the padding
    holds."""
    x, alpha, beta = _inputs(2, 60, 6, 10, dtype, seed=8)
    xp = torch.cat([x, torch.full_like(x[:, :4], -7.0)], dim=1).contiguous(
        memory_format=torch.channels_last)
    got = cn.channel_norm(xp, alpha, beta, EPS, True)
    assert got.shape == xp.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got[:, :60], cn.channel_norm_plain(x, alpha, beta, EPS, True))
    assert not got[:, 60:].any()


def test_k9_is_a_registered_wrapper():
    assert tops.KERNEL_WRAPPERS["K9"] is cn.channel_norm
    assert "K9" in tops.launch_counts()
    with pytest.raises(ValueError):
        cn.channel_norm(torch.empty((1, 8, 4, 4), device="meta"), torch.empty(8, device="meta"),
                        torch.empty(8, device="meta"), EPS)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", WIDTHS)
def test_tile_plan_fits_the_card(c, itemsize):
    """The tile is a power of two of 16-byte rows, one tile within
    TILE_BYTES, and three tiles with the partial sums, statistics, alpha
    and beta fit one block an SM."""
    threads, stages, quad = (_source_constant(n) for n in ("THREADS", "STAGES", "QUAD"))
    assert threads == cn.THREADS and cn.MAX_TILE_PIXELS == quad * threads
    p = cn.tile_pixels(c, itemsize)
    assert p & (p - 1) == 0 and p * itemsize % 16 == 0 and quad <= p <= cn.MAX_TILE_PIXELS
    assert c * p * itemsize <= cn.TILE_BYTES
    if itemsize == 2:  # the served dtype: rows of at least 64 bytes
        assert p * itemsize >= 64
    smem = stages * c * p * itemsize + 4 * (threads * quad + 2 * p + 2 * c)
    assert smem <= SMEM_PER_BLOCK and smem + SMEM_RESERVED <= SMEM_PER_SM


@pytest.mark.parametrize("c,want", [(60, 512), (120, 256), (220, 128), (240, 128), (480, 64),
                                    (960, 32), (3000, 8)])
def test_tile_plan_in_bf16(c, want):
    """The widths measured on the card (PERF.md, K9); a width too wide for
    64 KB keeps the least tile, one 16-byte copy a channel row."""
    assert cn.tile_pixels(c, 2) == want


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("row", [64, 120, 220, 240, 480, 960, 6, 13, 1024])
def test_nhwc_plan_fits_the_card(row, itemsize):
    """The NHWC route's tiles: a multiple of 8 pixels (16-byte aligned
    spans) and of the block's round, within NHWC_TILE_BYTES unless one round
    is more, two blocks an SM; the lanes hold the row at LANE_QUADS quads a
    lane."""
    threads, stages, lane_quads = (_source_constant(n) for n in
                                   ("THREADS", "STAGES", "LANE_QUADS"))
    assert (threads, lane_quads) == (cn.THREADS, cn.LANE_QUADS)
    p, lanes = cn.nhwc_plan(row, itemsize)
    quads = -(-row // 4)
    slots = 1
    while slots * lanes < quads:
        slots *= 2
    per_round = threads // 32 * (32 // lanes) * (lane_quads // slots)
    assert lanes & (lanes - 1) == 0 and lanes <= 32 and slots <= lane_quads
    assert p % 8 == 0 and p % per_round == 0
    assert p == per_round or p * row * itemsize <= cn.NHWC_TILE_BYTES
    smem = stages * p * row * itemsize + 4 * 2 * 4 * quads
    assert 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM


@pytest.mark.parametrize("row,want", [(64, (256, 4)), (120, (128, 8)), (220, (64, 16)),
                                      (240, (64, 16)), (480, (32, 32)), (960, (16, 32))])
def test_nhwc_plan_in_bf16(row, want):
    """The served rows measured on the card (PERF.md, K9)."""
    assert cn.nhwc_plan(row, 2) == want
    with pytest.raises(ValueError):
        cn.nhwc_plan(cn.NHWC_MAX_CHANNELS + 4, 2)


def _k9_order(x, weight, bias, eps, relu):
    """K9's arithmetic on the CPU: its tile plan, each thread's channels
    summed in turn, the shuffle butterfly inside a warp, the rows of partial
    sums in order; fmaf as a float64 product and sum rounded to float32."""
    b, c, h, w = x.shape
    p = cn.tile_pixels(c, x.element_size())
    quads = p // 4
    k_count = cn.THREADS // quads
    v = x.float().reshape(b, c, h * w)
    zero = torch.zeros(b, h * w)

    def block_sum(terms, fused):
        parts = []
        for k in range(k_count):
            acc = zero
            for ch in range(k, c, k_count):
                if fused:  # fmaf(d, d, acc)
                    d = terms[:, ch].double()
                    acc = (d * d + acc.double()).float()
                else:
                    acc = acc + terms[:, ch]
            parts.append(acc)
        if quads < 32:  # threads of one quad share a warp: xor butterfly
            per_warp = 32 // quads
            rows = [_butterfly(parts[warp * per_warp:(warp + 1) * per_warp])
                    for warp in range(k_count // per_warp)]
        else:
            rows = parts
        acc = zero
        for r in rows:
            acc = acc + r
        return acc / c

    mean = block_sum(v, False)
    rstd = torch.rsqrt(block_sum(v - mean[:, None], True) + eps)
    t = (v - mean[:, None]) * rstd[:, None]
    y = (t.double() * weight.float().double()[:, None] + bias.float().double()[:, None]).float()
    if relu:
        y = torch.relu(y)
    return y.reshape(b, c, h, w).to(x.dtype)


def _butterfly(vals):
    """A warp's xor butterfly over len(vals) lanes: every lane ends with the
    same sum (a + b and b + a round alike), lane 0's is returned."""
    off = 1
    while off < len(vals):
        vals = [vals[i] + vals[i ^ off] for i in range(len(vals))]
        off *= 2
    return vals[0]


def _k9_nhwc_order(x, weight, bias, eps, relu):
    """K9's NHWC route on the CPU: L lanes a pixel (`nhwc_plan`), lane l
    taking quads l, l + L, ... in turn into four partials (a quad's i-th
    channel into the i-th), combined (p0 + p1) + (p2 + p3), then the xor
    butterfly over the L lanes; the squared deviations alike, channels past C
    (x's padding channels, or a ragged row's end) left out; fmaf as a
    float64 product and sum rounded to float32."""
    b, s, h, w = x.shape
    c = weight.shape[0]
    quads = -(-s // 4)
    lanes = cn.nhwc_plan(s, x.element_size())[1]
    slots = 1
    while slots * lanes < quads:
        slots *= 2
    v = x.float().permute(0, 2, 3, 1).reshape(-1, s)[:, :c]
    padded = torch.zeros(v.shape[0], slots * lanes * 4)
    padded[:, :c] = v
    inside = (torch.arange(slots * lanes * 4) < c).reshape(slots, lanes, 4)
    v4 = padded.reshape(-1, slots, lanes, 4)  # quad j * L + l at [:, j, l]

    def lane_sums(fused, mean=None):
        out = []
        for lane in range(lanes):
            parts = [torch.zeros(v4.shape[0]) for _ in range(4)]
            for j in range(slots):
                for i in range(4):
                    t = v4[:, j, lane, i]
                    if fused:  # fmaf(d, d, acc) where the channel is inside C
                        d = (t - mean).double()
                        parts[i] = torch.where(inside[j, lane, i],
                                               (d * d + parts[i].double()).float(), parts[i])
                    else:
                        parts[i] = parts[i] + t
            out.append((parts[0] + parts[1]) + (parts[2] + parts[3]))
        return out

    mean = _butterfly(lane_sums(False)) / c
    rstd = torch.rsqrt(_butterfly(lane_sums(True, mean)) / c + eps)
    t = (v - mean[:, None]) * rstd[:, None]
    y = (t.double() * weight.float().double() + bias.float().double()).float()
    if relu:
        y = torch.relu(y)
    y = torch.nn.functional.pad(y, (0, s - c))
    return y.reshape(b, h, w, s).permute(0, 3, 1, 2).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,relu", HIFIC_NORMS)
def test_k9_order_of_sums_within_the_bars(c, relu, dtype):
    """The card tests' bars hold between each of K9's routes' order of sums
    and the twin's, here on the CPU (the card's twin sums in yet another
    order)."""
    x, alpha, beta = _inputs(2, c, 16, 24, dtype, seed=100 + c)
    want = cn.channel_norm_plain(x, alpha, beta, EPS, relu)
    _check(_k9_order(x, alpha, beta, EPS, relu), want, dtype, f"C {c}")
    _check(_k9_nhwc_order(x, alpha, beta, EPS, relu), want, dtype, f"C {c}, NHWC")
    if c % 8:  # HiFiC's served rows of 60 channels carry 4 padding channels
        xp = torch.cat([x, torch.full_like(x[:, :8 - c % 8], 3.0)], dim=1)
        _check(_k9_nhwc_order(xp, alpha, beta, EPS, relu),
               cn.channel_norm_plain(xp, alpha, beta, EPS, relu), dtype, f"C {c} of a row of 64")


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hw", [(48, 64), (24, 41), (37, 29)],
                         ids=["whole-tiles", "ragged-tile", "unaligned-rows"])
@pytest.mark.parametrize("c", WIDTHS)
def test_k9_matches_twin(dev, c, hw, dtype, relu):
    """Both routes, the NCHW one on x and the NHWC one on a channels_last
    copy. NCHW: (24, 41), 984 pixels, a multiple of no tile, rows 16-byte
    aligned; (37, 29), 1073 pixels, rows unaligned (the element route).
    NHWC: whole tiles, and ragged last tiles of 984 and 1073 pixels."""
    x, alpha, beta = (t.to(dev) for t in _inputs(2, c, *hw, dtype, seed=c * 7 + hw[1]))
    xl = x.contiguous(memory_format=torch.channels_last)
    n, n_nhwc = cn.channel_norm.launches, cn.channel_norm.launches_nhwc
    with torch.no_grad():
        got = cn.channel_norm(x, alpha, beta, EPS, relu)
        got_nhwc = cn.channel_norm(xl, alpha, beta, EPS, relu)
        want = cn.channel_norm_plain(x, alpha, beta, EPS, relu)
    torch.cuda.synchronize()
    assert cn.channel_norm.launches == n + 2 and cn.channel_norm.launches_nhwc == n_nhwc + 1
    assert got.is_contiguous() and got_nhwc.is_contiguous(memory_format=torch.channels_last)
    _check(got, want, dtype, f"C {c} {hw} {dtype}")
    _check(got_nhwc, want, dtype, f"C {c} {hw} {dtype} NHWC")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,row", [(60, 64), (220, 224), (13, 16)])
def test_k9_nhwc_padded_rows(dev, c, row, dtype):
    """HiFiC's served rows: C channels of a row of `row`, the padding
    holding other values than 0 on the way in and 0 on the way out; 1073
    pixels, a ragged last tile."""
    x, alpha, beta = (t.to(dev) for t in _inputs(1, c, 37, 29, dtype, seed=c + row))
    xp = torch.cat([x, torch.full_like(x[:, :row - c], 5.0)], dim=1).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = cn.channel_norm(xp, alpha, beta, EPS, True)
    assert got.shape == xp.shape and not got[:, c:].any()
    _check(got[:, :c], cn.channel_norm_plain(x, alpha, beta, EPS, True), dtype, f"C {c} of {row}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [6, 30, 13])
def test_k9_nhwc_element_route(dev, c, dtype):
    """Widths that are no multiple of 4 channels (6, 30) or odd (13) and an
    x at an offset of 2 elements from its allocation: the NHWC route's
    element loads and stores."""
    x, alpha, beta = (t.to(dev) for t in _inputs(2, c, 19, 23, dtype, seed=c))
    xl = x.contiguous(memory_format=torch.channels_last)
    buf = torch.empty(xl.numel() + 2, dtype=dtype, device=dev)
    shifted = buf[2:].as_strided(xl.shape, xl.stride())
    shifted.copy_(xl)
    want = cn.channel_norm_plain(x, alpha, beta, EPS, True)
    for xin in (xl, shifted):
        with torch.no_grad():
            got = cn.channel_norm(xin, alpha, beta, EPS, True)
        _check(got, want, dtype, f"C {c} NHWC")


@pytest.mark.cuda
def test_k9_reads_bf16_parameters_and_float32_input(dev):
    x, alpha, beta = (t.to(dev) for t in _inputs(2, 240, 16, 16, torch.float32, seed=3))
    got = cn.channel_norm(x, alpha.bfloat16(), beta.bfloat16(), EPS, True)
    want = cn.channel_norm_plain(x, alpha.bfloat16(), beta.bfloat16(), EPS, True)
    _check(got, want, torch.float32, "bf16 parameters")


@pytest.mark.cuda
def test_hific_call_launches_k9_29_times(dev):
    codec = HiFiCCodec(HiFiCConfig())
    codec.reset_parameters(0)
    codec = codec.to(dev).prepare_serving()
    x = torch.rand(1, 3, 192, 256, device=dev).to(torch.bfloat16)
    n, n_nhwc = cn.channel_norm.launches, cn.channel_norm.launches_nhwc
    with torch.no_grad():
        out = codec.apply(x)
    torch.cuda.synchronize()
    assert cn.channel_norm.launches - n == 29
    assert cn.channel_norm.launches_nhwc - n_nhwc == 29  # the served form is channels_last
    assert bool(torch.isfinite(out.x_hat.float()).all())


@pytest.mark.cuda
def test_k9_refuses_what_it_does_not_take(dev):
    x, alpha, beta = (t.to(dev) for t in _inputs(1, 60, 8, 8, torch.float32, seed=4))
    with pytest.raises(ValueError):
        cn.channel_norm(x.clone().requires_grad_(True), alpha, beta, EPS)
    with pytest.raises(ValueError):
        cn.channel_norm(x.transpose(2, 3), alpha, beta, EPS)
    with pytest.raises(TypeError):
        cn.channel_norm(x.half(), alpha, beta, EPS)
    xl = x.contiguous(memory_format=torch.channels_last)  # taken, on the NHWC route
    n = cn.channel_norm.launches_nhwc
    _check(cn.channel_norm(xl, alpha, beta, EPS), cn.channel_norm_plain(x, alpha, beta, EPS),
           torch.float32, "channels_last")
    assert cn.channel_norm.launches_nhwc == n + 1
    wide = torch.zeros(1, cn.NHWC_MAX_CHANNELS + 4, 2, 2, device=dev).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        cn.channel_norm(wide, torch.ones(wide.shape[1], device=dev),
                        torch.zeros(wide.shape[1], device=dev), EPS)

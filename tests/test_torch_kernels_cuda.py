"""The port's CUDA kernels against their plain PyTorch twins, on the card, in
the cases chip_smoke.py does not run: ragged sizes, B = 1, K1 and K4 on the
cluster route with halos that span several blocks, a height that is not a
multiple of the cluster, other filter sizes, and on the tiled route, K1's
bf16 route at B = 1, 4 and 16 on 64^2, 256^2 and 336^2 (tiled) and at odd
widths on both routes, K3 and
K3b with score and strength in bf16 (B, 1) and float32 (B,), K2's backward,
K2 and K6 in bf16 at every key width (DK 4..64) and value width, N from 1 to
1024 at B = 1 and 3, on unaligned inputs and with every row's max in the last
key tile, K2 and K6 in float32 (three TF32 passes, route "tf32x3") at DK 5
and 33, DV 64 and 256, N 1, 100 and 1024, on unaligned inputs and with every
row's max in the last key tile, K3b under autograd, K2 in bf16 under autograd (mixed-precision training)
on the "wgmma" route, the W8A8 int8 product (`torch._int_mm`) against the
exact CPU product, K4 on non-square and
all-zero maps, K5 at the smallest and a ragged width, at the extreme quality
tables, at B = 128 (the persistent walk wrapping many times) and on unaligned
planes, K6 and K7 at ragged N
and value widths 64 and 128, K7b on a permuted (non-contiguous) view, K7 in
bf16 ("wgmma") and in float32 (three TF32 passes, "tf32x3") at DK 8, 16 and
32, the float32 kernel's contiguous epilogue for K2 and K7a and its strided
one for K7b, K7's backward, K8 at an odd batch, a ragged size, Cin not a
multiple of 16, the full path shape and in float32 (TMA windows, and its own
loads at W = 9), each K7 / K8 call on the route its dtype takes, and K8's
int8 route against the PyTorch int8 tail it replaces in serving (small and
full width, amax varying by channel) and once a prepared generator's call.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels build at
first use); elsewhere they skip. The file imports torch only, so it runs on a
machine without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

(`--noconftest` skips tests/conftest.py, which imports JAX to set up its
CPU mesh.)
"""

import pytest
import torch

from contextual_image_compression_tpu_torch.ops import image_ops, saliency
from contextual_image_compression_tpu_torch.ops.attention import (
    attention_block,
    attention_block_plain,
    attention_core,
    attention_core_plain,
    sagan_block,
    sagan_block_jnp,
    sagan_block_plain,
    sagan_block_spatial,
)
from contextual_image_compression_tpu_torch.ops.generator_tail import (
    fused_tail,
    fused_tail_plain,
)
from contextual_image_compression_tpu_torch.config import QuantizerConfig
from contextual_image_compression_tpu_torch.ops.dct import (
    dct_strips,
    dct_strips_plain,
    quality_tables,
)
from contextual_image_compression_tpu_torch.ops.fused_mask import (
    _mask_plan,
    contextual_mask,
    contextual_mask_plain,
    smooth_mask,
    smooth_mask_plain,
)
from contextual_image_compression_tpu_torch.ops.quantize import (
    adaptive_quantize,
    adaptive_quantize_bwd,
    adaptive_quantize_bwd_plain,
    adaptive_quantize_plain,
)
from torch_port_helpers import late_max_attention_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(dev, b, h, w):
    gen = torch.Generator(device=dev).manual_seed(h * w + b)
    u8 = (torch.rand(b, h, w, 3, device=dev, generator=gen) * 255).to(torch.uint8)
    gray = image_ops.rgb_to_gray(u8.float()).contiguous()
    spec = saliency.spectral_residual_small(gray, min(64, h, w), 3.0).contiguous()
    return gray, spec


def _route_of(wrapper, call):
    """Run call(); assert one launch of the wrapper and return its route."""
    before = dict(wrapper.route_launches)
    n = wrapper.launches
    out = call()
    assert wrapper.launches == n + 1
    moved = [r for r in before if wrapper.route_launches[r] != before[r]]
    assert len(moved) == 1
    return out, moved[0]


@pytest.mark.parametrize("shape", [(3, 200, 200), (1, 256, 256), (2, 48, 64), (2, 50, 64)],
                         ids=["ragged-200", "B1", "halo-spans-ranks-48x64", "ragged-rank-50x64"])
def test_k1_ragged_matches_twin(dev, shape):
    """200 is not a multiple of the 6-block cluster (34 rows a block, the
    last owning 30); at 48 rows a block owns 8, so the 15-row Gaussian halo
    comes from blocks up to 2 away and reflects into rows other blocks own;
    at 50 rows the last block owns 5 of 9. chip_smoke.py holds K1 at
    (16, 256, 256). Bar 1e-4."""
    gray, spec = _k1_inputs(dev, *shape)
    assert _mask_plan(shape[1], shape[2], 6, 4, 31).route == "cluster"
    got, route = _route_of(contextual_mask, lambda: contextual_mask(gray, spec))
    assert route == "cluster"
    want = contextual_mask_plain(gray, spec)
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, contextual_mask(gray, spec))  # no atomics: bitwise repeatable


def test_k1_spectral_map_larger_than_the_image(dev):
    """32^2 images with the default 64^2 spectral map (the tiny codec that
    chip_smoke.py serves from its JAX-trained checkpoint): the map shrinks
    by the antialiased resize before the kernel, as in the twin. Bar 1e-4."""
    gray, _ = _k1_inputs(dev, 3, 32, 32)
    spec = saliency.spectral_residual_small(gray, 64, 3.0).contiguous()
    assert tuple(spec.shape) == (3, 64, 64)
    got, route = _route_of(contextual_mask, lambda: contextual_mask(gray, spec))
    assert route == "cluster"
    assert (got - contextual_mask_plain(gray, spec)).abs().max().item() <= 1e-4


def test_k1_cluster_shapes_in_any_order(dev):
    """A large image after a small one: the kernel's shared-memory limit is
    set once for the most a block may use, so the 256^2 call launches after
    a 32 x 64 call with its smaller strips (a limit set per shape refused it
    with cudaErrorInvalidValue); 300^2 takes clusters of 8."""
    for shape in [(1, 256, 256), (1, 32, 64), (1, 256, 256), (1, 300, 300)]:
        gray, spec = _k1_inputs(dev, *shape)
        got = contextual_mask(gray, spec)
        assert (got - contextual_mask_plain(gray, spec)).abs().max().item() <= 1e-4


def test_k1_other_filter_sizes_match_twin(dev):
    """scales (1, 3), bilateral d = 5, Gaussian 15: the cluster kernel's
    generic instantiation (the default sizes are compiled unrolled)."""
    kw = dict(scales=(1, 3), d=5, gauss_ksize=15)
    gray, spec = _k1_inputs(dev, 2, 48, 64)
    got, route = _route_of(contextual_mask, lambda: contextual_mask(gray, spec, **kw))
    assert route == "cluster"
    assert (got - contextual_mask_plain(gray, spec, **kw)).abs().max().item() <= 1e-4


def test_k1_tiled_route_matches_twin(dev):
    """360^2 strips do not fit a cluster's shared memory: six tiled launches."""
    gray, spec = _k1_inputs(dev, 1, 360, 360)
    got, route = _route_of(contextual_mask, lambda: contextual_mask(gray, spec))
    assert route == "tiled"
    assert (got - contextual_mask_plain(gray, spec)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("size", [64, 256, 336])
def test_k1_bf16_matches_twin(dev, b, size):
    """K1's bf16 route (compute_dtype=bfloat16) against its bf16 twin on the
    card: bit-identical (every bf16 operation rounded once, in the twin's
    order), one launch a call, on the cluster route up to 256^2 and the
    tiled one at 336^2 (route names with "_bf16"), bitwise repeatable, and
    within JAX's 5e-2 of the float32 kernel."""
    gray, spec = _k1_inputs(dev, b, size, size)
    call = lambda: contextual_mask(gray, spec, compute_dtype=torch.bfloat16)  # noqa: E731
    got, route = _route_of(contextual_mask, call)
    assert route == ("tiled_bf16" if size == 336 else "cluster_bf16")
    want = contextual_mask_plain(gray, spec, compute_dtype=torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(got, call())
    assert (got - contextual_mask(gray, spec)).abs().max().item() <= 5e-2


@pytest.mark.parametrize("shape,route", [
    ((2, 255, 255), "cluster_bf16"), ((3, 40, 61), "cluster_bf16"), ((1, 48, 64), "cluster_bf16"),
    ((2, 337, 341), "tiled_bf16"), ((1, 360, 365), "tiled_bf16")],
    ids=["odd-255", "odd-40x61", "halo-spans-ranks-48x64", "tiled-odd-337x341",
         "tiled-odd-360x365"])
def test_k1_bf16_pairs_at_odd_widths_match_twin(dev, shape, route):
    """K1's bf16 route computes two adjacent columns a thread: at an odd
    width the last pair's right lane is masked (computed, never written),
    on the cluster route (warp tasks of 52 box-sum columns, so 255 and 61
    end inside a task; 48 rows: halos from blocks up to 2 away) and on the
    tiled route (the last 32-wide tile ragged and odd). Bit-identical to the
    bf16 twin."""
    gray, spec = _k1_inputs(dev, *shape)
    call = lambda: contextual_mask(gray, spec, compute_dtype=torch.bfloat16)  # noqa: E731
    got, taken = _route_of(contextual_mask, call)
    assert taken == route
    assert torch.equal(got, contextual_mask_plain(gray, spec, compute_dtype=torch.bfloat16))


def test_k1_bf16_other_filter_sizes_match_twin(dev):
    """The bf16 cluster kernel's generic instantiation (scales (1, 3),
    d = 5, ksize 15: runtime loops, odd radius 3 so the box's halo lanes
    cover 2 pairs) at an odd width: bit-identical to the bf16 twin."""
    kw = dict(scales=(1, 3), d=5, gauss_ksize=15, compute_dtype=torch.bfloat16)
    gray, spec = _k1_inputs(dev, 2, 48, 63)
    got, route = _route_of(contextual_mask, lambda: contextual_mask(gray, spec, **kw))
    assert route == "cluster_bf16"
    assert torch.equal(got, contextual_mask_plain(gray, spec, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_ragged_matches_twin(dev, dtype):
    """N = 100 is not a multiple of the 64-row tile; chip_smoke.py holds K2 at
    the serving shapes. In bf16 the residual is 0, so the 2e-2 bar is relative
    to the attention term itself and not to the residual's rounding."""
    n, dk, dv = 100, 8, 64
    gen = torch.Generator(device=dev).manual_seed(n)
    q = (torch.randn(2, n, dk, device=dev, generator=gen) * 0.5).to(dtype)
    k = (torch.randn(2, n, dk, device=dev, generator=gen) * 0.5).to(dtype)
    v = torch.randn(2, n, dv, device=dev, generator=gen).to(dtype)
    r = torch.randn(2, n, dv, device=dev, generator=gen).to(dtype)
    if dtype == torch.bfloat16:
        r = torch.zeros_like(r)
    g = torch.tensor(0.5, device=dev)
    got = attention_block(q, k, v, r, g).float()
    want = attention_block_plain(q, k, v, r, g).float()
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5
    else:
        assert err <= 2e-2 * want.abs().max().item()


def test_k2_backward_runs_through_plain_formula(dev):
    q, k = (torch.randn(1, 64, 8, device=dev, requires_grad=True) for _ in range(2))
    v = torch.randn(1, 64, 64, device=dev, requires_grad=True)
    g = torch.tensor(0.5, device=dev, requires_grad=True)
    attention_block(q, k, v, v, g).sum().backward()
    grads = torch.autograd.grad(attention_block_plain(q, k, v, v, g).sum(), (q, k, v, g))
    for got, want in zip((q.grad, k.grad, v.grad, g.grad), grads):
        assert torch.allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("b,n,dk,dv", [(16, 1024, 32, 256), (4, 16, 3, 24)],
                         ids=["full-width", "tiny-mixed"])
def test_k2_bf16_under_autograd_takes_the_wgmma_route(dev, b, n, dk, dv):
    """K2 in mixed-precision training: bf16 q, k, v and residual that need
    gradients and gamma cast from a float32 parameter, as SelfAttention
    gives them. The forward launches the kernel once on the "wgmma" route
    (>= 99% of outputs bit-identical to the twin, the rest within one bf16
    ulp of the output's scale); the backward is autograd over the twin, so
    every gradient equals the twin's own autograd bit for bit, and gamma's
    reaches the float32 parameter in float32."""
    gen = torch.Generator(device=dev).manual_seed(b * n + dk)

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    base = [mk(b, n, dk, scale=0.5), mk(b, n, dk, scale=0.5), mk(b, n, dv), mk(b, n, dv)]
    up = mk(b, n, dv)
    grads = []
    for fn in ("kernel", "twin"):
        ins = [t.clone().requires_grad_(True) for t in base]
        gamma_p = torch.nn.Parameter(torch.full((1,), 0.5, device=dev))
        gamma = gamma_p.to(torch.bfloat16)[0]
        if fn == "kernel":
            out, route = _route_of(attention_block, lambda: attention_block(*ins, gamma))
            assert route == "wgmma" and out.dtype == torch.bfloat16
            kernel_out = out
        else:
            out = attention_block_plain(*ins, gamma.float())
            assert out.dtype == torch.bfloat16
            same = (kernel_out == out).float().mean().item()
            err = (kernel_out.float() - out.float()).abs().max().item()
            assert same >= 0.99 and err <= 2 ** -8 * out.float().abs().max().item(), (same, err)
        out.backward(up)
        assert gamma_p.grad.dtype == torch.float32
        grads.append([t.grad for t in ins] + [gamma_p.grad])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(16, 131072, 1024), (16, 1024, 131072), (3, 100, 20),
                                   (40, 64, 8)])
def test_int8_matmul_and_w8a8_dense_match_the_cpu(dev, m, k, n):
    """`torch._int_mm` (cuBLAS) through `layers.int8_matmul`, rows padded to
    24 and K, N to multiples of 8 with zeros, against the exact int32
    product on the CPU; at the full-width latent dense and fc shapes (B =
    16) with saturated +-127 rows among random ones. The W8A8 dense built on
    it (`layers.dense_w8a8`) equals the CPU's bit for bit: its float32 steps
    are IEEE divisions, products and roundings on both."""
    from contextual_image_compression_tpu_torch.models.layers import dense_w8a8, int8_matmul

    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    a[0] = 127
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    b[:, 0] = 127
    got = int8_matmul(a.to(dev), b.to(dev))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), int8_matmul(a, b))
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16)
    x[1 % m] = 0
    w = torch.randn(n, k, generator=gen) * 0.02
    bias = torch.randn(n, generator=gen) * 0.1
    y = dense_w8a8(x.to(dev), w.to(dev), bias.to(dev))
    assert y.dtype == torch.bfloat16
    assert torch.equal(y.cpu(), dense_w8a8(x, w, bias))


def _bf16_attention(dev, kind, b, n, dk, dv, seed, misalign=False):
    """K2 (residual 0, gamma 0.5) or K6 in bf16 against its twin; returns
    (kernel, twin). misalign: q, k, v and a random residual start 2 bytes
    past a 16-byte boundary, so the kernel stages K and V with ordinary loads,
    not TMA, and reads the residual without 16-byte loads."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(*shape, scale=1.0):
        x = (torch.randn(*shape, device=dev, generator=gen) * scale).to(torch.bfloat16)
        if not misalign:
            return x
        buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=dev)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(*shape)

    q, k, v = mk(b, n, dk, scale=0.5), mk(b, n, dk, scale=0.5), mk(b, n, dv)
    return _run_bf16(kind, q, k, v, mk(b, n, dv) if misalign else None)


def _run_bf16(kind, q, k, v, r=None):
    if kind == "K2":
        r = torch.zeros_like(v) if r is None else r
        g = torch.tensor(0.5, device=q.device)
        before = attention_block.launches
        got = attention_block(q, k, v, r, g)
        assert attention_block.launches == before + 1
        return got, attention_block_plain(q, k, v, r, g)
    before = attention_core.launches
    got = attention_core(q, k, v)
    assert attention_core.launches == before + 1
    return got, attention_core_plain(q, k, v)


@pytest.mark.parametrize("kind", ["K2", "K6"])
@pytest.mark.parametrize("dv", [64, 128, 256])
@pytest.mark.parametrize("dk", [4, 8, 16, 32, 64])
def test_bf16_attention_widths_match_twin(dev, kind, dk, dv):
    """The tensor-core kernel at every value width and at key widths staged by
    the producer warp (DK = 4: rows of 8 bytes) and by TMA (8 .. 64), DK
    zero-padded to a multiple of 16; N = 100 is a partial 128-row block and a
    partial 64-key tile. Bar 2e-2 of max |out|."""
    got, want = _bf16_attention(dev, kind, 3, 100, dk, dv, 10 * dk + dv)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel_err(got, want) <= 2e-2


@pytest.mark.parametrize("kind", ["K2", "K6"])
@pytest.mark.parametrize("dk,dv,n", [(3, 24, 16), (5, 100, 100), (32, 200, 64)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_attention_value_widths_off_the_tile_match_twin(dev, kind, dk, dv, n, dtype):
    """A value width that is not a multiple of 64 is zero-padded to one and
    the output cut back (Dk 3, Dv 24 and N 16 are the tiny codec's, which
    chip_smoke.py serves from the JAX-trained checkpoint). Bars 2e-2 of max
    |out| (bf16) and 1e-5 (float32)."""
    if dtype == "f32":
        assert _f32_attention(dev, kind, 2, n, dk, dv, dk + dv) <= 1e-5
        return
    got, want = _bf16_attention(dev, kind, 2, n, dk, dv, dk + dv)
    assert got.shape == want.shape == (2, n, dv) and got.is_contiguous()
    assert _rel_err(got, want) <= 2e-2


@pytest.mark.parametrize("kind", ["K2", "K6"])
@pytest.mark.parametrize("b,n", [(1, 1), (1, 100), (1, 1024), (3, 1), (3, 100), (3, 1024)])
def test_bf16_attention_sizes_match_twin(dev, kind, b, n):
    """One key, a partial tile and the serving N, at B = 1 and a batch of 3
    (DK = 32, DV = 256). Bar 2e-2 of max |out|."""
    got, want = _bf16_attention(dev, kind, b, n, 32, 256, b * n)
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= 2e-2


@pytest.mark.parametrize("kind", ["K2", "K6"])
def test_bf16_attention_unaligned_inputs_match_twin(dev, kind):
    got, want = _bf16_attention(dev, kind, 2, 300, 32, 128, 300, misalign=True)
    assert _rel_err(got, want) <= 2e-2


@pytest.mark.parametrize("kind", ["K2", "K6"])
def test_bf16_attention_rounds_at_the_global_max(dev, kind):
    """Every row's largest score is at key 1000, in the last 64-key tile, and
    the earlier tiles carry most of the weight (`late_max_attention_inputs`).
    The kernel's second pass forms exp(s - m) with m the max over all keys,
    as the TPU kernel and the twin do, so the rounded numerators are the
    twin's and at least 99% of the outputs match it bit for bit. A running
    max rounds the earlier tiles at smaller maxima: on these inputs
    `attention_running_max` matches the twin on about half the outputs
    (tests/test_torch_ops.py::test_late_max_inputs_tell_global_from_running_max)."""
    q, k, v = (t.to(dev) for t in late_max_attention_inputs())
    scores = torch.einsum("bnd,bmd->bnm", q.float(), k.float())
    assert bool((scores.argmax(-1) == 1000).all())
    got, want = _run_bf16(kind, q, k, v)
    assert _rel_err(got, want) <= 2e-2
    assert (got == want).float().mean().item() >= 0.99


def _f32_attention(dev, kind, b, n, dk, dv, seed, misalign=False, inputs=None):
    """K2 (random residual, gamma 0.5) or K6 in float32 against its twin;
    asserts that the call added one launch on the "tf32x3" route and no
    other. misalign: q, k, v and the residual start 4 bytes past a 16-byte
    boundary. Returns max |kernel - twin|."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(*shape, scale=1.0):
        x = torch.randn(*shape, device=dev, generator=gen) * scale
        if not misalign:
            return x
        buf = torch.empty(x.numel() + 1, device=dev)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(*shape)

    if inputs is None:
        q, k, v = mk(b, n, dk, scale=0.5), mk(b, n, dk, scale=0.5), mk(b, n, dv)
    else:
        q, k, v = (t.to(dev).float() for t in inputs)
    wrapper = attention_block if kind == "K2" else attention_core
    if kind == "K2":
        r, g = mk(*v.shape), torch.tensor(0.5, device=dev)
        call, want = (lambda: attention_block(q, k, v, r, g)), attention_block_plain(q, k, v, r, g)
    else:
        call, want = (lambda: attention_core(q, k, v)), attention_core_plain(q, k, v)
    got, route = _route_of(wrapper, call)
    assert route == "tf32x3" and got.dtype == torch.float32 and got.shape == want.shape
    return (got - want).abs().max().item()


@pytest.mark.parametrize("kind", ["K2", "K6"])
@pytest.mark.parametrize("dv", [64, 256])
@pytest.mark.parametrize("dk", [5, 33])
def test_f32_attention_widths_match_twin(dev, kind, dk, dv):
    """The three-pass TF32 kernel at key widths that are not multiples of 8
    (zero-padded to 32 and 64 in the pre-pass) and the smallest and largest
    value widths; N = 100 is a partial 128-row block and a partial 32-key
    tile. Bar 1e-5."""
    assert _f32_attention(dev, kind, 2, 100, dk, dv, 10 * dk + dv) <= 1e-5


@pytest.mark.parametrize("kind", ["K2", "K6"])
@pytest.mark.parametrize("b,n", [(1, 1), (3, 1), (1, 100), (3, 100), (2, 1024)])
def test_f32_attention_sizes_match_twin(dev, kind, b, n):
    """One key, a partial tile and the path's N (DK = 32, DV = 256). Bar 1e-5."""
    assert _f32_attention(dev, kind, b, n, 32, 256, 7 * b + n) <= 1e-5


@pytest.mark.parametrize("kind", ["K2", "K6"])
def test_f32_attention_unaligned_inputs_match_twin(dev, kind):
    assert _f32_attention(dev, kind, 2, 300, 32, 128, 301, misalign=True) <= 1e-5


@pytest.mark.parametrize("kind", ["K2", "K6"])
def test_f32_attention_late_max_matches_twin(dev, kind):
    """Every row's largest score is in the last key tile
    (`late_max_attention_inputs`, here in float32): the kernel's e = exp(s -
    m) at the global max is the twin's. Bar 1e-5."""
    inputs = late_max_attention_inputs()
    assert _f32_attention(dev, kind, 2, 1024, 32, 256, 0, inputs=inputs) <= 1e-5


def _k3b_case(dev, b, d, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = (torch.randn(b, d, device=dev, generator=gen) * 2).to(dtype)
    g = torch.randn(b, d, device=dev, generator=gen).to(dtype)
    s = torch.rand(b, 1, device=dev, generator=gen)
    q = torch.rand(b, 1, device=dev, generator=gen) * 0.9 + 0.05
    return z, s, q, g


@pytest.mark.parametrize("b,d", [(16, 100), (16, 1000), (1, 1024), (1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3b_ragged_matches_twin(dev, b, d, dtype):
    """D not a multiple of the 256-thread block, B = 1 and D = 1. The bar is
    1e-5 of the row's sum of |terms| times the chain factor (the sums run in
    other orders)."""
    z, s, q, g = _k3b_case(dev, b, d, dtype, d)
    before = adaptive_quantize_bwd.launches
    got = adaptive_quantize_bwd(z, s, q, g)
    assert adaptive_quantize_bwd.launches == before + 1
    want = adaptive_quantize_bwd_plain(z, s, q, g)
    scale = torch.exp(3.0 * (q * (1.0 - s)))
    mag = (g.float() * torch.round(z.float() * scale)).abs().sum(1, keepdim=True) / scale
    for x, y, chain in zip(got, want, (q, 1.0 - s)):
        assert x.shape == y.shape == (b, 1) and x.dtype == torch.float32
        bar = 1e-5 * 3.0 * mag * chain.abs() + 1e-30
        assert bool(((x - y).abs() <= bar).all()), ((x - y).abs() / bar).max().item()


def test_k3b_runs_in_autograd(dev):
    """The quantizer's 'reference' backward launches K3b once and gives the
    latent a zero gradient; 'ste' launches nothing and passes g through."""
    z, s, q, g = _k3b_case(dev, 4, 512, torch.float32, 7)
    zs = [t.clone().requires_grad_(True) for t in (z, s, q)]
    before = adaptive_quantize_bwd.launches
    adaptive_quantize(*zs, QuantizerConfig(grad_mode="reference")).backward(g)
    assert adaptive_quantize_bwd.launches == before + 1
    assert not zs[0].grad.any()
    ds, dq = adaptive_quantize_bwd_plain(z, s, q, g)
    assert torch.allclose(zs[1].grad, ds, rtol=1e-4, atol=1e-6)
    assert torch.allclose(zs[2].grad, dq, rtol=1e-4, atol=1e-6)
    zs = [t.clone().requires_grad_(True) for t in (z, s, q)]
    adaptive_quantize(*zs, QuantizerConfig(grad_mode="ste")).backward(g)
    assert adaptive_quantize_bwd.launches == before + 1
    assert torch.equal(zs[0].grad, g) and not zs[1].grad.any()


@pytest.mark.parametrize("latent_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", ["bf16-B1", "f32-B"])
def test_k3_k3b_take_score_and_strength_as_stored(dev, latent_dtype, rows):
    """Score and strength in bf16 (B, 1) or float32 (B,): K3, launched
    outside autograd, reads them as stored and matches the twin bit for bit
    on >= 99.9% of the outputs (chip_smoke.py's bar); K3b writes dscore and
    dstrength in their dtype and shape, within 1e-5 of the row's sum of
    |terms| times the chain factor, plus one bf16 rounding of the twin's
    value for bf16."""
    z, s, q, g = _k3b_case(dev, 16, 1000, latent_dtype, 11)
    if rows == "bf16-B1":
        s, q = s.to(torch.bfloat16), q.to(torch.bfloat16)
    else:
        s, q = s.reshape(16), q.reshape(16)
    before = adaptive_quantize.launches
    with torch.no_grad():
        out = adaptive_quantize(z, s, q, QuantizerConfig(grad_mode="reference"))
    assert adaptive_quantize.launches == before + 1 and out.grad_fn is None
    assert (out == adaptive_quantize_plain(z, s, q)).float().mean().item() >= 0.999
    got = adaptive_quantize_bwd(z, s, q, g)
    want = adaptive_quantize_bwd_plain(z, s, q, g)
    scale = torch.exp(3.0 * (q.float().reshape(16, 1) * (1.0 - s.float().reshape(16, 1))))
    mag = (g.float() * torch.round(z.float() * scale)).abs().sum(1) / scale.reshape(16) * 3.0
    for x, y, ref, chain in zip(got, want, (s, q), (q.float(), 1.0 - s.float())):
        assert x.dtype == ref.dtype and x.shape == ref.shape
        diff = (x.float() - y.float()).reshape(16).abs()
        bar = 1e-5 * mag * chain.reshape(16).abs() + 1e-30
        if ref.dtype == torch.bfloat16:
            bar = bar + y.float().reshape(16).abs() * 2 ** -8
        assert bool((diff <= bar).all()), (diff / bar).max().item()


@pytest.mark.parametrize("shape", [(1, 256, 256), (2, 32, 64)], ids=["B1", "ragged-rank-32x64"])
def test_k4_cluster_route_at_b1_and_a_ragged_rank(dev, shape):
    """B = 1; 32 rows over 6 blocks of 6, the last owning 2. Bar 1e-5."""
    gen = torch.Generator(device=dev).manual_seed(shape[1])
    sal = torch.rand(*shape, device=dev, generator=gen)
    got, route = _route_of(smooth_mask, lambda: smooth_mask(sal))
    assert route == "cluster"
    assert (got - smooth_mask_plain(sal)).abs().max().item() <= 1e-5
    assert torch.equal(got, smooth_mask(sal))


@pytest.mark.parametrize("shape,kw,route", [
    ((2, 64, 64), dict(d=5, gauss_ksize=15), "cluster"),
    ((1, 360, 360), {}, "tiled"),
], ids=["d5-ksize15", "tiled-360"])
def test_k4_other_sizes_and_the_tiled_route(dev, shape, kw, route):
    gen = torch.Generator(device=dev).manual_seed(shape[1] + 1)
    sal = torch.rand(*shape, device=dev, generator=gen)
    got, took = _route_of(smooth_mask, lambda: smooth_mask(sal, **kw))
    assert took == route
    assert (got - smooth_mask_plain(sal, **kw)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(2, 200, 200), (3, 32, 64), (48, 40)],
                         ids=["ragged-200", "non-square-32x64", "single-2d"])
def test_k4_matches_twin(dev, shape):
    """200 and 40 are not multiples of the 32-pixel tile (the tiled route)
    nor 200 of the 6-block cluster; at 32 x 64 a block owns 6 rows and the
    Gaussian halo spans 3 blocks. chip_smoke.py holds K4 at 64 x 256^2. Bar
    1e-5, as on the chip."""
    gen = torch.Generator(device=dev).manual_seed(shape[-1])
    sal = torch.rand(*shape, device=dev, generator=gen)
    before = smooth_mask.launches
    got = smooth_mask(sal)
    assert smooth_mask.launches == before + 1
    assert got.shape == sal.shape
    assert (got - smooth_mask_plain(sal)).abs().max().item() <= 1e-5


def test_k4_keeps_a_zero_map(dev):
    """A map whose max is 0 stays as it is (JAX's where(mx > 0, ...))."""
    got = smooth_mask(torch.zeros(2, 64, 64, device=dev))
    assert not got.any()


def _dct_case(dev, b, h, w, quality, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    planes = torch.rand(b, 3, h, w, device=dev, generator=gen) * 255 - 128
    return planes, torch.from_numpy(quality_tables(quality)).to(dev)


def _check_k5(planes, tables):
    """K5 against its twin: one launch; symbols within +-1 and identical on
    >= 99.99%; rec within 1e-4 on blocks whose symbols agree (one symbol at a
    half step moves its whole block)."""
    b, _, h, w = planes.shape
    before = dct_strips.launches
    rec, sym = dct_strips(planes, tables)
    assert dct_strips.launches == before + 1
    rec_p, sym_p = dct_strips_plain(planes, tables)
    assert (sym - sym_p).abs().max().item() <= 1.0
    assert (sym == sym_p).float().mean().item() >= 0.9999
    agree = (sym == sym_p).reshape(b, 3, h // 8, 8, w // 8, 8).all(5).all(3)
    err = (rec - rec_p).abs().reshape(b, 3, h // 8, 8, w // 8, 8).amax((3, 5))
    assert err[agree].max().item() <= 1e-4


@pytest.mark.parametrize("b,h,w,quality", [
    (1, 8, 8, 75), (2, 16, 264, 75), (2, 64, 64, 1), (2, 64, 64, 100),
], ids=["one-tile", "w264", "quality-1", "quality-100"])
def test_k5_matches_twin(dev, b, h, w, quality):
    """One tile (one warp of the persistent grid, 3 of its 4 tile slots
    empty); W = 264, 33 tiles a strip, so a warp's 4 tiles span two strips;
    the extreme quality tables."""
    _check_k5(*_dct_case(dev, b, h, w, quality, w + quality))


@pytest.mark.parametrize("case", ["b128-256sq", "unaligned"])
def test_k5_persistent_walk_matches_twin(dev, case):
    """B = 128 at 256^2 (the DCT path's shape: 393,216 tiles, so each warp of
    the persistent grid walks many tasks), and planes that start 4 bytes past
    a 16-byte boundary, which the wrapper copies to an aligned buffer."""
    if case == "b128-256sq":
        _check_k5(*_dct_case(dev, 128, 256, 256, 75, 128))
        return
    planes, tables = _dct_case(dev, 2, 24, 40, 50, 3)
    buf = torch.empty(planes.numel() + 1, device=dev)
    buf[1:] = planes.reshape(-1)
    shifted = buf[1:].view(planes.shape)
    assert shifted.data_ptr() % 16 == 4
    _check_k5(shifted, tables)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("n,dv", [(100, 64), (100, 128), (1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_ragged_matches_twin(dev, n, dv, dtype):
    """N = 100 is not a multiple of the 64-row tile. Bars: float32 1e-5,
    bf16 2e-2 of max |out| (as K2's)."""
    gen = torch.Generator(device=dev).manual_seed(n + dv)
    q, k = ((torch.randn(2, n, 16, device=dev, generator=gen) * 0.5).to(dtype) for _ in range(2))
    v = torch.randn(2, n, dv, device=dev, generator=gen).to(dtype)
    before = attention_core.launches
    got = attention_core(q, k, v)
    assert attention_core.launches == before + 1 and got.dtype == dtype
    want = attention_core_plain(q, k, v)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _rel_err(got, want) <= 2e-2


def _sagan_params(dev, c, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    inner = c // 8

    def r(*shape):
        return torch.randn(*shape, device=dev, generator=gen) * 0.1

    return [r(c, inner), r(inner), r(c, inner), r(inner), r(c, c), r(c)], torch.tensor(0.5, device=dev)


@pytest.mark.parametrize("n,c", [(100, 64), (100, 128), (64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7a_ragged_matches_twin(dev, n, c, dtype):
    params, g = _sagan_params(dev, c, n + c)
    gen = torch.Generator(device=dev).manual_seed(2 * n + c)
    x = torch.randn(2, n, c, device=dev, generator=gen).to(dtype)
    before = sagan_block.launches
    got = sagan_block(x, *params, g)
    assert sagan_block.launches == before + 1 and got.dtype == dtype
    want = sagan_block_plain(x, *params, g)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _rel_err(got, want) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7b_reads_a_permuted_nchw_view_in_place(dev, dtype):
    """The encoder's NCHW activation seen as (B, H, W, C): no copy, the
    output in the same layout, equal to the contiguous input's result."""
    c, h, w = 128, 10, 10
    params, g = _sagan_params(dev, c, 7)
    x_nchw = torch.randn(2, c, h, w, device=dev).to(dtype)
    view = x_nchw.permute(0, 2, 3, 1)
    before = sagan_block_spatial.launches
    got = sagan_block_spatial(view, *params, g)
    assert sagan_block_spatial.launches == before + 1
    assert got.stride() == view.stride()
    want = sagan_block_spatial(view.contiguous(), *params, g)
    assert want.is_contiguous()
    assert torch.equal(got, want)
    flat = sagan_block_plain(view.reshape(2, h * w, c), *params, g).reshape(2, h, w, c)
    if dtype == torch.float32:
        assert (got - flat).abs().max().item() <= 1e-5
    else:
        assert _rel_err(got, flat) <= 2e-2


@pytest.mark.parametrize("n", [100, 1024])
@pytest.mark.parametrize("c", [64, 128, 256], ids=["dk8", "dk16", "dk32"])
def test_k7_bf16_takes_the_tensor_core_route(dev, c, n):
    """bf16 at DK = C / 8 in {8, 16, 32} and a ragged N: the wgmma QKV GEMM
    and K2's kernel (route "wgmma"), within 2e-2 of max |out| of the twin,
    on the (B, N, C) view and on the permuted NCHW view."""
    params, g = _sagan_params(dev, c, 3 * n + c)
    x_nchw = torch.randn(2, c, n, 1, device=dev).to(torch.bfloat16)
    view = x_nchw.permute(0, 2, 3, 1)
    xf = view.reshape(2, n, c)
    got, route = _route_of(sagan_block, lambda: sagan_block(xf, *params, g))
    assert route == "wgmma"
    want = sagan_block_plain(xf, *params, g)
    assert _rel_err(got, want) <= 2e-2
    got_b, route_b = _route_of(sagan_block_spatial, lambda: sagan_block_spatial(view, *params, g))
    assert route_b == "wgmma" and got_b.stride() == view.stride()
    assert torch.equal(got_b.reshape(2, n, c), got)


def _attention_kernels(call):
    """The names of the device kernels one call launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("n", [100, 1024])
@pytest.mark.parametrize("c", [64, 128, 256], ids=["dk8", "dk16", "dk32"])
def test_k7_f32_takes_the_tensor_core_route(dev, c, n):
    """float32 at DK = C / 8 in {8, 16, 32} and a ragged N at the bf16
    test's inputs (`_sagan_params`, x ~ N(0, 1)): the three-pass TF32 QKV
    GEMM and K2's float32 kernel (route "tf32x3") on the (B, N, C) view and
    on the permuted NCHW view, whose output is bitwise the contiguous one's;
    within 1e-5 of the twin at DK 8 and 16. At DK 32 these inputs give
    scores up to ~96, where the twin itself lies 1.0e-5 (N 100) and 2.0e-5
    (N 1024) from the block in float64 and the 1e-5 bar is not met (PERF.md,
    scripts/torch_k7_f32_error.py); test_k7_f32_holds_the_bar_at_the_paths_scale
    holds DK 32 at the path's scale."""
    params, g = _sagan_params(dev, c, 3 * n + c)
    gen = torch.Generator(device=dev).manual_seed(n * c)
    x_nchw = torch.randn(2, c, n, 1, device=dev, generator=gen)
    view = x_nchw.permute(0, 2, 3, 1)
    xf = view.reshape(2, n, c)
    got, route = _route_of(sagan_block, lambda: sagan_block(xf, *params, g))
    assert route == "tf32x3" and got.dtype == torch.float32
    if c < 256:
        assert (got - sagan_block_plain(xf, *params, g)).abs().max().item() <= 1e-5
    got_b, route_b = _route_of(sagan_block_spatial, lambda: sagan_block_spatial(view, *params, g))
    assert route_b == "tf32x3" and got_b.stride() == view.stride()
    assert torch.equal(got_b.reshape(2, n, c), got)


@pytest.mark.parametrize("b,n", [(16, 1024), (2, 100)], ids=["tree-times-16x1024", "ragged-2x100"])
def test_k7_f32_holds_the_bar_at_the_paths_scale(dev, b, n):
    """DK 32 (C 256) at scripts/torch_tree_times.py's scales, x ~ N(0, 0.25)
    and `_sagan_params`' weights (its seeded input itself at (16, 1024),
    drawn in its order): within 1e-5 of the twin, K7a and K7b."""
    gen = torch.Generator(device=dev).manual_seed(7 if n == 1024 else 11)

    def r(*shape, scale=0.1):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    act = r(b, 256, n, 1, scale=0.5)
    params = [r(256, 32), r(32), r(256, 32), r(32), r(256, 256), r(256)]
    g = torch.tensor(0.5, device=dev)
    view = act.permute(0, 2, 3, 1)
    xf = view.reshape(b, n, 256)
    want = sagan_block_plain(xf, *params, g)
    got = sagan_block(xf, *params, g)
    assert (got - want).abs().max().item() <= 1e-5
    got_b = sagan_block_spatial(view, *params, g)
    assert torch.equal(got_b.reshape(b, n, 256), got)


def test_f32_epilogues_by_layout(dev):
    """K2 in float32 with a contiguous residual takes the float32 kernel's
    contiguous epilogue with K2's order of sums (attn_tf32_kernel<NCH,
    false, false>, its output bitwise the parent's); K7a on a contiguous
    (B, N, C) the contiguous epilogue with K7's order (<NCH, false, true>);
    K7b on the NCHW view the strided one (<NCH, true, true>)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k = (torch.randn(2, 1024, 32, device=dev, generator=gen) * 0.4 for _ in range(2))
    v, r = (torch.randn(2, 1024, 256, device=dev, generator=gen) for _ in range(2))
    g = torch.tensor(0.5, device=dev)
    params, g7 = _sagan_params(dev, 256, 3)
    x_nchw = torch.randn(2, 256, 32, 32, device=dev, generator=gen) * 0.5
    view = x_nchw.permute(0, 2, 3, 1)
    calls = {"K2": (lambda: attention_block(q, k, v, r, g), "<4, false, false>"),
             "K7a": (lambda: sagan_block(view.reshape(2, 1024, 256).contiguous(), *params, g7),
                     "<4, false, true>"),
             "K7b": (lambda: sagan_block_spatial(view, *params, g7), "<4, true, true>")}
    for name, (call, want) in calls.items():
        names = [n for n in _attention_kernels(call) if "attn_tf32_kernel" in n]
        assert len(names) == 1 and "attn_tf32_kernel" + want in names[0], (name, names)


def test_k7_backward_runs_through_the_jnp_formula(dev):
    params, g = _sagan_params(dev, 64, 9)
    x = torch.randn(1, 64, 64, device=dev, requires_grad=True)
    ps = [p.clone().requires_grad_(True) for p in params]
    gg = g.clone().requires_grad_(True)
    sagan_block(x, *ps, gg).pow(2).sum().backward()
    want = torch.autograd.grad(sagan_block_jnp(x, *ps, gg).pow(2).sum(), [x, *ps, gg])
    for t, w in zip([x, *ps, gg], want):
        assert torch.allclose(t.grad, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,h,cin,cmid,dtype", [
    (3, 16, 128, 32, torch.bfloat16),
    (3, 16, 128, 32, torch.float32),
    (1, 12, 40, 8, torch.float32),
    (2, 12, 128, 32, torch.bfloat16),
    (1, 12, 40, 8, torch.bfloat16),
    (2, 9, 24, 5, torch.bfloat16),
    (16, 128, 128, 32, torch.bfloat16),
    (16, 128, 128, 32, torch.float32),
    (2, 9, 24, 5, torch.float32),
], ids=["odd-batch-bf16", "odd-batch-f32", "ragged-narrow-f32", "ragged-bf16",
        "ragged-narrow-bf16", "cin24-cmid5-bf16", "full-path-bf16", "full-path-f32",
        "cin24-cmid5-f32"])
def test_k8_matches_twin(dev, b, h, cin, cmid, dtype):
    """H = 12 gives a 24-pixel output, not a multiple of the 28-pixel width
    of the 12 x 28 tile both routes walk; Cin 40 and 24 are not multiples of
    16 (zero-padded in the bf16 route's K dimension, to 32 in float32's),
    Cmid 5 not a multiple of 8; full-path-* is chip_smoke's shape; W = 9 is not a
    multiple of 4, so the float32 kernel stages its windows with its own
    loads instead of TMA. bf16 takes the "wgmma" route, float32 the "tf32x3"
    one (both on the tensor cores). Bars: float32 2e-5
    (as the CPU tests), bf16 1.6e-2 absolute on a tanh output (two bf16 ulps
    of 1), identical on >= 99% of outputs."""
    gen = torch.Generator(device=dev).manual_seed(b * h + cin)
    x = (torch.randn(b, cin, h, h, device=dev, generator=gen) * 0.5).to(dtype)
    folded = (torch.randn(cin, cmid, 4, 4, device=dev, generator=gen) * 0.1).to(dtype)
    shift = (torch.randn(cmid, device=dev, generator=gen) * 0.1).to(dtype)
    ow = (torch.randn(3, cmid, 4, 4, device=dev, generator=gen) * 0.1).to(dtype)
    ob = torch.randn(3, device=dev, generator=gen) * 0.1
    got, route = _route_of(fused_tail, lambda: fused_tail(x, folded, shift, ow, ob))
    assert route == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")
    assert got.shape == (b, 3, 2 * h, 2 * h) and got.dtype == dtype
    want = fused_tail_plain(x, folded, shift, ow, ob)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:
        assert err.max().item() <= 1.6e-2
        assert (err == 0).float().mean().item() >= 0.99


def _int8_tail_weights(dev, cin, cmid, co, seed):
    """The int8 tail's weights in bf16, with BN statistics drawn so that amax
    (max(|bn_bias|, |shift|) + 8 |bn_scale|) varies by channel, about 7x."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=0.1):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    def u(n, lo, hi):
        return (torch.rand(n, device=dev, generator=gen) * (hi - lo) + lo).to(torch.bfloat16)

    return dict(deconv_weight=r(cin, cmid, 4, 4), deconv_bias=r(cmid), bn_scale=u(cmid, 0.25, 1.75),
                bn_bias=r(cmid, scale=0.3), bn_mean=r(cmid, scale=0.3), bn_var=u(cmid, 0.1, 2.0),
                out_weight=r(co, cmid, 4, 4), out_bias=r(co))


@pytest.mark.parametrize("b,h,cin,cmid,co", [
    (2, 12, 40, 8, 3), (3, 9, 24, 5, 3), (1, 16, 128, 32, 4), (2, 128, 128, 32, 3),
], ids=["ragged-narrow", "cin24-cmid5", "co4", "full-width"])
def test_k8_int8_matches_the_pytorch_path(dev, b, h, cin, cmid, co):
    """K8's int8 route against packed_tail_forward(int8_planar=True) on the
    PyTorch path (cuDNN), which it replaces in serving: full width is the
    generator's tail at B = 2 (Cin 128, 128^2 -> 256^2, Cmid 32, Co 3); the
    others a ragged 24-pixel output, Cin not a multiple of 16, Cmid 5 and Co 4.
    Bars, K8's bf16 bars against cuDNN in chip_smoke.py: max 6.25e-2, mean
    4e-3, identical on >= 99% of values."""
    from contextual_image_compression_tpu_torch.models.packed_tail import (
        fold_int8_tail, int8_tail_forward, packed_tail_forward)

    w = _int8_tail_weights(dev, cin, cmid, co, b * h + cin)
    gen = torch.Generator(device=dev).manual_seed(h)
    x = (torch.randn(b, cin, h, h, device=dev, generator=gen) * 0.5).to(torch.bfloat16)
    ops = fold_int8_tail(*w.values(), torch.bfloat16, pack=True)
    got, route = _route_of(fused_tail, lambda: int8_tail_forward(x, ops))
    assert route == "int8"
    assert got.shape == (b, co, 2 * h, 2 * h) and got.dtype == torch.bfloat16
    want = packed_tail_forward(x, *w.values(), int8_planar=True)
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 6.25e-2
    assert err.mean().item() <= 4e-3
    assert (err == 0).float().mean().item() >= 0.99


def test_k8_int8_route_once_a_generator_call(dev, monkeypatch):
    """A packed-int8 generator on the card launches K8's int8 route once a
    call (its tail Cin 24, Cmid 8, Co 3), from its first call on, never
    prepared: the first call folds and keeps the operands, which
    `prepare_tail` then finds kept. Within the bars of the PyTorch path on
    the same operands and input; train=True takes the native tail, no K8."""
    from contextual_image_compression_tpu_torch.models import generator as gmod
    from contextual_image_compression_tpu_torch.models.layers import cast_floats
    from contextual_image_compression_tpu_torch.models.packed_tail import (
        fold_int8_tail, int8_tail_plain)

    with torch.device(dev):
        g = gmod.Generator(8, channels=(16, 16, 16, 8), skip_channels=(8, 8, 8), base_hw=4,
                           base_ch=16, packed_tail=True, packed_tail_int8=True)
    g.reset_parameters(torch.Generator(device=dev).manual_seed(3))
    w = _int8_tail_weights(dev, 24, 8, 3, 5)
    with torch.no_grad():
        for t, v in zip(g._tail_sources(), w.values()):
            t.copy_(v)
    cast_floats(g, torch.bfloat16)
    g.eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(4)
    latent = torch.randn(2, 8, device=dev, generator=gen).to(torch.bfloat16)
    skips = tuple(torch.randn(2, 8, s, s, device=dev, generator=gen).to(torch.bfloat16)
                  for s in (32, 16, 8))
    inputs = []
    tail = gmod.int8_tail_forward
    monkeypatch.setattr(gmod, "int8_tail_forward", lambda x, t: inputs.append(x) or tail(x, t))
    with torch.no_grad():
        before = dict(fused_tail.route_launches)
        for n in (1, 2):
            got = g(latent, skips)
            assert fused_tail.route_launches == {**before, "int8": before["int8"] + n}
        kept = g._int8_tail
        assert torch.equal(kept[1].taps, fold_int8_tail(
            *g._tail_sources(), torch.bfloat16, pack=True).taps)
        g.prepare_tail()
        assert g._int8_tail is kept
        g(latent, skips, train=True)
        assert fused_tail.route_launches["int8"] == before["int8"] + 2
        want = int8_tail_plain(inputs[0], kept[1])
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 6.25e-2 and err.mean().item() <= 4e-3
    assert (err == 0).float().mean().item() >= 0.99


def test_attention_jnp_routes_ignore_the_callers_tf32(dev):
    """The use_pallas=False attention routes run every float32 product, the
    backward's included, with TF32 off whatever the caller set: their
    outputs and gradients with allow_tf32 on equal those with it off, bit
    for bit (N = 1024, K2's serving shape at B = 2)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    q, k = (torch.randn(2, 1024, 32, device=dev, generator=gen) for _ in range(2))
    v, r = (torch.randn(2, 1024, 256, device=dev, generator=gen) for _ in range(2))
    params, g7 = _sagan_params(dev, 64, 3)
    x = torch.randn(2, 256, 64, device=dev, generator=gen)
    calls = {"block": (attention_block, [q, k, v, r, torch.tensor(0.7, device=dev)]),
             "sagan": (sagan_block, [x, *params, g7])}
    try:
        for name, (fn, inputs) in calls.items():
            runs = []
            for tf32 in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                leaves = [t.clone().requires_grad_(True) for t in inputs]
                out = fn(*leaves, use_pallas=False)
                out.pow(2).sum().backward()
                runs.append([out.detach()] + [t.grad for t in leaves])
            for a, b in zip(*runs):
                assert torch.equal(a, b), name
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

"""K6 (attention core), K7a / K7b (fused SAGAN block) and K8 (fused generator
tail) of the port against the JAX package.

On the CPU each wrapper runs its kernel's plain twin; the JAX Pallas kernels
run in interpret mode, as the JAX package's own tests run them. Inputs are
seeded numpy arrays handed to both packages; weights cross through the
layout rules of `convert.py`. Bars:

  * float32: 1e-5 for K6 and K7 (the JAX tests' bar between kernel and jnp
    formula), 2e-5 for K8 (`tests/test_packed_tail.py`'s Pallas cases use
    1e-4 and 2e-4; both sides here compute in float32 and differ only in
    the order of the sums);
  * bfloat16: the twins reproduce the kernels' roundings, so what is left is
    float32 summation order moving a value across a bf16 rounding boundary:
    two bf16 ulps of the output's magnitude (K6, K7: 2 * 2^-8 of max |out|;
    K8's tanh output is within [-1, 1], so 1.6e-2 absolute);
  * gradients: 1e-4 against JAX's custom VJP, as `tests/test_models.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextual_image_compression_tpu.models import packed_tail as jpt
from contextual_image_compression_tpu.ops import attention as jatt
from contextual_image_compression_tpu_torch import ops as tops
from contextual_image_compression_tpu_torch.convert import _component_state
from contextual_image_compression_tpu_torch.models.packed_tail import packed_tail_forward
from contextual_image_compression_tpu_torch.ops import attention as tatt
from contextual_image_compression_tpu_torch.ops.generator_tail import fused_tail_plain

BF16_ULPS = 2 * 2.0 ** -8


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


# --------------------------------------------------------------------- K6

def _qkv(seed, b=2, n=64, dk=8, dv=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, dk).astype(np.float32), rng.randn(b, n, dk).astype(np.float32),
            rng.randn(b, n, dv).astype(np.float32))


def test_k6_twin_matches_pallas_float32():
    q, k, v = _qkv(0)
    want = _np(jatt.attention_core_pallas(_j(q), _j(k), _j(v)))
    before = tops.launch_counts()
    got = tatt.attention_core(_t(q), _t(k), _t(v))
    assert tops.launch_counts() == before  # CPU tensors take the twin
    assert got.dtype == torch.float32 and got.shape == (2, 64, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tatt.attention_core(_t(q), _t(k), _t(v), use_pallas=False).numpy(),
                               _np(jatt.attention_core_jnp(_j(q), _j(k), _j(v))), atol=1e-5)


def test_k6_twin_matches_pallas_bf16():
    """bf16 inputs: e rounded to bf16 for the e.V product, output in bf16."""
    q, k, v = _qkv(1)
    bf = jnp.bfloat16
    want = _np(jatt.attention_core_pallas(_j(q, bf), _j(k, bf), _j(v, bf)))
    got = tatt.attention_core(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_ULPS * np.abs(want).max(), err


def test_k6_gradients_match_jax_vjp():
    q, k, v = _qkv(2)

    def jloss(q_, k_, v_):
        return jnp.sum(jatt.attention_core_pallas(q_, k_, v_) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    (tatt.attention_core(*ts) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), atol=1e-4)


# --------------------------------------------------------------- K7a / K7b

def _sagan_args(seed, b=2, n=64, c=32, inner=4, dv=32):
    """The shapes of tests/test_models.py::test_sagan_block_pallas_matches_jnp."""
    rng = np.random.RandomState(seed)
    xf = rng.randn(b, n, c).astype(np.float32)
    params = [rng.randn(c, inner) * 0.1, rng.randn(inner) * 0.1,
              rng.randn(c, inner) * 0.1, rng.randn(inner) * 0.1,
              rng.randn(c, dv) * 0.1, rng.randn(dv) * 0.1]
    return xf, [p.astype(np.float32) for p in params], np.float32(0.7)


def _jargs(xf, params, gamma, dt=jnp.float32):
    return (_j(xf, dt), *[_j(p) for p in params], jnp.float32(gamma))


def _targs(xf, params, gamma, dt=torch.float32):
    return (_t(xf, dt), *[_t(p) for p in params], torch.tensor(float(gamma)))


@pytest.mark.parametrize("view", ["flat", "spatial"])
def test_k7_twin_matches_pallas_float32(view):
    xf, params, gamma = _sagan_args(3)
    if view == "spatial":
        xf = xf.reshape(2, 8, 8, 32)
        jfn, tfn, jref = (jatt.sagan_block_spatial_pallas, tatt.sagan_block_spatial,
                          jatt.sagan_block_spatial_jnp)
    else:
        jfn, tfn, jref = jatt.sagan_block_pallas, tatt.sagan_block, jatt.sagan_block_jnp
    before = tops.launch_counts()
    got = tfn(*_targs(xf, params, gamma))
    assert tops.launch_counts() == before
    assert got.shape == xf.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(jfn(*_jargs(xf, params, gamma))), atol=1e-5)
    # use_pallas=False: the jnp formula of both packages
    np.testing.assert_allclose(tfn(*_targs(xf, params, gamma), use_pallas=False).numpy(),
                               _np(jref(*_jargs(xf, params, gamma))), atol=1e-5)


@pytest.mark.parametrize("view", ["flat", "spatial"])
def test_k7_twin_matches_pallas_bf16(view):
    """bf16: q, k and v rounded after float32 accumulation and the float32
    bias, as the TPU kernel does (sagan_block_jnp adds the bias in bf16)."""
    xf, params, gamma = _sagan_args(4)
    if view == "spatial":
        xf = xf.reshape(2, 8, 8, 32)
    jfn = jatt.sagan_block_spatial_pallas if view == "spatial" else jatt.sagan_block_pallas
    tfn = tatt.sagan_block_spatial if view == "spatial" else tatt.sagan_block
    want = _np(jfn(*_jargs(xf, params, gamma, jnp.bfloat16)))
    got = tfn(*_targs(xf, params, gamma, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_ULPS * np.abs(want).max(), err


@pytest.mark.parametrize("view", ["flat", "spatial"])
def test_k7_gradients_match_jax_vjp(view):
    """Gradients of sum(out^2) with respect to x, every weight and gamma."""
    xf, params, gamma = _sagan_args(5)
    if view == "spatial":
        xf = xf.reshape(2, 8, 8, 32)
    jfn = jatt.sagan_block_spatial_pallas if view == "spatial" else jatt.sagan_block_pallas
    tfn = tatt.sagan_block_spatial if view == "spatial" else tatt.sagan_block
    jargs = _jargs(xf, params, gamma)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2), argnums=tuple(range(8)))(*jargs)
    targs = [t.requires_grad_(True) for t in _targs(xf, params, gamma)]
    (tfn(*targs) ** 2).sum().backward()
    for t, w in zip(targs, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w).reshape(t.shape), atol=1e-4)


def test_k7b_reads_the_nchw_activation_through_a_permuted_view():
    """The port's encoder keeps activations in NCHW; sagan_block_spatial fed
    x.permute(0, 2, 3, 1) gives the values of the contiguous (B, H, W, C)
    input, and sagan_block the same on the flattened view."""
    xf, params, gamma = _sagan_args(6)
    x_nhwc = _t(xf).reshape(2, 8, 8, 32)
    x_nchw = x_nhwc.permute(0, 3, 1, 2).contiguous()
    view = x_nchw.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    rest = _targs(xf, params, gamma)[1:]
    got = tatt.sagan_block_spatial(view, *rest)
    want = tatt.sagan_block_spatial(x_nhwc, *rest)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    flat = tatt.sagan_block(x_nhwc.reshape(2, 64, 32), *rest)
    np.testing.assert_allclose(flat.reshape(2, 8, 8, 32).numpy(), want.numpy(), atol=1e-6)


# --------------------------------------------------------------------- K8

def _tail_case(seed, b=2, h=8, cin=16, cmid=8, cout=3, scale=1.0, one_hot=None):
    """The inputs of tests/test_packed_tail.py's Pallas tests: x NHWC and
    the flax kernels (4, 4, Cin, Cmid) and (4, 4, Cmid, Cout)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, h, cin).astype(np.float32) * scale
    k4 = (rng.randn(4, 4, cin, cmid) * 0.2).astype(np.float32)
    if one_hot is not None:  # a single nonzero tap: the most asymmetric kernel
        mask = np.zeros((4, 4, 1, 1), np.float32)
        mask[one_hot] = 1.0
        k4 = k4 * mask
    f = dict(
        x=x, k4=k4, b4=(rng.randn(cmid) * 0.1).astype(np.float32),
        scale=(np.abs(rng.randn(cmid)) + 0.5).astype(np.float32),
        bias=(rng.randn(cmid) * 0.1).astype(np.float32),
        mean=(rng.randn(cmid) * 0.1).astype(np.float32),
        var=(np.abs(rng.randn(cmid)) + 0.5).astype(np.float32),
        ko=(rng.randn(4, 4, cmid, cout) * 0.2).astype(np.float32),
        bo=(rng.randn(cout) * 0.1).astype(np.float32),
    )
    return f


def _jax_tail(f, dt=jnp.float32, use_pallas=True):
    y = jpt.packed_tail_forward(
        _j(f["x"], dt), _j(f["k4"]), _j(f["b4"]), _j(f["scale"]), _j(f["bias"]),
        _j(f["mean"]), _j(f["var"]), _j(f["ko"]), _j(f["bo"]), use_pallas=use_pallas)
    return _np(y)


def _port_tail(f, dt=torch.float32, **kw):
    """The port's packed_tail_forward on the flax weights carried by
    convert.py's rules; returns NHWC float32 numpy."""
    sd = _component_state({"params": {
        "deconv4": {"ConvTranspose_0": {"kernel": f["k4"], "bias": f["b4"]}},
        "out_conv": {"Conv_0": {"kernel": f["ko"], "bias": f["bo"]}},
    }})
    x = _t(f["x"], dt).permute(0, 3, 1, 2).contiguous()
    y = packed_tail_forward(
        x, sd["deconv4.weight"], sd["deconv4.bias"], _t(f["scale"]), _t(f["bias"]),
        _t(f["mean"]), _t(f["var"]), sd["out_conv.weight"], sd["out_conv.bias"], **kw)
    assert y.dtype == dt
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_twin_matches_pallas(dtype):
    """tests/test_packed_tail.py::test_fused_tail_pallas_matches_xla_path's
    shapes (x (2, 8, 8, 16), Cmid 8, Co 3)."""
    f = _tail_case(7)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = _jax_tail(f, jdt)
    before = tops.launch_counts()
    got = _port_tail(f, tdt, use_pallas=True)
    assert tops.launch_counts() == before
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=2e-5 if dtype == "float32" else 1.6e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_twin_matches_pallas_at_real_widths(dtype):
    """Cin 128, Cmid 32 (the codec's tail) on an 8 x 8 input."""
    f = _tail_case(8, b=1, h=8, cin=128, cmid=32, scale=0.3)
    f["k4"] *= 0.25
    f["ko"] *= 0.25
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = _jax_tail(f, jdt)
    got = _port_tail(f, tdt, use_pallas=True)
    np.testing.assert_allclose(got, want, atol=2e-5 if dtype == "float32" else 1.6e-2)


@pytest.mark.parametrize("tap", [(0, 1), (3, 0), (2, 3)])
def test_k8_asymmetric_kernel(tap):
    """A deconv kernel with one nonzero tap: a flip on either axis, or a tap
    table for the unflipped layout, moves the output by whole pixels. The
    twin must equal JAX's Pallas kernel and the port's cuDNN formulation."""
    f = _tail_case(9, one_hot=tap)
    got = _port_tail(f, use_pallas=True)
    np.testing.assert_allclose(got, _jax_tail(f), atol=2e-5)
    np.testing.assert_allclose(got, _port_tail(f, use_pallas=False), atol=2e-5)


def test_k8_twin_matches_the_cudnn_path_and_ignores_int8():
    """In float32 the twin is the same function as use_pallas=False (cuDNN's
    transposed conv and conv); use_pallas=True ignores int8_planar, as in JAX."""
    f = _tail_case(10)
    got = _port_tail(f, use_pallas=True)
    np.testing.assert_allclose(got, _port_tail(f, use_pallas=False), atol=2e-5)
    np.testing.assert_array_equal(_port_tail(f, use_pallas=True, int8_planar=True), got)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_packed_tail_rejects_non_square_input(use_pallas):
    """As the JAX packed_tail_forward (models/packed_tail.py:399-405)."""
    f = _tail_case(11)
    f["x"] = f["x"][:, :, :6]
    with pytest.raises(ValueError, match="square"):
        _port_tail(f, use_pallas=use_pallas)
    with pytest.raises(ValueError, match="square"):
        _jax_tail(f, use_pallas=use_pallas)


def test_fused_tail_plain_rounds_each_tap_in_bf16():
    """The bf16 twin is not the single-rounding transposed conv: on these
    inputs the four per-tap roundings move some outputs."""
    f = _tail_case(12, b=1, h=8, cin=128, cmid=32)
    sd = _component_state({"params": {"deconv4": {"ConvTranspose_0": {"kernel": f["k4"],
                                                                       "bias": f["b4"]}}}})
    x = _t(f["x"]).permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    w = sd["deconv4.weight"].to(torch.bfloat16)
    zero = torch.zeros(32, dtype=torch.bfloat16)
    eye = torch.zeros(3, 32, 4, 4, dtype=torch.bfloat16)
    eye[0, 0, 1, 1] = 1.0  # out-conv tap that copies channel 0 of z
    got = fused_tail_plain(x, w, zero, eye, torch.zeros(3)).float()
    once = torch.nn.functional.conv_transpose2d(x.float(), w.float(), stride=2, padding=1)
    once = torch.tanh(torch.where(once >= 0, once, 0.2 * once).to(torch.bfloat16).float())
    assert (got[:, 0] != once.to(torch.bfloat16).float()[:, 0]).any()


# ------------------------------------------- K8's int8 route: folded once

def _int8_generator(seed, dtype=torch.bfloat16, channels=(16, 16, 16, 8)):
    """A small packed-int8 generator (tail Cin 24, Cmid 8, Co 3 at 32 x 32 ->
    64 x 64) with seeded weights, BN statistics drawn so that amax varies by
    channel, cast to dtype and in eval mode; and its inputs."""
    from contextual_image_compression_tpu_torch.models.generator import Generator
    from contextual_image_compression_tpu_torch.models.layers import KBatchNorm, cast_floats

    g = Generator(8, channels=channels, skip_channels=(8, 8, 8), base_hw=4, base_ch=16,
                  packed_tail=True, packed_tail_int8=True)
    gen = torch.Generator().manual_seed(seed)
    g.reset_parameters(gen)
    with torch.no_grad():
        for mod in g.modules():
            if isinstance(mod, KBatchNorm):
                c = mod.weight.shape[0]
                mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                mod.running_var.copy_(torch.rand(c, generator=gen) + 0.25)
                mod.weight.copy_(torch.rand(c, generator=gen) * 1.5 + 0.25)
                mod.bias.copy_(torch.randn(c, generator=gen) * 0.3)
        for conv in (g.deconv4, g.out_conv):
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen) * 0.1)
    cast_floats(g, dtype)
    g.eval().requires_grad_(False)
    latent = torch.randn(2, 8, generator=gen).to(dtype)
    skips = tuple(torch.randn(2, 8, s, s, generator=gen).to(dtype) for s in (32, 16, 8))
    return g, latent, skips


def _per_call_fold(g, dt):
    """The int8 tail's operands as packed_tail_forward(int8_planar=True)
    computed them in line before they were factored out."""
    f32 = torch.float32
    bn = g.bn4
    scale = bn.weight.to(f32) * torch.rsqrt(bn.running_var.to(f32) + bn.eps)
    shift = bn.bias.to(f32) + (g.deconv4.bias.to(dt).to(f32) - bn.running_mean.to(f32)) * scale
    folded = (g.deconv4.weight.to(dt).to(f32) * scale[None, :, None, None]).to(dt)
    amax = torch.clamp(torch.maximum(torch.abs(bn.bias.to(f32)), torch.abs(shift))
                       + 8.0 * torch.abs(bn.weight.to(f32)), min=1e-6)
    return dict(folded=folded, shift=shift.to(dt), inv_amax=127.0 / amax,
                out_weight=(g.out_conv.weight.to(f32) * (amax / 127.0)[None, :, None, None]).to(dt),
                out_bias=g.out_conv.bias.to(dt))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_prepared_int8_operands_equal_the_per_call_fold(dtype):
    """Generator.prepare_tail folds the same operands as the per-call fold,
    bit for bit, and packs K8's tap tiles (bf16 only)."""
    from contextual_image_compression_tpu_torch.ops.generator_tail import _pack_tap_tiles

    g, _, _ = _int8_generator(20, dtype)
    assert g._int8_tail is None
    g.prepare_tail()
    ops = g._int8_tail[1]
    for name, want in _per_call_fold(g, dtype).items():
        got = getattr(ops, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert ops.inv_amax.dtype == torch.float32 and ops.leaky_slope == 0.2
    if dtype == torch.bfloat16:
        assert torch.equal(ops.taps, _pack_tap_tiles(ops.folded))
    else:
        assert ops.taps is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_prepared_int8_generator_matches_unprepared_on_cpu(dtype, monkeypatch):
    """A generator's first call, never prepared, equals its twin's call
    after prepare_tail and the per-call fold of
    packed_tail_forward(int8_planar=True) on the same input, bit for bit;
    on the CPU no kernel is launched."""
    from contextual_image_compression_tpu_torch.models import generator as gmod
    from contextual_image_compression_tpu_torch.models.packed_tail import packed_tail_forward

    inputs = []
    tail = gmod.int8_tail_forward
    monkeypatch.setattr(gmod, "int8_tail_forward", lambda x, t: inputs.append(x) or tail(x, t))
    g, latent, skips = _int8_generator(21, dtype)
    twin, _, _ = _int8_generator(21, dtype)
    before = tops.launch_counts()
    with torch.no_grad():
        first = g(latent, skips)
        twin.prepare_tail()
        got = twin(latent, skips)
        bn = g.bn4
        per_call = packed_tail_forward(
            inputs[0], g.deconv4.weight, g.deconv4.bias, bn.weight, bn.bias, bn.running_mean,
            bn.running_var, g.out_conv.weight, g.out_conv.bias, bn_eps=bn.eps, int8_planar=True)
    assert tops.launch_counts() == before
    assert got.shape == (2, 3, 64, 64) and got.dtype == dtype
    assert torch.equal(first, got) and torch.equal(first, per_call)


def test_int8_tail_prepares_under_inference_mode():
    """A generator built, prepared and called under torch.inference_mode
    (whose tensors keep no version counter) serves the per-call fold's
    output."""
    with torch.inference_mode():
        g, latent, skips = _int8_generator(26)
        want = g(latent, skips)
        g.prepare_tail()
        assert torch.equal(g(latent, skips), want)


class _FakeX:
    """What `takes_int8_route` reads of x, for a device this machine lacks."""

    def __init__(self, device="cuda", dtype=torch.bfloat16, shape=(2, 24, 32, 32)):
        self.device, self.dtype, self.shape = torch.device(device), dtype, shape


@pytest.mark.parametrize("case,want", [
    ("cuda-bf16", True), ("cpu", False), ("f32", False), ("not-square", False),
    ("unpacked", False), ("cin-136", False), ("cmid-40", False), ("co-5", False),
], ids=lambda v: str(v))
def test_int8_route_dispatch(case, want):
    """K8's int8 route takes a square bf16 CUDA input with packed taps
    within Cin <= 128, Cmid <= 32, Co <= 4; everything else the PyTorch path."""
    from contextual_image_compression_tpu_torch.models.packed_tail import (
        fold_int8_tail, takes_int8_route)

    cin, cmid, co = {"cin-136": (136, 8, 3), "cmid-40": (24, 40, 3),
                     "co-5": (24, 8, 5)}.get(case, (24, 8, 3))
    bf = torch.bfloat16
    w = [torch.randn(cin, cmid, 4, 4), torch.randn(cmid), torch.rand(cmid) + 0.5,
         torch.randn(cmid), torch.randn(cmid), torch.rand(cmid) + 0.5,
         torch.randn(co, cmid, 4, 4), torch.randn(co)]
    ops = fold_int8_tail(*[t.to(bf) for t in w], bf, pack=case != "unpacked")
    x = _FakeX(device="cpu" if case == "cpu" else "cuda",
               dtype=torch.float32 if case == "f32" else bf,
               shape=(2, cin, 32, 30) if case == "not-square" else (2, cin, 32, 32))
    assert takes_int8_route(x, ops) is want


def test_int8_route_is_not_taken_on_cpu_or_unprepared(monkeypatch):
    """A generator on the CPU, never prepared or prepared, never reaches the
    kernel wrapper: its first call folds and keeps the operands, which
    prepare_tail then finds kept, and x in another dtype folds them again.
    Under autograd every call folds afresh, unpacked and not kept, and the
    gradients reach the tail's weights."""
    from contextual_image_compression_tpu_torch.ops import generator_tail

    def refuse(*args, **kwargs):
        raise AssertionError("K8's int8 route on a CPU tensor")

    monkeypatch.setattr(generator_tail, "int8_tail", refuse)
    g, latent, skips = _int8_generator(22)
    with torch.no_grad():
        g(latent, skips)
        kept = g._int8_tail
        assert kept is not None and kept[1].taps is not None
        g.prepare_tail()
        g(latent, skips)
        assert g._int8_tail is kept
        ops = g._int8_operands(latent.float())
        assert ops.folded.dtype == torch.float32 and g._int8_tail[1] is ops
    g.requires_grad_(True)
    ops = g._int8_operands(latent)
    assert ops.taps is None and ops.folded.requires_grad and g._int8_tail[1] is not ops
    g(latent, skips).float().sum().backward()
    assert g.deconv4.weight.grad is not None and g.out_conv.weight.grad is not None


@pytest.mark.parametrize("how", ["load_state_dict", "load_assign", "in_place"])
def test_int8_operands_are_not_served_stale(how):
    """Weights changed after prepare_tail (a state dict loaded, with or
    without assign, or an in-place edit of a BN statistic) are refolded
    before the next call: the
    output equals that of an unprepared generator holding the new weights."""
    g, latent, skips = _int8_generator(23)
    other, _, _ = _int8_generator(24)
    g.prepare_tail()
    with torch.no_grad():
        stale = g(latent, skips)
        if how == "in_place":
            g.bn4.running_var.mul_(2.0)
            other.load_state_dict(g.state_dict())
        else:
            g.load_state_dict(other.state_dict(), assign=how == "load_assign")
        want = other(latent, skips)
        got = g(latent, skips)
    assert not torch.equal(got, stale)
    assert torch.equal(got, want)
    assert torch.equal(g._int8_tail[1].shift, _per_call_fold(other, torch.bfloat16)["shift"])


def test_prepared_int8_tail_rejects_non_square_input():
    """As the per-call path (packed_tail_forward) does."""
    from contextual_image_compression_tpu_torch.models.packed_tail import int8_tail_forward

    g, _, _ = _int8_generator(25)
    g.prepare_tail()
    with pytest.raises(ValueError, match="square"):
        int8_tail_forward(torch.zeros(1, 24, 8, 6, dtype=torch.bfloat16), g._int8_tail[1])

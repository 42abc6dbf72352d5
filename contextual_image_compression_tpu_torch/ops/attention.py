"""SAGAN attention: kernels K2, K6, K7a and K7b and their plain PyTorch twins.

Counterpart of `contextual_image_compression_tpu/ops/attention.py`, no
1/sqrt(d) scaling anywhere:

  * K2 `attention_block` (`attention_block_pallas`): gamma * softmax(Q K^T) V
    + residual, q, k (B, N, Dk <= 64), v and residual (B, N, Dv <= 256; a
    Dv off the kernels' 64-wide value tiles is zero-padded up to one and the
    output cut back), on the tensor
    cores (`csrc/attention.cu`): bf16 as one pass (route "wgmma"), float32
    as three TF32 passes per product (route "tf32x3": a pre-pass splits q,
    k and V^T into TF32 hi and lo in a scratch buffer, then the wgmma
    kernel);
  * K6 `attention_core` (`attention_core_pallas`): softmax(Q K^T) V, the
    same kernels with no epilogue;
  * K7a `sagan_block` (`sagan_block_pallas`) and K7b `sagan_block_spatial`
    (`sagan_block_spatial_pallas`): the whole block with its 1x1 Q/K/V
    projections, gamma * softmax((x Wq + bq)(x Wk + bk)^T)(x Wv + bv) + x,
    on the (B, N, C) and the (B, H, W, C) views; `csrc/sagan_block.cu`
    reads either in place, the port's NCHW activation as
    `x.permute(0, 2, 3, 1)` included: a QKV GEMM on the tensor cores, then
    K2's kernel with a strided epilogue; in bf16 one pass (route "wgmma"),
    in float32 three TF32 passes per product (route "tf32x3": the GEMM
    writes the TF32 hi and lo of Q, K and V^T straight into K2's float32
    scratch).

Each wrapper launches its kernel for CUDA tensors and its twin (`*_plain`,
the kernel's rounding) for CPU tensors. `use_pallas=False` runs the `*_jnp`
counterpart of the JAX package's own formula instead, as the caller's
explicit choice. The backward of K6 and K7 is autograd over the `*_jnp`
formula, as the JAX custom VJPs differentiate theirs; K2's is autograd over
its twin. Where no input needs a gradient, K2 and K6 launch outside the
autograd Function, which would cost more host time than their kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck

TF32_KEY_TILE = 32  # keys a tile of the float32 route (csrc/attention.cu tf::KEYS)
TF32_SEG_TILES = 8  # key tiles a segment of K7's float32 e.V (csrc/attention.cuh)


def attention_core_jnp(q, k, v):
    """softmax(Q K^T) V, unscaled, in the inputs' dtype (the JAX package's
    `attention_core_jnp`)."""
    scores = torch.einsum("bnd,bmd->bnm", q, k)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bnm,bmd->bnd", p, v)


def _ctx_and_recip(q, k, v):
    """The TPU kernels' unnormalized e.V and 1 / row sum, in float32:
    float32 scores, exp(s - max) rounded to V's dtype for the e.V product,
    float32 row sums (normalization comes after the product)."""
    scores = torch.einsum("bnd,bmd->bnm", q.float(), k.float())
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    recip = 1.0 / torch.sum(e, dim=-1, keepdim=True)
    return torch.einsum("bnm,bmd->bnd", e.to(v.dtype).float(), v.float()), recip


def attention_core_plain(q, k, v):
    """softmax(Q K^T) V with the TPU kernel's rounding (K6's twin)."""
    ctx, recip = _ctx_and_recip(q, k, v)
    return (ctx * recip).to(q.dtype)


def attention_block_plain(q, k, v, residual, gamma):
    """gamma * softmax(Q K^T) V + residual with the TPU kernel's rounding and
    a float32 epilogue (K2's twin)."""
    ctx, recip = _ctx_and_recip(q, k, v)
    g = torch.as_tensor(gamma, dtype=torch.float32, device=q.device)
    return ((g * recip) * ctx + residual.float()).to(q.dtype)


def _launch_attention(name, q, k, v, residual=None, gamma=None):
    """Launch K2 (residual and gamma, a float32 tensor of one element) or K6
    (neither) and return the output and its route. The host work is a
    handful of tensor calls: at the serving shape the kernel itself takes a
    few hundredths of a millisecond, so each call of host overhead shows in
    the time serving pays."""
    dev, dt = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    ins = (k, v) if residual is None else (k, v, residual, gamma)
    for t in ins:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got {t.device}")
    for t in ins[:3]:
        if t.dtype != dt:
            raise TypeError(f"{name}: q, k, v and residual must share one dtype")
    b, n, dk = q.shape
    dv = v.shape[-1]
    if k.shape != (b, n, dk) or v.shape != (b, n, dv) or (
            residual is not None and residual.shape != v.shape):
        raise ValueError(f"{name}: expected q, k (B, N, Dk) and v, residual (B, N, Dv)")
    if dk > 64 or dv > 256:
        raise ValueError(f"{name}: kernel takes Dk <= 64 and Dv <= 256, got {dk}, {dv}")
    dvp = -(-dv // 64) * 64
    if dvp != dv:
        # the kernels' value tiles are 64 wide: zero columns of V (and of the
        # residual) leave the softmax and the first Dv outputs as they are
        v = torch.nn.functional.pad(v, (0, dvp - dv))
        if residual is not None:
            residual = torch.nn.functional.pad(residual, (0, dvp - dv))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, n, dvp), dtype=dt, device=dev)
    lib, code, stream = ck.library(), ck.dtype_code(dt), ck.stream_ptr(dev)
    ptr, elems = None, 0
    if code == 0:  # the float32 route's TF32 hi / lo, written by its pre-pass
        elems = _tf32_scratch_elems(b, n, dk, dvp)
        scratch = torch.empty(elems, dtype=torch.float32, device=dev)
        ptr = scratch.data_ptr()
    if residual is None:
        err = lib.cic_attention_core(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), ptr, elems, b, n, dk, dvp, stream)
    else:
        if gamma.numel() != 1:
            raise ValueError(f"{name}: gamma must hold one value, got shape {tuple(gamma.shape)}")
        residual, gamma = residual.contiguous(), gamma.to(torch.float32)
        err = lib.cic_attention_block(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      residual.data_ptr(), gamma.data_ptr(), out.data_ptr(),
                                      ptr, elems, b, n, dk, dvp, stream)
    ck.check(err, name)
    if dvp != dv:
        out = out[..., :dv].contiguous()
    return out, ("tf32x3" if code == 0 else "wgmma")


def _tf32_scratch_elems(b, n, dk, dv, with_acc=False):
    """float32 elements of the float32 route's scratch: TF32 hi and lo of q
    and k at DK zero-padded to 32 or 64, and of V^T (B, DV, N rounded up to
    the key tile); with_acc (K7), where N takes more than one segment of
    TF32_SEG_TILES key tiles, e.V of every segment but the last, (segments
    - 1, B, N, DV) float32."""
    dkp = 32 if dk <= 32 else 64
    tiles = -(-n // TF32_KEY_TILE)
    acc = (-(-tiles // TF32_SEG_TILES) - 1) * b * n * dv if with_acc else 0
    return 4 * b * n * dkp + 2 * b * dv * tiles * TF32_KEY_TILE + acc


def _attention_core_kernel(q, k, v):
    """Launch K6."""
    out, route = _launch_attention("attention_core", q, k, v)
    attention_core.launches += 1
    attention_core.route_launches[route] += 1
    return out


def _attention_block_kernel(q, k, v, residual, gamma):
    """Launch K2. gamma: a float32 tensor of one element on q's device."""
    out, route = _launch_attention("attention_block", q, k, v, residual, gamma)
    attention_block.launches += 1
    attention_block.route_launches[route] += 1
    return out


class _Kernel(torch.autograd.Function):
    """forward: `fwd(*inputs)` (a kernel, or its twin on the CPU); backward:
    autograd over the formula `ref(*inputs)`, as the JAX custom VJPs
    differentiate theirs."""

    @staticmethod
    def forward(ctx, fwd, ref, *inputs):
        ctx.ref = ref
        ctx.save_for_backward(*inputs)
        return fwd(*inputs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.ref(*inputs)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None) + tuple(next(grads) if n else None for n in needs)


def attention_block(q, k, v, residual, gamma):
    """gamma * softmax(Q K^T) V + residual. gamma: 0-dim tensor or float."""
    if q.device.type == "cpu":
        return attention_block_plain(q, k, v, residual, gamma)
    if not torch.is_tensor(gamma):
        gamma = torch.tensor(float(gamma), device=q.device)
    if not ck.needs_grad(q, k, v, residual, gamma):
        return _attention_block_kernel(q, k, v, residual, gamma)
    return _Kernel.apply(_attention_block_kernel, attention_block_plain, q, k, v, residual,
                         gamma.float().reshape(()))


attention_block.launches = 0
# launches per route: "wgmma" (bf16), "tf32x3" (float32, three TF32 passes)
attention_block.route_launches = {"wgmma": 0, "tf32x3": 0}


def attention_core(q, k, v, use_pallas: bool = True):
    """softmax(Q K^T) V, unscaled. use_pallas=True: K6 on the card, its twin
    on the CPU; False: the jnp formula."""
    if not use_pallas:
        return attention_core_jnp(q, k, v)
    fwd = attention_core_plain if q.device.type == "cpu" else _attention_core_kernel
    if not ck.needs_grad(q, k, v):
        return fwd(q, k, v)
    return _Kernel.apply(fwd, attention_core_jnp, q, k, v)


attention_core.launches = 0
attention_core.route_launches = {"wgmma": 0, "tf32x3": 0}


# ----------------------------------------------------------------- K7a / K7b

def sagan_block_jnp(xf, wq, bq, wk, bk, wv, bv, gamma):
    """The JAX package's `sagan_block_jnp`: projections and biases in x's
    dtype, then gamma * softmax(Q K^T) V + x. xf (B, N, C); wq, wk (C, C/8)
    and wv (C, Dv) in (in, out) layout."""
    dt = xf.dtype
    q = torch.einsum("bnc,cf->bnf", xf, wq.to(dt)) + bq.to(dt)
    k = torch.einsum("bnc,cf->bnf", xf, wk.to(dt)) + bk.to(dt)
    v = torch.einsum("bnc,cf->bnf", xf, wv.to(dt)) + bv.to(dt)
    return gamma * attention_core_jnp(q, k, v) + xf


def sagan_block_spatial_jnp(x, wq, bq, wk, bk, wv, bv, gamma):
    """`sagan_block_jnp` on the (B, H, W, C) view."""
    b, h, w, c = x.shape
    out = sagan_block_jnp(x.reshape(b, h * w, c), wq, bq, wk, bk, wv, bv, gamma)
    return out.reshape(b, h, w, out.shape[-1])


def _project(x, w, bias):
    """x . W accumulated in float32 + the float32 bias, rounded to x's dtype
    (the TPU kernel's projections; W is cast to x's dtype first)."""
    dt = x.dtype
    return (torch.einsum("bnc,cf->bnf", x.float(), w.to(dt).float()) + bias.float()).to(dt)


def sagan_block_plain(xf, wq, bq, wk, bk, wv, bv, gamma):
    """The twin of K7a / K7b with the TPU kernel's rounding: q, k and v
    rounded to x's dtype after float32 accumulation and float32 bias, then
    K2's twin with the residual x itself."""
    q, k, v = _project(xf, wq, bq), _project(xf, wk, bk), _project(xf, wv, bv)
    return attention_block_plain(q, k, v, xf, gamma)


def _sagan_plain_spatial(x, *params):
    b, h, w, c = x.shape
    out = sagan_block_plain(x.reshape(b, h * w, c), *params)
    return out.reshape(b, h, w, out.shape[-1])


def _position_view(x):
    """(B, N, C) element strides of x (B, N, C) or (B, H, W, C), read in place
    where H and W fold into one position stride, else of a contiguous copy."""
    if x.dim() == 3:
        return x, tuple(x.stride())
    b, h, w, c = x.shape
    sb, sh, sw, sc = x.stride()
    if h > 1 and sh != w * sw:
        x = x.contiguous()
        sb, sh, sw, sc = x.stride()
    return x, (sb, sw, sc)


def _pack_qkv(wq, bq, wk, bk, wv, bv, dt):
    """K7's bf16 projection weights: [Wq | Wk | Wv] transposed to (out, in),
    K-major for the wgmma GEMM, in dt; and the three float32 biases in the
    same row order. Two copies in all: they run on every launch."""
    w = torch.cat([wq.to(dt).t(), wk.to(dt).t(), wv.to(dt).t()])
    bias = torch.cat([bq.reshape(-1), bk.reshape(-1), bv.reshape(-1)]).to(torch.float32)
    return w, bias


def _pack_qkv_tf32(wq, bq, wk, bk, wv, bv):
    """K7's float32 projection weights: the rows [Wq^T; 0; Wk^T; 0; Wv^T]
    (out, in), Q's and K's zero-padded to dkp = 32 (C/8 <= 32) or 64, so
    that the GEMM's 64-column tiles are all Q / K or all V and write K2's
    float32 scratch at its padded width; as TF32 hi and lo, (2, 2 dkp + C,
    C); and the float32 biases in the same rows, zeros in the padding."""
    inner = wq.shape[1]
    pad = (32 if inner <= 32 else 64) - inner
    w = torch.cat([F.pad(wq.float().t(), (0, 0, 0, pad)), F.pad(wk.float().t(), (0, 0, 0, pad)),
                   wv.float().t()])
    bias = torch.cat([F.pad(bq.reshape(-1).float(), (0, pad)),
                      F.pad(bk.reshape(-1).float(), (0, pad)), bv.reshape(-1).float()])
    return ck.tf32_split(w), bias


def _sagan_kernel(owner, x, wq, bq, wk, bk, wv, bv, gamma):
    """Launch K7 on x (B, N, C) or (B, H, W, C) in any layout whose positions
    share one stride; the output has x's shape and layout. A QKV GEMM, then
    K2's kernel, on the tensor cores: bf16 in one pass (route "wgmma"),
    float32 in three TF32 passes (route "tf32x3"). `owner` is the public
    wrapper whose launch and route counts move."""
    name = owner.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    dt = x.dtype
    code = ck.dtype_code(dt)
    c = x.shape[-1]
    n = x.numel() // (x.shape[0] * c) if x.numel() else 0
    inner, dv = wq.shape[-1], wv.shape[-1]
    if wq.shape != (c, inner) or wk.shape != (c, inner) or wv.shape != (c, dv):
        raise ValueError(f"{name}: expected wq, wk (C, C/8) and wv (C, Dv)")
    if dv != c or inner > 64 or c % 64 != 0 or c > 256:
        raise ValueError(f"{name}: kernel takes Dv == C in 64..256 step 64 and C/8 <= 64, "
                         f"got C {c}, inner {inner}, Dv {dv}")
    x, (sxb, sxn, sxc) = _position_view(x)
    out = torch.empty_like(x)
    _, (sob, son, soc) = _position_view(out)
    g = torch.as_tensor(gamma, dtype=torch.float32, device=x.device).reshape(1).contiguous()
    b = x.shape[0]
    lib, stream = ck.library(), ck.stream_ptr(x.device)
    if code == 1:
        wqkv, bias = _pack_qkv(wq, bq, wk, bk, wv, bv, dt)
        # Q, K (B, N, inner) and V (B, N, C) scratch in one allocation
        scratch = torch.empty(b * n * (2 * inner + c), dtype=dt, device=x.device)
        ck.require_cuda(name, wqkv, bias, g, scratch)
        ptr, size = scratch.data_ptr(), scratch.element_size()
        err = lib.cic_sagan_block_bf16(
            x.data_ptr(), sxb, sxn, sxc, wqkv.data_ptr(), bias.data_ptr(), g.data_ptr(),
            ptr, ptr + b * n * inner * size, ptr + 2 * b * n * inner * size, out.data_ptr(),
            sob, son, soc, b, n, c, inner, stream)
        route = "wgmma"
    else:
        wqkv, bias = _pack_qkv_tf32(wq, bq, wk, bk, wv, bv)
        # the TF32 hi and lo of Q, K and V^T, written by the GEMM, read by K2's
        # kernel, and its e.V segments but the last
        elems = _tf32_scratch_elems(b, n, inner, c, with_acc=True)
        scratch = torch.empty(elems, dtype=torch.float32, device=x.device)
        ck.require_cuda(name, wqkv, bias, g, scratch)
        err = lib.cic_sagan_block(
            x.data_ptr(), sxb, sxn, sxc, wqkv.data_ptr(), bias.data_ptr(), g.data_ptr(),
            scratch.data_ptr(), elems, out.data_ptr(), sob, son, soc, b, n, c, inner, stream)
        route = "tf32x3"
    ck.check(err, name)
    owner.launches += 1
    owner.route_launches[route] += 1
    return out


def _gamma_tensor(gamma, like):
    if torch.is_tensor(gamma):
        return gamma.float().reshape(())
    return torch.tensor(float(gamma), device=like.device)


def _sagan_apply(fwd, ref, x, *params):
    """fwd(x, *params) with gamma as a float32 0-dim tensor: outside autograd
    when nothing needs a gradient (the autograd Function costs host time),
    else through `_Kernel`, whose backward differentiates `ref`."""
    args = (x, *params[:-1], _gamma_tensor(params[-1], x))
    if not ck.needs_grad(*args):
        return fwd(*args)
    return _Kernel.apply(fwd, ref, *args)


def sagan_block(xf, wq, bq, wk, bk, wv, bv, gamma, use_pallas: bool = True):
    """gamma * softmax((x Wq + bq)(x Wk + bk)^T)(x Wv + bv) + x on the
    (B, N, C) view. use_pallas=True: K7a on the card, its twin on the CPU;
    False: the jnp formula."""
    if not use_pallas:
        return sagan_block_jnp(xf, wq, bq, wk, bk, wv, bv, gamma)
    if xf.device.type == "cpu":
        fwd = sagan_block_plain
    else:
        def fwd(*args):
            return _sagan_kernel(sagan_block, *args)
    return _sagan_apply(fwd, sagan_block_jnp, xf, wq, bq, wk, bk, wv, bv, gamma)


def sagan_block_spatial(x, wq, bq, wk, bk, wv, bv, gamma, use_pallas: bool = True):
    """`sagan_block` on the spatial (B, H, W, C) view, read in place (e.g. the
    port's NCHW activation as `x.permute(0, 2, 3, 1)`); the output keeps x's
    layout. use_pallas=True: K7b on the card, its twin on the CPU; False:
    the jnp formula."""
    if not use_pallas:
        return sagan_block_spatial_jnp(x, wq, bq, wk, bk, wv, bv, gamma)
    if x.device.type == "cpu":
        fwd = _sagan_plain_spatial
    else:
        def fwd(*args):
            return _sagan_kernel(sagan_block_spatial, *args)
    return _sagan_apply(fwd, sagan_block_spatial_jnp, x, wq, bq, wk, bk, wv, bv, gamma)


sagan_block.launches = 0
sagan_block_spatial.launches = 0
# launches per route: "wgmma" (bf16: the QKV GEMM and K2's kernel on the
# tensor cores), "tf32x3" (float32, three TF32 passes on the tensor cores)
sagan_block.route_launches = {"wgmma": 0, "tf32x3": 0}
sagan_block_spatial.route_launches = {"wgmma": 0, "tf32x3": 0}

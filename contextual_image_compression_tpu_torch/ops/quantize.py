"""Saliency-adaptive latent quantization: kernels K3 (forward) and K3b
(backward) and their plain twins.

K3 replaces the forward of `contextual_image_compression_tpu/ops/quantize.py::
_adaptive_quantize_pallas`. Per row: scale = exp(c * (q * (1 - sigma))),
out = rint(latent * scale) / scale, all in float32 whatever the storage
dtype, then cast back.

K3b replaces `_pallas_quant_bwd_scalepath`, the backward of the 'reference'
gradient mode: rint has zero derivative, so the latent gets no gradient and
only the scale path carries one, g_s = sum_d g * (-rint(latent * scale) /
scale^2), dsigma = g_s * c * scale * (-q), dq = g_s * c * scale * (1 - sigma).
The 'ste' mode passes the gradient straight to the latent and gives score and
strength none, so it needs no kernel.

`QuantizerConfig(use_pallas=False)` is the caller's choice of the JAX
package's jnp formula (`adaptive_quantize_reference_jnp` / `_ste_jnp`)
instead: plain PyTorch through autograd in the dtypes of its inputs (no
float32 upcast, unlike K3 and its twin), so neither K3 nor K3b launches.

`adaptive_quantize` launches K3 directly when no input needs a gradient (as
serving calls it, under `torch.no_grad()`), and otherwise runs both through
one autograd Function: on CUDA tensors it launches the kernels, on CPU
tensors it runs the twins. The kernels read score and strength in their own
dtype, and K3b writes their gradients in it, so a call launches nothing but
its kernel.
"""

from __future__ import annotations

import torch

from contextual_image_compression_tpu_torch.config import QuantizerConfig
from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck

DEFAULT_SCALE_COEFF = 3.0


def adaptive_quantize_plain(latent, saliency_score, quant_strength,
                            scale_coeff: float = DEFAULT_SCALE_COEFF):
    """The quantizer forward in plain PyTorch, float32 inside; score and
    strength (B, 1) or (B,)."""
    eff = quant_strength.float().reshape(-1, 1) * (1.0 - saliency_score.float().reshape(-1, 1))
    scale = torch.exp(scale_coeff * eff)
    return (torch.round(latent.float() * scale) / scale).to(latent.dtype)


def adaptive_quantize_bwd_plain(latent, saliency_score, quant_strength, g,
                                scale_coeff: float = DEFAULT_SCALE_COEFF):
    """The 'reference'-mode scale-path gradient in plain PyTorch, float32
    inside. Returns (dscore, dstrength) in the shapes and dtypes of score
    and strength."""
    q = quant_strength.float().reshape(-1, 1)
    sigma = saliency_score.float().reshape(-1, 1)
    scale = torch.exp(scale_coeff * (q * (1.0 - sigma)))
    rounded = torch.round(latent.float() * scale)
    g_scale = torch.sum(g.float() * (-rounded / (scale * scale)), dim=1, keepdim=True)
    g_eff = g_scale * scale_coeff * scale
    return ((g_eff * (-q)).to(saliency_score.dtype).reshape(saliency_score.shape),
            (g_eff * (1.0 - sigma)).to(quant_strength.dtype).reshape(quant_strength.shape))


def adaptive_quantize_reference_jnp(latent, saliency_score, quant_strength,
                                    scale_coeff: float = DEFAULT_SCALE_COEFF):
    """The JAX package's `adaptive_quantize_reference_jnp`: round(latent *
    scale) / scale with score and strength (B, 1). torch.round has a zero
    derivative, as jnp.round does, so autograd gives the 'reference' mode's
    gradients: none to the latent, the scale path's to score and strength.
    The scale is computed in the dtype of score and strength (Python scalars
    take the tensor's dtype in both frameworks)."""
    scale = torch.exp(scale_coeff * (quant_strength * (1.0 - saliency_score)))
    return torch.round(latent * scale) / scale


def adaptive_quantize_ste_jnp(latent, saliency_score, quant_strength,
                              scale_coeff: float = DEFAULT_SCALE_COEFF):
    """The JAX package's `adaptive_quantize_ste_jnp`: the same forward, the
    gradient straight through to the latent and none to score and strength."""
    q = adaptive_quantize_reference_jnp(latent.detach(), saliency_score.detach(),
                                        quant_strength.detach(), scale_coeff)
    return latent + (q - latent).detach()


def _rows(name, latent, saliency_score, quant_strength):
    """Check a (B, D) latent on the card with one score and one strength per
    row ((B, 1) or (B,), float32 or bfloat16); returns B, D and the three
    tensors contiguous. Nothing is cast: the kernels read each dtype as
    stored."""
    if latent.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {latent.device}")
    if latent.ndim != 2:
        raise ValueError(f"{name}: latent must be (B, D)")
    b, d = latent.shape
    if saliency_score.numel() != b or quant_strength.numel() != b:
        raise ValueError(f"{name}: score and strength must be (B, 1)")
    return b, d, latent.contiguous(), saliency_score.contiguous(), quant_strength.contiguous()


def _quantize_kernel(latent, saliency_score, quant_strength, scale_coeff):
    b, d, latent, score, strength = _rows("adaptive_quantize", latent, saliency_score,
                                          quant_strength)
    ck.require_cuda("adaptive_quantize", latent, score, strength)
    out = torch.empty_like(latent)
    err = ck.library().cic_adaptive_quantize(
        ck.dtype_code(latent.dtype), latent.data_ptr(), score.data_ptr(),
        ck.dtype_code(score.dtype), strength.data_ptr(), ck.dtype_code(strength.dtype),
        float(scale_coeff), out.data_ptr(), b, d, ck.stream_ptr(latent.device),
    )
    ck.check(err, "adaptive_quantize")
    adaptive_quantize.launches += 1
    return out


def adaptive_quantize_bwd(latent, saliency_score, quant_strength, g,
                          scale_coeff: float = DEFAULT_SCALE_COEFF):
    """(dscore, dstrength) of the 'reference' mode for the upstream gradient
    g of the quantized (B, D) latent, in the shapes and dtypes of score and
    strength. Launches K3b for CUDA tensors (which writes both in those
    dtypes itself); the plain twin runs for CPU tensors."""
    if latent.device.type == "cpu":
        return adaptive_quantize_bwd_plain(latent, saliency_score, quant_strength, g, scale_coeff)
    b, d, latent, score, strength = _rows("adaptive_quantize_bwd", latent, saliency_score,
                                          quant_strength)
    if g.shape != latent.shape or g.dtype != latent.dtype:
        raise ValueError("adaptive_quantize_bwd: g must have the latent's shape and dtype")
    g = g.contiguous()
    ck.require_cuda("adaptive_quantize_bwd", latent, g, score, strength)
    dscore = torch.empty(score.shape, dtype=score.dtype, device=latent.device)
    dstrength = torch.empty(strength.shape, dtype=strength.dtype, device=latent.device)
    err = ck.library().cic_adaptive_quantize_bwd(
        ck.dtype_code(latent.dtype), latent.data_ptr(), g.data_ptr(), score.data_ptr(),
        ck.dtype_code(score.dtype), strength.data_ptr(), ck.dtype_code(strength.dtype),
        float(scale_coeff), dscore.data_ptr(), dstrength.data_ptr(), b, d,
        ck.stream_ptr(latent.device),
    )
    ck.check(err, "adaptive_quantize_bwd")
    adaptive_quantize_bwd.launches += 1
    return dscore, dstrength


adaptive_quantize_bwd.launches = 0


class _AdaptiveQuantize(torch.autograd.Function):
    """K3 forward; backward by grad_mode: 'reference' gives (0, K3b's dscore,
    K3b's dstrength), 'ste' gives (g, 0, 0)."""

    @staticmethod
    def forward(ctx, latent, saliency_score, quant_strength, scale_coeff, grad_mode):
        ctx.scale_coeff, ctx.grad_mode = scale_coeff, grad_mode
        ctx.save_for_backward(latent, saliency_score, quant_strength)
        if latent.device.type == "cpu":
            return adaptive_quantize_plain(latent, saliency_score, quant_strength, scale_coeff)
        return _quantize_kernel(latent, saliency_score, quant_strength, scale_coeff)

    @staticmethod
    def backward(ctx, g):
        latent, score, strength = ctx.saved_tensors
        if ctx.grad_mode == "ste":
            return g, torch.zeros_like(score), torch.zeros_like(strength), None, None
        dscore = dstrength = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dscore, dstrength = adaptive_quantize_bwd(latent, score, strength, g,
                                                      ctx.scale_coeff)
        return torch.zeros_like(latent), dscore, dstrength, None, None


def adaptive_quantize(latent, saliency_score, quant_strength,
                      config: QuantizerConfig | None = None):
    """Quantize (B, D) latents with (B, 1) saliency scores and strengths.
    Launches K3 for CUDA tensors and, in the backward of the 'reference'
    mode, K3b; the plain twins run for CPU tensors. use_pallas=False runs
    the jnp formula of the grad mode on either device."""
    cfg = config or QuantizerConfig()
    if cfg.grad_mode == "auto":
        raise ValueError(
            "grad_mode='auto' is a topology-level default; resolve it first via "
            "ModelConfig.resolved_quantizer()"
        )
    if cfg.grad_mode not in ("reference", "ste"):
        raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")
    if not cfg.use_pallas:
        fn = adaptive_quantize_ste_jnp if cfg.grad_mode == "ste" else adaptive_quantize_reference_jnp
        return fn(latent, saliency_score, quant_strength, float(cfg.scale_coeff))
    if not ck.needs_grad(latent, saliency_score, quant_strength):
        # no autograd Function: one kernel launch (or the twin on the CPU)
        if latent.device.type == "cpu":
            return adaptive_quantize_plain(latent, saliency_score, quant_strength,
                                           float(cfg.scale_coeff))
        return _quantize_kernel(latent, saliency_score, quant_strength, float(cfg.scale_coeff))
    return _AdaptiveQuantize.apply(latent, saliency_score, quant_strength,
                                   float(cfg.scale_coeff), cfg.grad_mode)


adaptive_quantize.launches = 0

"""The adaptive dual-branch codec in plain PyTorch, on a dict of tensors.

Layers (NCHW; weights: conv (O, I, k, k), transposed conv (I, O, 4, 4),
dense (out, in)):

  encoder:   conv k4 s2 -> LeakyReLU 0.2                 -> skip1
             conv k4 s2 -> BN -> LeakyReLU               -> skip2
             conv k4 s2 -> BN -> LeakyReLU               -> skip3
             [HQ only: x + gamma * softmax(Q K^T) V, Q / K / V 1x1 projections]
             conv k4 s2 -> BN -> LeakyReLU -> flatten -> dense (latent)
  generator: dense -> (512, 16, 16) -> BN -> LeakyReLU
             3x (deconv 4x4 s2 -> BN -> LeakyReLU -> concat skip3 / skip2 / skip1)
             deconv 4x4 s2 -> BN -> LeakyReLU -> conv k4 s1 -> tanh
  latent saliency: dense 512 relu -> dense 256 relu -> dense 1 sigmoid
  rate schedule:   b = clip(bpp / 5, 0, 1); threshold = 0.9 - 0.85 b;
                   strength = 0.9 - 0.8 b
  quantizer:       round(z * s) / s, s = exp(3 strength (1 - saliency))
  blend:           hq * t + lq * (1 - t), t = sigmoid(20 (mask^0.7 - threshold))
  RD net:          two conv k3 s2 on the mask, mean, dense 128, dense 3, sigmoids

Padding is SAME as XLA computes it: k4 s2 pads (1, 1), k3 s2 (0, 1), k4 s1
(1, 2). BatchNorm: eps 1e-3, running = 0.99 running + 0.01 batch with the
biased batch variance.

Serving (`serving_params`) is the configuration's inference form, worked
out here from the float32 weights: the four latent / fc projections as
int8 rows times a float32 scale per row (max |w| / 127), quantized from
float32 when they hold 2^23 weights or more and from their bfloat16 values
otherwise; every other parameter and statistic rounded to bfloat16; the
last deconv with its BatchNorm folded in (weight * scale rounded to
bfloat16, shift = bias + (deconv bias - mean) * scale), its output stored
as int8 per channel (amax = max(|bn bias|, |shift|) + 8 |bn scale|) and the
out conv's weight times amax / 127 rounded to bfloat16. The forward itself
runs in float32; `rnd` (precision.Rounding) rounds the operands of every
product and the results each layer keeps (a control).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import FLOAT32

Params = Dict[str, torch.Tensor]
W8_MIN_ELEMS = 1 << 23
W8_LAYERS = ("hq_encoder.latent_dense", "lq_encoder.latent_dense",
             "hq_generator.fc", "lq_generator.fc")
BN_EPS = 1e-3
BN_MOMENTUM = 0.99


# ------------------------------------------------------------------ shapes
def codec_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and BatchNorm statistic of the codec, by name, from
    the configuration's model block."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    h, w = m["img_size"]
    c1, c2, c3, c4 = m["encoder_channels"]
    d = m["base_latent_dim"]

    def conv(name, cin, cout, k):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{leaf}"] = (c,)

    def dense(name, cin, cout):
        shapes[f"{name}.weight"] = (cout, cin)
        shapes[f"{name}.bias"] = (cout,)

    for branch, latent, attention in (("hq", 2 * d, m["hq_attention"]), ("lq", d, False)):
        e = f"{branch}_encoder"
        conv(f"{e}.conv1", m["channels"], c1, 4)
        conv(f"{e}.conv2", c1, c2, 4)
        bn(f"{e}.bn2", c2)
        conv(f"{e}.conv3", c2, c3, 4)
        bn(f"{e}.bn3", c3)
        if attention:
            conv(f"{e}.attention.query_conv", c3, c3 // 8, 1)
            conv(f"{e}.attention.key_conv", c3, c3 // 8, 1)
            conv(f"{e}.attention.value_conv", c3, c3, 1)
            shapes[f"{e}.attention.gamma"] = (1,)
        conv(f"{e}.conv4", c3, c4, 4)
        bn(f"{e}.bn4", c4)
        dense(f"{e}.latent_dense", c4 * (h // 16) * (w // 16), latent)

        g = f"{branch}_generator"
        base, hw = m["generator_base_ch"], m["generator_base_hw"]
        dense(f"{g}.fc", latent, base * hw * hw)
        bn(f"{g}.bn0", base)
        concat = (c3, c2, c1, 0)
        cin = base
        for i, (ch, extra) in enumerate(zip(m["generator_channels"], concat), start=1):
            shapes[f"{g}.deconv{i}.weight"] = (cin, ch, 4, 4)
            shapes[f"{g}.deconv{i}.bias"] = (ch,)
            bn(f"{g}.bn{i}", ch)
            cin = ch + extra
        conv(f"{g}.out_conv", m["generator_channels"][3], m["channels"], 4)

        s = f"latent_saliency_{branch}"
        dense(f"{s}.dense1", latent, 512)
        dense(f"{s}.dense2", 512, 256)
        dense(f"{s}.out", 256, 1)
    conv("rd_optimizer.conv1", 1, 32, 3)
    conv("rd_optimizer.conv2", 32, 64, 3)
    dense("rd_optimizer.dense", 65, 128)
    dense("rd_optimizer.base_params", 128, 3)
    return shapes


# ------------------------------------------------------------------ layers
def _same(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride, rnd=FLOAT32):
    k = w.shape[-1]
    ph, pw = _same(x.shape[-2], k, stride), _same(x.shape[-1], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    op = rnd.operands
    return rnd.results(F.conv2d(op(x), op(w), stride=stride) + b[:, None, None])


def deconv(x, w, b, rnd=FLOAT32):
    op = rnd.operands
    return rnd.results(F.conv_transpose2d(op(x), op(w), stride=2, padding=1)
                       + b[:, None, None])


def dense(x, w, b, rnd=FLOAT32):
    return rnd.results(rnd.operands(x) @ rnd.operands(w).T + b)


def leaky(x, slope=0.2):
    return torch.where(x >= 0, x, x * slope)


def batch_norm(p: Params, name: str, x, stats=None, rnd=FLOAT32):
    """Inference BN on the running statistics, or, with `stats` (a dict),
    on the batch's (mean, biased variance), which go into stats[name]."""
    if stats is None:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    else:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        stats[name] = (mean.detach(), var.detach())
    mul = torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"]
    return rnd.results((x - mean[:, None, None]) * mul[:, None, None]
                       + p[f"{name}.bias"][:, None, None])


def attention(p: Params, name: str, x, rnd=FLOAT32):
    """x + gamma * softmax(Q K^T) V over the H W positions (no 1/sqrt(d))."""
    b, c, h, w = x.shape
    xf = x.flatten(2).transpose(1, 2)  # (B, N, C)

    def proj(conv_name):
        wt = p[f"{name}.{conv_name}.weight"]
        return dense(xf, wt.reshape(wt.shape[0], c), p[f"{name}.{conv_name}.bias"], rnd)

    q, k, v = proj("query_conv"), proj("key_conv"), proj("value_conv")
    op = rnd.operands
    attn = rnd.results(torch.softmax(op(q) @ op(k).transpose(1, 2), dim=-1))
    out = rnd.results(p[f"{name}.gamma"] * (op(attn) @ op(v)) + xf)
    return out.transpose(1, 2).reshape(b, c, h, w)


def encoder(p, name, x, m, stats=None, rnd=FLOAT32):
    s = m["leaky_slope"]
    x1 = leaky(conv(x, p[f"{name}.conv1.weight"], p[f"{name}.conv1.bias"], 2, rnd), s)
    x2 = leaky(batch_norm(p, f"{name}.bn2", conv(x1, p[f"{name}.conv2.weight"],
                                                  p[f"{name}.conv2.bias"], 2, rnd), stats, rnd), s)
    x3 = leaky(batch_norm(p, f"{name}.bn3", conv(x2, p[f"{name}.conv3.weight"],
                                                  p[f"{name}.conv3.bias"], 2, rnd), stats, rnd), s)
    y = attention(p, f"{name}.attention", x3, rnd) if f"{name}.attention.gamma" in p else x3
    x4 = leaky(batch_norm(p, f"{name}.bn4", conv(y, p[f"{name}.conv4.weight"],
                                                  p[f"{name}.conv4.bias"], 2, rnd), stats, rnd), s)
    latent = dense(x4.reshape(x4.shape[0], -1), p[f"{name}.latent_dense.weight"],
                   p[f"{name}.latent_dense.bias"], rnd)
    return latent, (x1, x2, x3)


def generator(p, name, z, skips, m, stats=None, rnd=FLOAT32, tail=None):
    """tail: None for the native tail; the folded int8 tail's tensors
    (`serving_params`) at inference."""
    s = m["leaky_slope"]
    base, hw = m["generator_base_ch"], m["generator_base_hw"]
    x = dense(z, p[f"{name}.fc.weight"], p[f"{name}.fc.bias"], rnd)
    x = leaky(batch_norm(p, f"{name}.bn0", x.reshape(z.shape[0], base, hw, hw), stats, rnd), s)
    for i, skip in enumerate(reversed(skips), start=1):
        y = deconv(x, p[f"{name}.deconv{i}.weight"], p[f"{name}.deconv{i}.bias"], rnd)
        x = torch.cat([leaky(batch_norm(p, f"{name}.bn{i}", y, stats, rnd), s), skip], dim=1)
    if tail is None:
        y = deconv(x, p[f"{name}.deconv4.weight"], p[f"{name}.deconv4.bias"], rnd)
        y = leaky(batch_norm(p, f"{name}.bn4", y, stats, rnd), s)
        out = conv(y, p[f"{name}.out_conv.weight"], p[f"{name}.out_conv.bias"], 1, rnd)
        return rnd.results(torch.tanh(out))
    folded, shift, amax, out_w = tail
    y = F.conv_transpose2d(rnd.operands(x), rnd.operands(folded), stride=2, padding=1)
    y = leaky(rnd.results(y + shift[:, None, None]), s)
    q = torch.clamp(torch.round(y * (127.0 / amax)[:, None, None]), -127.0, 127.0)
    return rnd.results(torch.tanh(conv(q, out_w, p[f"{name}.out_conv.bias"], 1, rnd)))


def latent_saliency(p, name, z, rnd=FLOAT32):
    x = torch.relu(dense(z, p[f"{name}.dense1.weight"], p[f"{name}.dense1.bias"], rnd))
    x = torch.relu(dense(x, p[f"{name}.dense2.weight"], p[f"{name}.dense2.bias"], rnd))
    return torch.sigmoid(dense(x, p[f"{name}.out.weight"], p[f"{name}.out.bias"], rnd))


def rd_net(p, mask, bpp, m, rnd=FLOAT32):
    s = m["leaky_slope"]
    b = torch.clamp(bpp / m["bpp_norm_divisor"], 0.0, 1.0)
    x = leaky(conv(mask, p["rd_optimizer.conv1.weight"], p["rd_optimizer.conv1.bias"], 2, rnd), s)
    x = leaky(conv(x, p["rd_optimizer.conv2.weight"], p["rd_optimizer.conv2.bias"], 2, rnd), s)
    x = torch.cat([x.mean(dim=(2, 3)), b], dim=-1)
    x = leaky(dense(x, p["rd_optimizer.dense.weight"], p["rd_optimizer.dense.bias"], rnd), s)
    base = dense(x, p["rd_optimizer.base_params.weight"], p["rd_optimizer.base_params.bias"], rnd)
    return torch.cat([torch.sigmoid(base[:, 0:1] + 1.0 - 2.0 * b),
                      torch.sigmoid(base[:, 1:2] + 1.0 - 2.0 * b),
                      torch.sigmoid(base[:, 2:3] + 1.0 - 1.5 * b)], dim=-1)


def schedule(bpp, m):
    b = torch.clamp(bpp / m["bpp_norm_divisor"], 0.0, 1.0)
    threshold = m["hq_lq_threshold_base"] - m["hq_lq_threshold_slope"] * b
    strength = m["quant_strength_base"] - m["quant_strength_slope"] * b
    return threshold, strength


def quant_scale(strength, saliency, coeff):
    return torch.exp(coeff * strength * (1.0 - saliency))


def quantize(z, saliency, strength, coeff):
    """round(z s) / s; torch.round's zero derivative leaves the gradient to
    the saliency score and the strength through s."""
    s = quant_scale(strength, saliency, coeff)
    return torch.round(z * s) / s


def blend_map(mask, threshold, m):
    t = torch.pow(torch.clamp(mask, min=0.0), m["saliency_gamma"])
    return torch.sigmoid((t - threshold[:, :, None, None]) * m["threshold_sharpness"])


# ------------------------------------------------------------------ serving
def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def serving_params(sd32: Params, m: dict):
    """(params, tails): the configuration's inference weights as float32
    tensors, and each generator's folded int8 tail (see the module
    docstring)."""
    p = {k: _bf16(v.float()) for k, v in sd32.items()}
    for name in W8_LAYERS:
        w32 = sd32[f"{name}.weight"].float()
        src = w32 if w32.numel() >= W8_MIN_ELEMS else _bf16(w32)
        s = src.abs().amax(dim=1, keepdim=True) / 127.0
        p[f"{name}.weight"] = torch.round(src / torch.clamp(s, min=1e-12)) * s
    tails = {}
    for g in ("hq_generator", "lq_generator"):
        scale = p[f"{g}.bn4.weight"] * torch.rsqrt(p[f"{g}.bn4.running_var"] + BN_EPS)
        shift = p[f"{g}.bn4.bias"] + (p[f"{g}.deconv4.bias"] - p[f"{g}.bn4.running_mean"]) * scale
        folded = _bf16(p[f"{g}.deconv4.weight"] * scale[None, :, None, None])
        amax = torch.clamp(torch.maximum(p[f"{g}.bn4.bias"].abs(), shift.abs())
                           + 8.0 * p[f"{g}.bn4.weight"].abs(), min=1e-6)
        out_w = _bf16(p[f"{g}.out_conv.weight"] * (amax / 127.0)[None, :, None, None])
        tails[g] = (folded, shift, amax, out_w)
    return p, tails


@torch.no_grad()
def serve(p: Params, tails, m: dict, images_u8, mask, bpp: float, coeff: float,
          rnd=FLOAT32):
    """One serving call: (B, H, W, 3) uint8 and (B, H, W) masks -> decoded
    uint8 (B, H, W, 3) and the latent symbols (hq, lq) in float32."""
    x = (images_u8.float() / 127.5 - 1.0).permute(0, 3, 1, 2)
    mk = mask.float()[:, None]
    b = torch.full((x.shape[0], 1), float(bpp), device=x.device)
    hq, hq_skips = encoder(p, "hq_encoder", x, m, rnd=rnd)
    lq, lq_skips = encoder(p, "lq_encoder", x, m, rnd=rnd)
    threshold, strength = schedule(b, m)
    t = blend_map(mk, threshold, m)
    s_hq = latent_saliency(p, "latent_saliency_hq", hq, rnd)
    s_lq = latent_saliency(p, "latent_saliency_lq", lq, rnd)
    rd_net(p, mk, b, m, rnd)  # computed on the served path, feeds nothing here
    hq_out = generator(p, "hq_generator", quantize(hq, s_hq, strength, coeff), hq_skips, m,
                       rnd=rnd, tail=tails["hq_generator"])
    lq_out = generator(p, "lq_generator", quantize(lq, s_lq, strength, coeff), lq_skips, m,
                       rnd=rnd, tail=tails["lq_generator"])
    blended = rnd.results(hq_out * t + lq_out * (1.0 - t))
    decoded = torch.clamp(torch.round((blended + 1.0) * 127.5), 0, 255).to(torch.uint8)
    hq_sym = torch.round(hq * quant_scale(strength, s_hq, coeff))
    lq_sym = torch.round(lq * quant_scale(strength, s_lq, coeff))
    return decoded.permute(0, 2, 3, 1), hq_sym, lq_sym


# ------------------------------------------------------------------ training
def train_forward(p: Params, m: dict, image, mask, bpp, coeff: float, stats: dict,
                  rnd=FLOAT32):
    """The training forward (BatchNorm on batch statistics, the native
    tail, float projections), routed as the three optimizers' gradients
    are: the quantizer's saliency from the LS nets with their parameters
    cut from the graph, the LS loss's score from the latent cut from it.
    image (B, 3, H, W) in [-1, 1], mask (B, 1, H, W), bpp (B, 1)."""
    hq, hq_skips = encoder(p, "hq_encoder", image, m, stats, rnd)
    lq, lq_skips = encoder(p, "lq_encoder", image, m, stats, rnd)
    threshold, strength = schedule(bpp, m)
    t = blend_map(mask, threshold, m)
    frozen = {k: v.detach() for k, v in p.items() if k.startswith("latent_saliency_")}
    s_hq = latent_saliency(frozen, "latent_saliency_hq", hq, rnd)
    s_lq = latent_saliency(frozen, "latent_saliency_lq", lq, rnd)
    s_hq_loss = latent_saliency(p, "latent_saliency_hq", hq.detach(), rnd)
    s_lq_loss = latent_saliency(p, "latent_saliency_lq", lq.detach(), rnd)
    rd = rd_net(p, mask, bpp, m, rnd)
    hq_out = generator(p, "hq_generator", quantize(hq, s_hq, strength, coeff), hq_skips, m,
                       stats, rnd)
    lq_out = generator(p, "lq_generator", quantize(lq, s_lq, strength, coeff), lq_skips, m,
                       stats, rnd)
    blended = hq_out * t + lq_out * (1.0 - t)
    return {"blended": blended, "t": t, "rd": rd, "s_hq": s_hq_loss, "s_lq": s_lq_loss}


"""HiFiC (arXiv:2006.09965, tensorflow/compression models/hific) in plain
PyTorch, on a dict of tensors named as the program's state dict. It imports
nothing of the program and nothing of JAX.

Layers (NCHW; conv weights (O, I, k, k), transposed (I, O, k, k)):

  E:   conv 7x7/s1, CN, ReLU; 4x (conv 3x3/s2, CN, ReLU); conv 3x3/s1 -> y
  h_a: conv 3x3/s1, ReLU, conv 5x5/s2, ReLU, conv 5x5/s2 -> z
  z:   z_sym = round(z - m), z_hat = z_sym + m; factorized prior
  h_s: mu and sigma each: ConvT 5x5/s2, ReLU, ConvT 5x5/s2, ReLU, conv 3x3;
       sigma = max(sigma, 0.11)
  y:   y_sym = round(y - mu), y_hat = y_sym + mu; Gaussian likelihood
  G:   CN, conv 3x3, CN; blocks x + [conv, CN, ReLU, conv, CN](x); the head
       added back; 4x (ConvT 3x3/s2, CN, ReLU); conv 7x7 -> x_hat

A convolution pads SAME with zeros as XLA computes it (stride-2 3x3: (0,
1); 5x5: (1, 2)). A transposed convolution is written out: the input
dilated by 2, padded by k - 1, correlated with the flipped kernel, and
positions [lo, lo + 2H) kept, lo the low padding of the SAME convolution
from 2H to H. CN normalizes each pixel over its channels with the biased
variance, eps 1e-3. The likelihood of y's symbol s is Phi((0.5 - |s|) /
sigma) - Phi((-0.5 - |s|) / sigma); of z_hat the factorized prior's
sigmoid(f(v + 0.5)) - sigmoid(f(v - 0.5)), f through widths 1 -> 3 -> 3 ->
3 -> 1 (v <- softplus(H) v + b, then v + tanh(a) tanh(v) but after the
last); both bounded below at 1e-9; bits = -sum log2.

Rounding (`rnd`, precision.Rounding): `operands` where the program holds a
value in its compute dtype before a product (conv inputs and weights and
biases, CN's scale and shift, z_hat and y_hat as the syntheses take them,
the input image), `results` where it stores a layer's result (each
convolution's product, then the sum with its bias; each CN's output; each
residual sum). bfloat16 for both is the program's serving precision;
FLOAT32 computes everything in float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import FLOAT32

Params = Dict[str, torch.Tensor]


def shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter by name, from the configuration's model block."""
    out: Dict[str, Tuple[int, ...]] = {}
    f = list(m["encoder_filters"])
    cy, n = m["latent_channels"], m["hyper_channels"]

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)

    def conv_t(name, cin, cout, k):
        out[f"{name}.weight"] = (cin, cout, k, k)
        out[f"{name}.bias"] = (cout,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    conv("analysis.conv0", m["channels"], f[0], 7)
    norm("analysis.norm0", f[0])
    for i, (a, b) in enumerate(zip(f, f[1:])):
        conv(f"analysis.down.{i}", a, b, 3)
    for i, b in enumerate(f[1:]):
        norm(f"analysis.down_norm.{i}", b)
    conv("analysis.out", f[-1], cy, 3)
    g = f[::-1]
    norm("synthesis.norm_in", cy)
    conv("synthesis.head", cy, g[0], 3)
    norm("synthesis.norm_head", g[0])
    for i in range(m["residual_blocks"]):
        for j in (1, 2):
            conv(f"synthesis.blocks.{i}.conv{j}", g[0], g[0], 3)
            norm(f"synthesis.blocks.{i}.norm{j}", g[0])
    for i, (a, b) in enumerate(zip(g, g[1:])):
        conv_t(f"synthesis.up.{i}", a, b, 3)
    for i, b in enumerate(g[1:]):
        norm(f"synthesis.up_norm.{i}", b)
    conv("synthesis.out", g[-1], m["channels"], 7)
    conv("hyper_analysis.conv1", cy, n, 3)
    conv("hyper_analysis.conv2", n, n, 5)
    conv("hyper_analysis.conv3", n, n, 5)
    for head in ("hyper_mean", "hyper_scale"):
        conv_t(f"{head}.up1", n, n, 5)
        conv_t(f"{head}.up2", n, n, 5)
        conv(f"{head}.out", n, cy, 3)
    dims = [1] + list(m["factorized_filters"]) + [1]
    for k in range(len(dims) - 1):
        out[f"z_prior.matrix{k}"] = (n, dims[k + 1], dims[k])
        out[f"z_prior.bias{k}"] = (n, dims[k + 1], 1)
        if k < len(dims) - 2:
            out[f"z_prior.factor{k}"] = (n, dims[k + 1], 1)
    out["z_prior.offset"] = (n,)
    return out


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(p: Params, name: str, x, stride: int = 1, rnd=FLOAT32):
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    ph, pw = _same(x.shape[-2], k, stride), _same(x.shape[-1], k, stride)
    y = F.conv2d(F.pad(rnd.operands(x), (pw[0], pw[1], ph[0], ph[1])), rnd.operands(w),
                 stride=stride)
    return rnd.results(rnd.results(y) + rnd.operands(p[f"{name}.bias"])[:, None, None])


def conv_t(p: Params, name: str, x, rnd=FLOAT32):
    """Stride-2 SAME transposed convolution, written out (module docstring)."""
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    b, c, h, wd = x.shape
    dilated = x.new_zeros((b, c, 2 * h - 1, 2 * wd - 1))
    dilated[:, :, ::2, ::2] = rnd.operands(x)
    full = F.conv2d(F.pad(dilated, (k - 1,) * 4), rnd.operands(w).flip(2, 3).transpose(0, 1))
    lo = _same(2 * h, k, 2)[0]
    y = full[:, :, lo:lo + 2 * h, lo:lo + 2 * wd]
    return rnd.results(rnd.results(y) + rnd.operands(p[f"{name}.bias"])[:, None, None])


def channel_norm(p: Params, name: str, x, eps: float, relu: bool = False, rnd=FLOAT32):
    x = x.float()
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    y = y * rnd.operands(p[f"{name}.weight"])[:, None, None] \
        + rnd.operands(p[f"{name}.bias"])[:, None, None]
    return rnd.results(torch.relu(y) if relu else y)


def encoder(p: Params, m: dict, x, rnd=FLOAT32):
    eps = m["norm_eps"]
    x = channel_norm(p, "analysis.norm0", conv(p, "analysis.conv0", x, 1, rnd), eps, True, rnd)
    for i in range(len(m["encoder_filters"]) - 1):
        x = channel_norm(p, f"analysis.down_norm.{i}", conv(p, f"analysis.down.{i}", x, 2, rnd),
                         eps, True, rnd)
    return conv(p, "analysis.out", x, 1, rnd)


def generator(p: Params, m: dict, y_hat, rnd=FLOAT32):
    eps = m["norm_eps"]
    x = channel_norm(p, "synthesis.norm_in", rnd.operands(y_hat), eps, rnd=rnd)
    head = channel_norm(p, "synthesis.norm_head", conv(p, "synthesis.head", x, 1, rnd), eps,
                        rnd=rnd)
    x = head
    for i in range(m["residual_blocks"]):
        b = f"synthesis.blocks.{i}"
        r = channel_norm(p, f"{b}.norm1", conv(p, f"{b}.conv1", x, 1, rnd), eps, True, rnd)
        r = channel_norm(p, f"{b}.norm2", conv(p, f"{b}.conv2", r, 1, rnd), eps, rnd=rnd)
        x = rnd.results(x + r)
    x = rnd.results(x + head)
    for i in range(len(m["encoder_filters"]) - 1):
        x = channel_norm(p, f"synthesis.up_norm.{i}", conv_t(p, f"synthesis.up.{i}", x, rnd),
                         eps, True, rnd)
    return conv(p, "synthesis.out", x, 1, rnd)


def hyper_synthesis(p: Params, head: str, z_hat, rnd=FLOAT32):
    x = torch.relu(conv_t(p, f"{head}.up1", rnd.operands(z_hat), rnd))
    x = torch.relu(conv_t(p, f"{head}.up2", x, rnd))
    return conv(p, f"{head}.out", x, 1, rnd)


def std_cumulative(x):
    """Phi(x) as TF-Compression computes it, 0.5 erfc(-x / sqrt(2)): exact
    in the lower tail, where 0.5 (1 + erf) cancels in float32."""
    return 0.5 * torch.erfc(-(2.0 ** -0.5) * x)


def z_likelihood(p: Params, m: dict, z_hat):
    """The factorized prior's likelihood of each value of z_hat, float32."""
    b, c, h, w = z_hat.shape
    layers = len(m["factorized_filters"]) + 1

    def logits(v):
        for k in range(layers):
            v = torch.einsum("cba,can->cbn", F.softplus(p[f"z_prior.matrix{k}"].float()), v)
            v = v + p[f"z_prior.bias{k}"].float()
            if k < layers - 1:
                v = v + torch.tanh(p[f"z_prior.factor{k}"].float()) * torch.tanh(v)
        return v

    v = z_hat.permute(1, 0, 2, 3).reshape(c, 1, -1)
    lower, upper = logits(v - 0.5), logits(v + 0.5)
    sign = -torch.sign(lower + upper)
    lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    return lik.reshape(c, b, h, w).permute(1, 0, 2, 3)


def serve(p: Params, m: dict, images_u8, rnd=FLOAT32, given=None) -> Dict[str, torch.Tensor]:
    """uint8 (B, H, W, 3) -> decoded uint8 (B, H, W, 3), the symbols of y
    and z, bits per image, and the share of sigma at its lower bound.

    given: the symbols another coder sent ({"y_symbols", "z_symbols"}).
    The reference then decodes those, as a receiver would: mu and sigma
    from the given z, bits of the given symbols, the image from the given
    y. Its own z symbols are still its encoder's, and its own y symbols
    are taken against the mu of the given z, so that a symbol flipped by
    rounding is counted once and does not move every symbol and pixel that
    depends on it; `y_symbols_free` holds those against its own z."""
    _, h, w, _ = images_u8.shape
    k = 2 ** (len(m["encoder_filters"]) - 1) * 4  # E's stride, then h_a's
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    if h % k or w % k:
        x = F.pad(x, (0, -w % k, 0, -h % k), mode="reflect")
    y = encoder(p, m, rnd.operands(x), rnd)
    x = torch.relu(conv(p, "hyper_analysis.conv1", y, 1, rnd))
    x = torch.relu(conv(p, "hyper_analysis.conv2", x, 2, rnd))
    z = conv(p, "hyper_analysis.conv3", x, 2, rnd)
    offset = p["z_prior.offset"].float()[:, None, None]
    z_sym = torch.round(z - offset)
    out = {}
    if given is not None:
        out["y_symbols_free"] = torch.round(
            y - hyper_synthesis(p, "hyper_mean", z_sym + offset, rnd))
        z_sent = given["z_symbols"].to(z_sym)
    else:
        z_sent = z_sym
    z_hat = z_sent + offset
    mu = hyper_synthesis(p, "hyper_mean", z_hat, rnd)
    raw_sigma = hyper_synthesis(p, "hyper_scale", z_hat, rnd)
    sigma = torch.clamp(raw_sigma, min=m["scale_lower_bound"])
    y_sym = torch.round(y - mu)
    y_sent = y_sym if given is None else given["y_symbols"].to(y_sym)
    v = torch.abs(y_sent)
    lik_y = std_cumulative((0.5 - v) / sigma) - std_cumulative((-0.5 - v) / sigma)
    floor = m["likelihood_lower_bound"]
    bits = -(torch.log2(torch.clamp(lik_y, min=floor)).sum(dim=(1, 2, 3))
             + torch.log2(torch.clamp(z_likelihood(p, m, z_hat), min=floor)).sum(dim=(1, 2, 3)))
    x_hat = generator(p, m, y_sent + mu, rnd)[:, :, :h, :w]
    decoded = torch.clamp(torch.round(x_hat * 255.0), 0, 255).to(torch.uint8)
    out.update({"decoded": decoded.permute(0, 2, 3, 1), "y_symbols": y_sym, "z_symbols": z_sym,
                "bits": bits,
                "sigma_at_bound": (raw_sigma <= m["scale_lower_bound"]).float().mean()})
    return out

"""TCM: Learned Image Compression with Mixed Transformer-CNN Architectures
(Liu, Sun, Katto, CVPR 2023, arXiv:2303.14978; the official code is
jmliu206/LIC_TCM, `models/tcm.py`, on CompressAI's layers, its windowed
attention SCUNet's), at the widths of `TCMConfig`. Parameter names follow
the published code's, so that its state dict maps onto this one.

The served forward of `TCMCodec.apply`, on x = u8 / 255 (B, 3, H, W), H and
W multiples of `TCMConfig.stride` (128 at the published windows):

  g_a:  RBS(3, 2N), 2 CTB(hd 8), RBS(2N, 2N), 2 CTB(16), RBS(2N, 2N),
        2 CTB(32), conv3x3(2N, M, stride 2)                       = y, H / 16
  g_s:  RBU(M, 2N), 2 CTB(32), RBU, 2 CTB(16), RBU, 2 CTB(8),
        subpel(2N, 3, 2)                                          = x_hat
  h_a:  RBS(M, 2N), 2 CTB(hd 32, w 4), conv3x3(2N, 192, 2)         = z, H / 64
  h_mean_s, h_scale_s: RBU(192, 2N), 2 CTB(32, w 4), subpel(2N, M, 2)
  z:    z_hat = round(z - m) + m, m the medians; factorized prior (3, 3, 3, 3)
  y:    5 slices of M / 5 channels; for slice i, with S_i = cat(mu_bar,
        y_hat_0 .. y_hat_{i-1}) (sigma_bar for the scale):
          m_i = SWAtten_i(S_i); mu_i = cc_i(m_i); sigma_i likewise (floor 0.11);
          s_i = round(y_i - mu_i);
          y_hat_i = s_i + mu_i + 0.5 tanh(LRP_i(cat(m_i, s_i + mu_i)))
  bits: -sum log2 of the Gaussian likelihoods of the s_i and the prior's of
        z_hat, each bounded below at 1e-9, per image.

Blocks (CompressAI, SCUNet):
  conv3x3(a, b, s): padding 1; conv(a, b, k): padding k // 2 (PyTorch's
  symmetric padding, not TF's SAME); conv1x1; subpel(a, b, r) =
  PixelShuffle(r)(conv3x3(a, b r^2)); LReLU slope 0.01; GELU exact.
  GDN(x)_i = x_i / sqrt(beta_i + sum_j gamma_ij x_j^2), IGDN multiplies by
  the root; beta and gamma are CompressAI's non-negative reparametrisation
  of the stored values v: max(v, sqrt(bound + 2^-36))^2 - 2^-36, bound
  1e-6 for beta and 0 for gamma.
  RBS(a, b) = GDN(conv3x3(b, b)(LReLU(conv3x3(a, b, 2)(x)))) + conv1x1(a, b, 2)(x)
  RBU(a, b) = IGDN(conv3x3(b, b)(LReLU(subpel(a, b, 2)(x)))) + subpel'(a, b, 2)(x)
  RB(c)(x) = x + LReLU(conv3x3(LReLU(conv3x3(x))))
  Block(d, hd, w, W | SW): x += WMSA(LN(x)); x += Linear(4d, d)(GELU(Linear(d,
  4d)(LN(x)))), LN eps 1e-5, on NHWC. WMSA: SW rolls by -w / 2 on both axes;
  w x w windows, d / hd heads, q, k, v from one Linear(d, 3d) (q the first d
  channels, head h channels [h hd, (h + 1) hd)); scores q k^T / sqrt(hd) +
  B_h[dy + w - 1, dx + w - 1] (dy, dx the query's position in its window
  less the key's), for SW -inf between tokens of different regions of the
  rolled image (in the last window row, rows above w / 2 against those
  below; in the last column likewise); softmax, times v, heads merged,
  Linear(d, d), windows undone, SW rolled back.
  CTB(N, hd, w, type) on 2N channels: (c, t) = split(conv1x1(x)); c = c +
  RB(c); t = Block(t) in NHWC; x + conv1x1(cat(c, t)).
  SWAtten(c_in): u = conv1x1(c_in, 128)(x); z = Block_SW(Block_W(u)) (hd
  16, w 8); conv1x1(128, c_in)(A(u) * sigmoid(B(z)) + u), A three
  CompressAI ResidualUnits, B three and a conv1x1.
  cc and LRP: conv(c, 224, 3), GELU, conv(224, 128, 3), GELU, conv(128, M / 5, 3).

Choices the published code leaves implicit, taken here:
  * SwinBlock's padding of a latent no larger than one window is left out:
    the published code pads such a latent and never crops it back (its
    `resize` is never set), so that path cannot run; the stride keeps
    every latent whole windows;
  * input u8 / 255, output clamp(round(255 x_hat), 0, 255) (by the serving
    pipeline), each image padded by reflection to a multiple of the stride
    and cropped back.

Precision (bfloat16 serving): the convolutions and linears in the compute
dtype (the tensor cores with float32 accumulation); LN's and GDN's
statistics, the softmax, the scores and the bias in float32 inside their
operations (the bias and the region mask stored in the compute dtype,
the attention through `F.scaled_dot_product_attention`: a float32 mask
beside bf16 q, k and v is accepted, but where the library picks cuDNN's
attention for it (an H100, g_a's shapes) that returns NaN; a bias value
moves by at most 2^-9 of itself, well inside what the bf16 q and k move
the scores); mu, sigma, the roundings, LRP's tanh and the likelihoods in
float32. GDN squares x in float32, rounds x^2 for its 1x1 product, adds
beta and takes the root in float32, rounds x times the root once.

The serving form (`prepare_serving`, once): GDN's effective beta and gamma,
every layer but the prior of z cast to the compute dtype, convolution
weights channels_last, each Block's relative-position bias gathered to
(heads, w^2, w^2) and, for SW, added to the three region masks of the
last window row, column and corner. An SW call attends every window with
the bias alone and those of the last row and column again with their
masks (`WMSA.forward`).

Layout: activations channels_last, so each CTB's NCHW -> NHWC turn is a
view.

Spans (utils/profiling.py): `tcm.analysis` (g_a), `tcm.hyper` (h_a,
z_hat, both h_s, z's likelihood), `tcm.slices` (the slice chain),
`tcm.synthesis` (g_s), `tcm.swin` (each windowed Block). Counters
(`counts()`, `reset_counts()`): windows attended, plain and shifted,
summed over the images of each call, and slice steps, one a slice a call.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.config import TCMConfig
from contextual_image_compression_tpu_torch.models.entropy import (
    FactorizedPrior,
    PhotoOutput,
    bits,
    gaussian_likelihood,
    quantize,
    uniform_,
)
from contextual_image_compression_tpu_torch.utils.profiling import annotate
from contextual_image_compression_tpu_torch.utils.tree import cast_floats

LRELU_SLOPE = 0.01
PEDESTAL = 2.0 ** -36   # CompressAI's reparam offset 2^-18, squared
BETA_MIN = 1e-6
LN_EPS = 1e-5

# Seeded weights (reset_parameters): gains on the He-uniform kernels of the
# layers whose outputs are added to a residual or feed a head, so that a
# seeded codec's activations neither grow nor vanish through the stages and
# its images and scales sit inside their clamps.
BRANCH_GAIN = 0.3        # the layers of BRANCH_OUTPUTS
BRANCH_OUTPUTS = ("conv1_2", "conv_block.conv2", "msa.linear", "mlp.2")
IMAGE_HEAD_GAIN = 0.005  # g_s's last subpel: x_hat's spread around its bias 0.5
SCALE_HEAD_GAIN = 0.1    # cc_scale's last conv: sigma's spread around its bias
SCALE_HEAD_BIAS = 2.0

_COUNTS = {"windows_plain": 0, "windows_shifted": 0, "slice_steps": 0}


def counts() -> dict:
    """Windows attended (plain and shifted, summed over the batch) and
    slice steps (one a slice a call) since the last reset."""
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def conv(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Conv2d:
    """CompressAI's conv / conv3x3 / conv1x1: padding k // 2."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class Subpel(nn.Sequential):
    """subpel_conv3x3: conv3x3(a, b r^2), then PixelShuffle(r)."""

    def __init__(self, cin: int, cout: int, r: int = 2):
        super().__init__(conv(cin, cout * r * r, 3), nn.PixelShuffle(r))


class GDN(nn.Module):
    """CompressAI's GDN / IGDN on the stored (reparametrised) beta and gamma
    (module docstring)."""

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(torch.ones(channels))
        self.gamma = nn.Parameter(torch.zeros(channels, channels))
        self._served: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def effective(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(beta, gamma) in float32 from the stored values."""
        beta = torch.clamp(self.beta.float(), min=math.sqrt(BETA_MIN + PEDESTAL)) ** 2
        gamma = torch.clamp(self.gamma.float(), min=math.sqrt(PEDESTAL)) ** 2
        return beta - PEDESTAL, gamma - PEDESTAL

    def serve(self, dtype: torch.dtype) -> None:
        """Keep the effective beta (float32) and gamma (the compute dtype, a
        channels_last 1x1 kernel) for every call."""
        beta, gamma = self.effective()
        gamma = gamma.to(dtype)[:, :, None, None].contiguous(memory_format=torch.channels_last)
        self._served = (beta, gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._served is None:
            beta, gamma = self.effective()
            gamma = gamma.to(x.dtype)[:, :, None, None]
        else:
            beta, gamma = self._served
        xf = x.float()
        norm = F.conv2d((xf * xf).to(x.dtype), gamma).float() + beta[:, None, None]
        norm = torch.sqrt(norm) if self.inverse else torch.rsqrt(norm)
        return (xf * norm).to(x.dtype)


class RBS(nn.Module):
    """CompressAI's ResidualBlockWithStride (stride 2)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, 2)
        self.conv2 = conv(cout, cout, 3)
        self.gdn = GDN(cout)
        self.skip = conv(cin, cout, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gdn(self.conv2(lrelu(self.conv1(x)))) + self.skip(x)


class RBU(nn.Module):
    """CompressAI's ResidualBlockUpsample (r = 2)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.subpel_conv = Subpel(cin, cout)
        self.conv = conv(cout, cout, 3)
        self.igdn = GDN(cout, inverse=True)
        self.upsample = Subpel(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.igdn(self.conv(lrelu(self.subpel_conv(x)))) + self.upsample(x)


class ResidualBlock(nn.Module):
    """CompressAI's ResidualBlock(c, c): x + LReLU(conv(LReLU(conv(x))))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = conv(channels, channels, 3)
        self.conv2 = conv(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + lrelu(self.conv2(lrelu(self.conv1(x))))


def relative_index(w: int) -> torch.Tensor:
    """(w^2, w^2, 2): for query p and key q of a window, (dy, dx) + w - 1."""
    cord = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij"), -1)
    cord = cord.reshape(w * w, 2)
    return cord[:, None, :] - cord[None, :, :] + w - 1


def region_masks(w: int) -> torch.Tensor:
    """(3, w^2, w^2) bool, True where an SW window of the last row, the
    last column or the corner separates query and key (module docstring)."""
    s = w // 2
    pos = torch.arange(w * w)
    low_y, low_x = (pos // w) < s, (pos % w) < s
    row = low_y[:, None] != low_y[None, :]
    col = low_x[:, None] != low_x[None, :]
    return torch.stack([row, col, row | col])


class WMSA(nn.Module):
    """SCUNet's windowed multi-head self-attention, W or SW (module
    docstring), on x (B, H, W, d)."""

    def __init__(self, dim: int, head_dim: int, window: int, shifted: bool):
        super().__init__()
        self.heads, self.head_dim = dim // head_dim, head_dim
        self.window, self.shifted = window, shifted
        self.embedding_layer = nn.Linear(dim, 3 * dim)
        self.relative_position_params = nn.Parameter(
            torch.zeros(self.heads, 2 * window - 1, 2 * window - 1))
        self.linear = nn.Linear(dim, dim)
        self._masks: Optional[torch.Tensor] = None

    def masks(self, dtype: torch.dtype) -> torch.Tensor:
        """(1 or 4, heads, w^2, w^2) additive masks: the bias; for SW also
        the bias with the last row's, column's and corner's region masks."""
        if self._masks is not None:
            return self._masks
        idx = relative_index(self.window).to(self.relative_position_params.device)
        bias = self.relative_position_params.float()[:, idx[..., 0], idx[..., 1]]
        out = bias[None]
        if self.shifted:
            region = region_masks(self.window).to(bias.device)
            neg = torch.zeros(region.shape, device=bias.device).masked_fill(region, -math.inf)
            out = torch.cat([out, bias[None] + neg[:, None]])
        return out.to(dtype)

    def serve(self, dtype: torch.dtype) -> None:
        self._masks = None
        self._masks = self.masks(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w_, d = x.shape
        w, s = self.window, self.window // 2
        nh, nw = h // w, w_ // w
        if self.shifted:
            x = torch.roll(x, (-s, -s), (1, 2))
        xw = x.reshape(b, nh, w, nw, w, d).transpose(2, 3).reshape(b * nh * nw, w * w, d)
        qkv = self.embedding_layer(xw).view(b * nh * nw, w * w, 3, self.heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (b nh nw, heads, w^2, hd)
        masks = self.masks(x.dtype)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=masks[:1])
        _COUNTS["windows_shifted" if self.shifted else "windows_plain"] += b * nh * nw
        if self.shifted:  # the last window row, column and corner again, with their regions
            def grid(t):
                return t.unflatten(0, (b, nh, nw))

            for i, sel in enumerate(((-1, slice(0, -1)), (slice(0, -1), -1), (-1, -1)), start=1):
                dst = grid(o)[(slice(None),) + sel]
                if dst.numel():
                    sub = [grid(t)[(slice(None),) + sel].reshape((-1,) + t.shape[1:])
                           for t in (q, k, v)]
                    dst.copy_(F.scaled_dot_product_attention(*sub, attn_mask=masks[i:i + 1])
                              .view(dst.shape))
        o = o.transpose(1, 2).reshape(b * nh * nw, w * w, d)
        o = self.linear(o).view(b, nh, nw, w, w, d).transpose(2, 3).reshape(b, h, w_, d)
        if self.shifted:
            o = torch.roll(o, (s, s), (1, 2))
        return o


class Block(nn.Module):
    """SCUNet's Block: LN, WMSA, residual; LN, MLP (4d, GELU), residual; on
    (B, H, W, d)."""

    def __init__(self, dim: int, head_dim: int, window: int, shifted: bool):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.msa = WMSA(dim, head_dim, window, shifted)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(), nn.Linear(4 * dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("tcm.swin"):
            x = x + self.msa(self.ln1(x))
            return x + self.mlp(self.ln2(x))


class ConvTransBlock(nn.Module):
    """CTB(N, hd, w, type) on 2N channels (module docstring)."""

    def __init__(self, n: int, head_dim: int, window: int, shifted: bool):
        super().__init__()
        self.n = n
        self.conv1_1 = conv(2 * n, 2 * n, 1)
        self.conv1_2 = conv(2 * n, 2 * n, 1)
        self.conv_block = ResidualBlock(n)
        self.trans_block = Block(n, head_dim, window, shifted)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, t = torch.split(self.conv1_1(x), (self.n, self.n), dim=1)
        c = self.conv_block(c) + c
        t = self.trans_block(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + self.conv1_2(torch.cat((c, t), dim=1))


def _ctbs(n: int, count: int, head_dim: int, window: int) -> List[ConvTransBlock]:
    """`count` CTBs, alternating W and SW."""
    return [ConvTransBlock(n, head_dim, window, i % 2 == 1) for i in range(count)]


class ResidualUnit(nn.Module):
    """CompressAI AttentionBlock's unit: ReLU(x + conv1x1(ReLU(conv3x3(ReLU(
    conv1x1(x)))))), halving the width inside."""

    def __init__(self, n: int):
        super().__init__()
        self.conv = nn.Sequential(conv(n, n // 2, 1), nn.ReLU(), conv(n // 2, n // 2, 3),
                                  nn.ReLU(), conv(n // 2, n, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(x) + x)


class SwinBlock(nn.Module):
    """Block W then Block SW, on NCHW (module docstring: no padding)."""

    def __init__(self, dim: int, head_dim: int, window: int):
        super().__init__()
        self.block_1 = Block(dim, head_dim, window, False)
        self.block_2 = Block(dim, head_dim, window, True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.block_2(self.block_1(x.permute(0, 2, 3, 1)))
        return t.permute(0, 3, 1, 2)


class SWAtten(nn.Module):
    """TCM's SWAtten(c_in) with inter width `dim` (module docstring)."""

    def __init__(self, cin: int, dim: int, head_dim: int, window: int):
        super().__init__()
        self.in_conv = conv(cin, dim, 1)
        self.non_local_block = SwinBlock(dim, head_dim, window)
        self.conv_a = nn.Sequential(ResidualUnit(dim), ResidualUnit(dim), ResidualUnit(dim))
        self.conv_b = nn.Sequential(ResidualUnit(dim), ResidualUnit(dim), ResidualUnit(dim),
                                    conv(dim, dim, 1))
        self.out_conv = conv(dim, cin, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = self.in_conv(x)
        z = self.non_local_block(u)
        return self.out_conv(self.conv_a(u) * torch.sigmoid(self.conv_b(z)) + u)


def _cc(cin: int, widths: Tuple[int, ...], cout: int) -> nn.Sequential:
    """cc / LRP: conv(cin, 224, 3), GELU, conv(224, 128, 3), GELU, conv(128, cout, 3)."""
    dims = (cin,) + tuple(widths) + (cout,)
    layers: List[nn.Module] = []
    for a, b in zip(dims, dims[1:]):
        layers += [conv(a, b, 3), nn.GELU()]
    return nn.Sequential(*layers[:-1])


class TCMCodec(nn.Module):
    """g_a, g_s, the hyperprior, the slice chain and the prior of z (module
    docstring)."""

    def __init__(self, cfg: TCMConfig):
        super().__init__()
        self.cfg = cfg
        n, m, w, hw = cfg.n, cfg.m, cfg.window, cfg.hyper_window
        blocks, hd = cfg.stage_blocks, cfg.head_dims
        self.g_a = nn.Sequential(
            RBS(cfg.channels, 2 * n), *_ctbs(n, blocks[0], hd[0], w),
            RBS(2 * n, 2 * n), *_ctbs(n, blocks[1], hd[1], w),
            RBS(2 * n, 2 * n), *_ctbs(n, blocks[2], hd[2], w),
            conv(2 * n, m, 3, 2))
        self.g_s = nn.Sequential(
            RBU(m, 2 * n), *_ctbs(n, blocks[3], hd[3], w),
            RBU(2 * n, 2 * n), *_ctbs(n, blocks[4], hd[4], w),
            RBU(2 * n, 2 * n), *_ctbs(n, blocks[5], hd[5], w),
            Subpel(2 * n, cfg.channels))
        self.h_a = nn.Sequential(RBS(m, 2 * n), *_ctbs(n, blocks[0], cfg.hyper_head_dim, hw),
                                 conv(2 * n, cfg.z_channels, 3, 2))
        for name in ("h_mean_s", "h_scale_s"):
            setattr(self, name, nn.Sequential(
                RBU(cfg.z_channels, 2 * n), *_ctbs(n, blocks[3], cfg.hyper_head_dim, hw),
                Subpel(2 * n, m)))
        k = cfg.num_slices
        sl = m // k
        support = [m + sl * min(i, cfg.max_support_slices) for i in range(k)]
        for name in ("atten_mean", "atten_scale"):
            setattr(self, name, nn.ModuleList(
                nn.Sequential(SWAtten(c, cfg.swatten_dim, cfg.swatten_head_dim, w))
                for c in support))
        self.cc_mean_transforms = nn.ModuleList(_cc(c, cfg.cc_widths, sl) for c in support)
        self.cc_scale_transforms = nn.ModuleList(_cc(c, cfg.cc_widths, sl) for c in support)
        self.lrp_transforms = nn.ModuleList(
            _cc(m + sl * min(i + 1, cfg.max_support_slices + 1), cfg.cc_widths, sl)
            for i in range(k))
        self.entropy_bottleneck = FactorizedPrior(cfg.z_channels, cfg.factorized_filters)

    def reset_parameters(self, seed: int = 0) -> None:
        """Seed every weight from one seeded generator on the parameters'
        device: He-uniform kernels (fan in; LeCun for the linears but the
        MLP's first), the residual branches' last layers scaled by
        BRANCH_GAIN, biases 0; LN's scale 1 and shift 0; GDN at CompressAI's
        init (beta 1, gamma 0.1 I); the relative-position biases uniform in
        +-1 (so that they move the scores); the image head scaled by
        IMAGE_HEAD_GAIN with bias 0.5, the scale heads by SCALE_HEAD_GAIN with
        bias SCALE_HEAD_BIAS, so that a seeded codec's images and scales sit
        inside their clamps; the prior of z as FactorizedPrior.reset_parameters."""
        gen = torch.Generator(device=next(self.parameters()).device).manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                uniform_(mod.weight, _gain(name) / math.sqrt(mod.weight[0].numel()), gen)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, GDN):
                with torch.no_grad():
                    c = mod.beta.shape[0]
                    mod.beta.copy_(torch.sqrt(torch.ones(c) + PEDESTAL))
                    mod.gamma.copy_(torch.sqrt(0.1 * torch.eye(c) + PEDESTAL))
            elif isinstance(mod, WMSA):
                uniform_(mod.relative_position_params, 1.0 / math.sqrt(3.0), gen)
        heads = [(self.g_s[-1][0], IMAGE_HEAD_GAIN, 0.5)]
        heads += [(cc[-1], SCALE_HEAD_GAIN, SCALE_HEAD_BIAS) for cc in self.cc_scale_transforms]
        for layer, gain, bias in heads:
            uniform_(layer.weight, gain / math.sqrt(layer.weight[0].numel()), gen)
            nn.init.constant_(layer.bias, bias)
        self.entropy_bottleneck.reset_parameters(gen)

    def prepare_serving(self) -> "TCMCodec":
        """The serving form (module docstring): GDN's effective beta and
        gamma, every layer but the prior of z in the compute dtype,
        convolution weights channels_last, the attention masks; then eval
        mode, no gradients."""
        dtype = self.cfg.compute_dtype()
        for mod in self.modules():
            if isinstance(mod, GDN):
                mod.serve(dtype)
        for name, part in self.named_children():
            if name != "entropy_bottleneck":
                cast_floats(part, dtype)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                mod.weight.data = mod.weight.data.contiguous(memory_format=torch.channels_last)
            elif isinstance(mod, WMSA):
                mod.serve(dtype)
        return self.eval().requires_grad_(False)

    def apply(self, x: torch.Tensor) -> PhotoOutput:
        """x (B, 3, H, W) in [0, 1], the compute dtype, H and W multiples of
        the stride, in either layout -> x_hat (B, 3, H, W), the symbols of y
        (all slices) and z, bits per image."""
        cfg = self.cfg
        x = x.contiguous(memory_format=torch.channels_last)
        with annotate("tcm.analysis"):
            y = self.g_a(x)
        dt = y.dtype
        with annotate("tcm.hyper"):
            z = self.h_a(y).float()
            z_sym, z_hat = quantize(z, self.entropy_bottleneck.offset.float()[:, None, None])
            zc = z_hat.to(dt)
            mean_bar, scale_bar = self.h_mean_s(zc), self.h_scale_s(zc)
            lik_z = self.entropy_bottleneck.likelihood(z_hat)
        with annotate("tcm.slices"):
            y_sym, y_hat, lik_y = self.slices(y, mean_bar, scale_bar)
            bits_ = bits(lik_y, lik_z, cfg.likelihood_lower_bound)
        with annotate("tcm.synthesis"):
            x_hat = self.g_s(y_hat.to(dt))
        return PhotoOutput(x_hat, y_sym, z_sym, bits_)

    def slices(self, y: torch.Tensor, mean_bar: torch.Tensor, scale_bar: torch.Tensor):
        """The channel-wise autoregressive chain: (symbols, y_hat, the
        likelihoods of the symbols), each (B, M, h, w) float32."""
        cfg = self.cfg
        dt = mean_bar.dtype
        done: List[torch.Tensor] = []
        syms, hats, liks = [], [], []
        for i, y_i in enumerate(y.float().chunk(cfg.num_slices, 1)):
            support = done[:cfg.max_support_slices] if cfg.max_support_slices >= 0 else done
            m_mu = self.atten_mean[i](torch.cat([mean_bar] + support, dim=1))
            mu = self.cc_mean_transforms[i](m_mu).float()
            m_sigma = self.atten_scale[i](torch.cat([scale_bar] + support, dim=1))
            sigma = torch.clamp(self.cc_scale_transforms[i](m_sigma).float(),
                                min=cfg.scale_lower_bound)
            s, y_hat = quantize(y_i, mu)
            liks.append(gaussian_likelihood(s, sigma))
            lrp = self.lrp_transforms[i](torch.cat([m_mu, y_hat.to(dt)], dim=1)).float()
            y_hat = y_hat + 0.5 * torch.tanh(lrp)
            syms.append(s)
            hats.append(y_hat)
            done.append(y_hat.to(dt))
            _COUNTS["slice_steps"] += 1
        return torch.cat(syms, 1), torch.cat(hats, 1), torch.cat(liks, 1)


def _gain(name: str) -> float:
    """The seeded gain of a kernel by its name (reset_parameters)."""
    return BRANCH_GAIN if name.endswith(BRANCH_OUTPUTS) else 1.0

"""HiFiC: High-Fidelity Generative Image Compression (Mentzer, Toderici,
Tschannen, Agustsson, NeurIPS 2020, arXiv:2006.09965; the official code is
tensorflow/compression, models/hific), at the widths of `HiFiCConfig`.

The served forward of `HiFiCCodec.apply`, on x = u8 / 255 (B, 3, H, W), H
and W multiples of 64:

  E:  conv 7x7/s1 -> 60, CN, ReLU; conv 3x3/s2 -> 120, 240, 480, 960, each
      CN, ReLU; conv 3x3/s1 -> C_y = 220                              = y
  h_a: conv 3x3/s1 -> N = 320, ReLU, conv 5x5/s2, ReLU, conv 5x5/s2    = z
  z:  z_hat = round(z - m) + m, m the per-channel offsets; its likelihood
      under Balle et al. 2018's factorized prior (filters (3, 3, 3))
  h_s: two syntheses, one for mu and one for sigma, each ConvT 5x5/s2,
      ReLU, ConvT 5x5/s2, ReLU, conv 3x3/s1 -> C_y; sigma = max(sigma, 0.11)
  y:  y_hat = round(y - mu) + mu; its likelihood Phi((0.5 - |s|) / sigma)
      - Phi((-0.5 - |s|) / sigma), s = round(y - mu) the symbol
  G:  CN(220), conv 3x3 -> 960, CN (the head); 9 residual blocks x + [conv
      3x3, CN, ReLU, conv 3x3, CN](x); the head added back (the long skip);
      ConvT 3x3/s2 -> 480, 240, 120, 60, each CN, ReLU; conv 7x7 -> 3 = x_hat
  bits: -sum log2 of the likelihoods of y_hat and z_hat, each bounded
      below at 1e-9, per image.

ChannelNorm (CN) normalizes each pixel over its channels:
(f - mean_c f) / sqrt(var_c f + eps) * alpha_c + beta_c, the biased
variance, in float32 whatever the input's dtype, rounded once to it.

Choices the paper leaves open, taken here:
  * SAME zero padding, TF-Compression's default: a stride-2 3x3
    convolution pads 0 before and 1 after (`layers.same_pads`);
  * the transposed convolutions are TF's SAME ones, the adjoint of the
    SAME convolution from 2H to H (`layers.KConvT`);
  * the long skip from the head around the residual blocks, as in the
    public PyTorch reproduction;
  * CN's eps = 1e-3;
  * input u8 / 255, output clamp(round(255 x_hat), 0, 255) (by the serving
    pipeline), each image padded by reflection to a multiple of 64 and
    cropped back.

Precision: the convolutions in the compute dtype (bfloat16 serving: the
tensor cores with float32 accumulation, each result rounded to bfloat16,
then the bias added and rounded); CN's statistics, mu, sigma, the roundings
and the likelihoods in float32. `prepare_serving` casts every layer but the
prior of z, whose parameters and offsets stay float32.

Layout: the activations are channels_last (NHWC strides on the logical
(B, C, H, W) shapes). `apply` takes x in either layout and turns an NCHW x
to channels_last once; `prepare_serving` turns every convolution weight to
channels_last once. The shared `KConv` / `KConvT` follow the layout they are
given (cuDNN's NHWC kernels read and write the tensors as they are, with no
layout conversion inside a call; the bias add, the padding and KConvT's crop
keep it), and ChannelNorm takes K9's NHWC route. A pixel's row between two
convolutions with a ChannelNorm between them is padded to a multiple of
ROW_CHANNELS channels in the serving form (E's and G's 60-channel rows to
64): zero filters and biases on the producing convolution, zero taps on the
consuming one, and ChannelNorm leaves the padding out and writes it 0. The
values are those of the unpadded network; cuDNN's NHWC kernels take such a
row as it is, where they put a 60-channel one through a padding pass of
their own at each of those four convolutions.

Spans (utils/profiling.py): `hific.analysis` (E), `hific.hyper` (h_a,
z_hat, both syntheses, y_hat, the likelihoods), `hific.synthesis` (G),
`hific.resblocks` (the blocks and the long skip, inside G) and `hific.norm`
(each CN).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from contextual_image_compression_tpu_torch.config import HiFiCConfig
from contextual_image_compression_tpu_torch.models.entropy import (
    FactorizedPrior,
    PhotoOutput,
    bits,
    gaussian_likelihood,
    quantize,
    uniform_,
)
from contextual_image_compression_tpu_torch.models.layers import KConv, KConvT
from contextual_image_compression_tpu_torch.ops.channel_norm import channel_norm
from contextual_image_compression_tpu_torch.utils.profiling import annotate
from contextual_image_compression_tpu_torch.utils.tree import cast_floats

IMAGE_HEAD_GAIN = 0.15  # image head: x_hat's spread around its bias of 0.5
ROW_CHANNELS = 8        # the served rows' channel multiple: 16 bytes of bf16
SCALE_HEAD_GAIN = 0.15  # sigma head: sigma's spread around its bias of 1


def _seed_conv(layer: nn.Module, gen: torch.Generator, gain: float = 1.0,
               bias: float = 0.0) -> None:
    """He-uniform kernel times `gain` (fan in Cin k^2, a quarter of it for
    a stride-2 transposed convolution), the bias a constant."""
    w = layer.weight
    if isinstance(layer, KConvT):
        fan_in = w.shape[0] * w.shape[2] * w.shape[3] / 4.0
    else:
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    uniform_(w, gain * math.sqrt(2.0 / fan_in), gen)
    nn.init.constant_(layer.bias, bias)


class ChannelNorm(nn.Module):
    """Per-pixel normalization over channels (module docstring); relu=True
    applies the ReLU that follows before the one rounding. One launch of
    K9 on the card, its plain twin on the CPU (ops/channel_norm.py)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))   # alpha
        self.bias = nn.Parameter(torch.zeros(channels))    # beta

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        with annotate("hific.norm"):
            return channel_norm(x, self.weight, self.bias, self.eps, relu)


class HiFiCEncoder(nn.Module):
    """E: x (B, 3, H, W) -> y (B, C_y, H / 16, W / 16)."""

    def __init__(self, cfg: HiFiCConfig):
        super().__init__()
        f = cfg.encoder_filters
        self.conv0 = KConv(cfg.channels, f[0], 7)
        self.norm0 = ChannelNorm(f[0], cfg.norm_eps)
        self.down = nn.ModuleList(KConv(a, b, 3, 2) for a, b in zip(f, f[1:]))
        self.down_norm = nn.ModuleList(ChannelNorm(b, cfg.norm_eps) for b in f[1:])
        self.out = KConv(f[-1], cfg.latent_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm0(self.conv0(x), relu=True)
        for conv, norm in zip(self.down, self.down_norm):
            x = norm(conv(x), relu=True)
        return self.out(x)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.conv1 = KConv(channels, channels, 3)
        self.norm1 = ChannelNorm(channels, eps)
        self.conv2 = KConv(channels, channels, 3)
        self.norm2 = ChannelNorm(channels, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.norm2(self.conv2(self.norm1(self.conv1(x), relu=True)))


class HiFiCGenerator(nn.Module):
    """G: y_hat (B, C_y, h, w) -> x_hat (B, 3, 16 h, 16 w)."""

    def __init__(self, cfg: HiFiCConfig):
        super().__init__()
        f = cfg.encoder_filters[::-1]
        eps = cfg.norm_eps
        self.norm_in = ChannelNorm(cfg.latent_channels, eps)
        self.head = KConv(cfg.latent_channels, f[0], 3)
        self.norm_head = ChannelNorm(f[0], eps)
        self.blocks = nn.ModuleList(ResidualBlock(f[0], eps) for _ in range(cfg.residual_blocks))
        self.up = nn.ModuleList(KConvT(a, b, 3) for a, b in zip(f, f[1:]))
        self.up_norm = nn.ModuleList(ChannelNorm(b, eps) for b in f[1:])
        self.out = KConv(f[-1], cfg.channels, 7)

    def forward(self, y_hat: torch.Tensor) -> torch.Tensor:
        head = self.norm_head(self.head(self.norm_in(y_hat)))
        with annotate("hific.resblocks"):
            x = head
            for block in self.blocks:
                x = block(x)
            x = x + head
        for conv, norm in zip(self.up, self.up_norm):
            x = norm(conv(x), relu=True)
        return self.out(x)


class HyperAnalysis(nn.Module):
    """h_a: y -> z, stride 4."""

    def __init__(self, cfg: HiFiCConfig):
        super().__init__()
        n = cfg.hyper_channels
        self.conv1 = KConv(cfg.latent_channels, n, 3)
        self.conv2 = KConv(n, n, 5, 2)
        self.conv3 = KConv(n, n, 5, 2)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.conv3(torch.relu(self.conv2(torch.relu(self.conv1(y)))))


class HyperSynthesis(nn.Module):
    """h_s (one for mu, one for sigma): z_hat -> (B, C_y, 4 h, 4 w)."""

    def __init__(self, cfg: HiFiCConfig):
        super().__init__()
        n = cfg.hyper_channels
        self.up1 = KConvT(n, n, 5)
        self.up2 = KConvT(n, n, 5)
        self.out = KConv(n, cfg.latent_channels, 3)

    def forward(self, z_hat: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.up2(torch.relu(self.up1(z_hat)))))


def _widen(t: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """t with zeros appended along dim up to width."""
    shape = list(t.shape)
    shape[dim] = width - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim)


def _pad_row(producer: nn.Module, consumer: nn.Module) -> None:
    """Pad the channels between two convolutions to a multiple of
    ROW_CHANNELS: zero filters and biases on the producer (a KConvT's weight
    is (Cin, Cout, k, k)), zero taps on the consumer."""
    c = producer.bias.shape[0]
    width = -(-c // ROW_CHANNELS) * ROW_CHANNELS
    if width == c:
        return
    producer.weight.data = _widen(producer.weight.data, int(isinstance(producer, KConvT)), width)
    producer.bias.data = _widen(producer.bias.data, 0, width)
    consumer.weight.data = _widen(consumer.weight.data, int(isinstance(consumer, KConv)), width)


class HiFiCCodec(nn.Module):
    """E, G, the hyperprior and the prior of z (module docstring)."""

    def __init__(self, cfg: HiFiCConfig):
        super().__init__()
        self.cfg = cfg
        self.analysis = HiFiCEncoder(cfg)
        self.synthesis = HiFiCGenerator(cfg)
        self.hyper_analysis = HyperAnalysis(cfg)
        self.hyper_mean = HyperSynthesis(cfg)
        self.hyper_scale = HyperSynthesis(cfg)
        self.z_prior = FactorizedPrior(cfg.hyper_channels, cfg.factorized_filters)

    def reset_parameters(self, seed: int = 0) -> None:
        """Seed every weight from one seeded generator on the parameters'
        device: He-uniform kernels and zero biases; CN's alpha 1 and beta 0;
        the image head scaled by IMAGE_HEAD_GAIN with bias 0.5 and the sigma
        head by SCALE_HEAD_GAIN with bias 1, so that a seeded codec's images
        and scales sit inside their clamps; the prior of z as
        FactorizedPrior.reset_parameters."""
        gen = torch.Generator(device=next(self.parameters()).device).manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (KConv, KConvT)):
                _seed_conv(mod, gen)
            elif isinstance(mod, ChannelNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
        _seed_conv(self.synthesis.out, gen, IMAGE_HEAD_GAIN, 0.5)
        _seed_conv(self.hyper_scale.out, gen, SCALE_HEAD_GAIN, 1.0)
        self.z_prior.reset_parameters(gen)

    def prepare_serving(self) -> "HiFiCCodec":
        """The serving form: every layer in the config's compute dtype but the
        prior of z; the rows between E's and G's convolutions padded to a
        multiple of ROW_CHANNELS channels (module docstring); each
        convolution weight channels_last; then eval mode, no gradients."""
        dtype = self.cfg.compute_dtype()
        e, g = self.analysis, self.synthesis
        e_convs, g_convs = [e.conv0, *e.down, e.out], [*g.up, g.out]
        for convs in (e_convs, g_convs):  # each but the last is followed by a ChannelNorm
            for producer, consumer in zip(convs, convs[1:]):
                _pad_row(producer, consumer)
        for part in (self.analysis, self.synthesis, self.hyper_analysis, self.hyper_mean,
                     self.hyper_scale):
            cast_floats(part, dtype)
            for mod in part.modules():
                if isinstance(mod, (KConv, KConvT)):
                    mod.weight.data = mod.weight.data.contiguous(memory_format=torch.channels_last)
        return self.eval().requires_grad_(False)

    def apply(self, x: torch.Tensor) -> PhotoOutput:
        """x (B, 3, H, W) in [0, 1], the compute dtype, H and W multiples of
        64, in either layout -> x_hat (channels_last), the symbols of y and z,
        bits per image."""
        cfg = self.cfg
        x = x.contiguous(memory_format=torch.channels_last)
        with annotate("hific.analysis"):
            y = self.analysis(x)
        with annotate("hific.hyper"):
            z = self.hyper_analysis(y).float()
            z_sym, z_hat = quantize(z, self.z_prior.offset.float()[:, None, None])
            zc = z_hat.to(y.dtype)
            mu = self.hyper_mean(zc).float()
            sigma = torch.clamp(self.hyper_scale(zc).float(), min=cfg.scale_lower_bound)
            y_sym, y_hat = quantize(y.float(), mu)
            bits_ = bits(gaussian_likelihood(y_sym, sigma), self.z_prior.likelihood(z_hat),
                         cfg.likelihood_lower_bound)
        with annotate("hific.synthesis"):
            x_hat = self.synthesis(y_hat.to(y.dtype))
        return PhotoOutput(x_hat, y_sym, z_sym, bits_)

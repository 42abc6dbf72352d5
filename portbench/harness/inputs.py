"""Inputs and weights made from the run's seed, on the device, in a few
large calls. Both the program and the reference are handed these.

Images: structured uint8 images (three soft blobs, an edge, a little
texture), the same recipe as the port's CPU tests draw, vectorized over the
batch. Weights: every leaf of a shape table from one uniform draw and one
normal draw of a seeded `torch.Generator` on the device:

  * kernels (conv, transposed conv, dense): Glorot-uniform;
  * biases: uniform in +-0.05;
  * BatchNorm: scale in [0.75, 1.25], bias in +-0.1, running mean in
    +-0.2, running variance in [0.75, 1.25] (statistics a trained codec
    has, not the identity of a fresh one);
  * the SAGAN gamma: 0.5 (its init of 0 would hide attention);
  * VGG19 kernels: lecun-normal scale, clipped at two standard deviations;
    zero biases.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

STREAMS = {"codec": 0, "disc": 1, "vgg": 2, "images": 3}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator for one named stream of the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 8 + STREAMS[stream]) % (1 << 63))
    return gen


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    module = name.rsplit(".", 1)[0].rsplit(".", 1)[-1]
    if leaf in ("running_mean", "running_var"):
        return leaf
    if leaf == "gamma":
        return "gamma"
    if module.startswith("bn"):
        return "bn_" + leaf
    if leaf == "bias":
        return "bias"
    return "kernel"


def _fans(name: str, shape) -> Tuple[int, int]:
    if len(shape) == 2:  # dense (out, in)
        return shape[1], shape[0]
    k = shape[2] * shape[3]
    if ".deconv" in name:  # transposed conv (in, out, k, k)
        return shape[0] * k, shape[1] * k
    return shape[1] * k, shape[0] * k


@torch.no_grad()
def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, stream: str, device,
                 vgg: bool = False) -> Dict[str, torch.Tensor]:
    """float32 tensors for every name of `shapes` (see the module docstring)."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = generator(seed, stream, device)
    if vgg:
        draw = torch.randn(total, generator=gen, device=device)
    else:
        draw = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = draw[off:off + n].view(shape)
        off += n
        kind = _kind(name, shape)
        if vgg:
            if kind == "kernel":
                std = math.sqrt(1.0 / (shape[1] * 9)) / 0.87962566103423978
                out[name] = torch.clamp(u, -2.0, 2.0) * std
            else:
                out[name] = torch.zeros(shape, device=device)
            continue
        if kind == "kernel":
            fan_in, fan_out = _fans(name, shape)
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            out[name] = u * (2 * lim) - lim
        elif kind == "bias":
            out[name] = u * 0.1 - 0.05
        elif kind in ("bn_weight", "running_var"):
            out[name] = u * 0.5 + 0.75
        elif kind == "bn_bias":
            out[name] = u * 0.2 - 0.1
        elif kind == "running_mean":
            out[name] = u * 0.4 - 0.2
        elif kind == "gamma":
            out[name] = torch.full(shape, 0.5, device=device)
        else:
            raise ValueError(f"no init for {name}")
    return out


@torch.no_grad()
def structured_images(seed: int, n: int, size: int, device, chunk: int = 256) -> torch.Tensor:
    """(n, size, size, 3) uint8 images from the seed's image stream."""
    gen = generator(seed, "images", device)
    ax = torch.arange(size, device=device, dtype=torch.float32) / size
    yy, xx = ax[:, None], ax[None, :]
    outs = []
    for start in range(0, n, chunk):
        b = min(chunk, n - start)
        blobs = torch.rand((b, 3, 3), generator=gen, device=device)
        colours = torch.rand((b, 3, 3), generator=gen, device=device)
        angle = torch.rand((b,), generator=gen, device=device) * 6.0
        edge_colour = torch.rand((b, 3), generator=gen, device=device)
        noise = torch.rand((b, size, size, 3), generator=gen, device=device)
        img = 0.05 * noise
        for k in range(3):
            cy, cx = blobs[:, k, 0, None, None], blobs[:, k, 1, None, None]
            r = blobs[:, k, 2, None, None] * 0.2 + 0.05
            blob = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            img = img + blob[..., None] * colours[:, k, None, None, :]
        edge = (xx * torch.cos(angle)[:, None, None] + yy * torch.sin(angle)[:, None, None]) > 0.3
        img = img + edge[..., None] * edge_colour[:, None, None, :] * 0.4
        img = img / img.amax(dim=(1, 2, 3), keepdim=True)
        outs.append((img * 255).to(torch.uint8))
    return torch.cat(outs)

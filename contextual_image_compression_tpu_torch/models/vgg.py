"""VGG19 feature tower for the perceptual loss, in NCHW.

Counterpart of `contextual_image_compression_tpu/models/vgg.py`: 3x3 convs
(SAME, padding 1) with ReLU in five blocks of (64, 2), (128, 2), (256, 4),
(512, 4), (512, 4), a 2x2/2 max-pool after each block, and the five taps
block1_conv2, block2_conv2, block3_conv4, block4_conv4, block5_conv4. The
pool after block 5 feeds nothing and is not run. Inputs go through
`preprocess_caffe` ([-1, 1] RGB -> [0, 255] BGR minus the ImageNet means).

Weights come from an .npz of `block{i}_conv{j}_kernel` (HWIO) and `_bias`
arrays (scripts/convert_vgg_weights.py writes one), checked against the
activation fingerprint the file carries, or are random: 'random[:seed]'
draws flax's initializers (lecun_normal kernels, that is a normal truncated
at 2 standard deviations with std sqrt(1 / fan_in) / 0.8796, and zero biases)
from a seeded torch.Generator. JAX's PRNG cannot be reproduced, so the port's
random tower has the same distribution as the JAX package's, not the same
numbers; the tests carry the JAX tower's weights across (convert.py).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

VGG19_LAYOUT = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
TAPS = ((1, 2), (2, 2), (3, 4), (4, 4), (5, 4))
BGR_MEAN = (103.939, 116.779, 123.68)

FINGERPRINT_KEY = "fingerprint"
FINGERPRINT_SEED = 20260819
FINGERPRINT_SHAPE = (2, 64, 64, 3)  # NHWC, as the converter draws it


def conv_names():
    return [f"block{bi}_conv{ci}" for bi, (_, n) in enumerate(VGG19_LAYOUT, start=1)
            for ci in range(1, n + 1)]


def preprocess_caffe(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) RGB in [-1, 1] -> caffe-style VGG input: [0, 255], BGR,
    ImageNet BGR means subtracted (the channel axis is dim 1). As in the JAX
    function, the scaling runs in img's dtype (a bfloat16 image rounds after
    the add and after the multiply) and the float32 means promote the
    result to float32."""
    x = (img + 1.0) * 127.5
    x = x.flip(1)
    mean = torch.tensor(BGR_MEAN, dtype=torch.float32, device=x.device)
    return x - mean[:, None, None]


class VGG19Features(nn.Module):
    """The VGG19 conv tower returning the five tap activations."""

    def __init__(self):
        super().__init__()
        cin = 3
        for bi, (width, n_convs) in enumerate(VGG19_LAYOUT, start=1):
            for ci in range(1, n_convs + 1):
                setattr(self, f"block{bi}_conv{ci}", nn.Conv2d(cin, width, 3, padding=1))
                cin = width

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's default conv init: lecun_normal kernels, zero biases."""
        for name in conv_names():
            conv = getattr(self, name)
            fan_in = conv.weight.shape[1] * 9
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for bi, (_, n_convs) in enumerate(VGG19_LAYOUT, start=1):
            for ci in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"block{bi}_conv{ci}")(x))
                if (bi, ci) in TAPS:
                    taps.append(x)
            if bi < len(VGG19_LAYOUT):
                x = F.max_pool2d(x, 2, 2)
        return taps


def load_vgg19_params(weights_path: str) -> Optional[dict]:
    """State dict of VGG19Features from an .npz of HWIO kernels and biases,
    or None if the file or any key is missing."""
    if not weights_path or not os.path.exists(weights_path):
        return None
    with np.load(weights_path) as data:
        sd = {}
        for name in conv_names():
            kkey, bkey = f"{name}_kernel", f"{name}_bias"
            if kkey not in data or bkey not in data:
                return None
            kernel = np.asarray(data[kkey], np.float32)
            sd[f"{name}.weight"] = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
            sd[f"{name}.bias"] = torch.from_numpy(np.asarray(data[bkey], np.float32).copy())
    return sd


def fingerprint_batch() -> torch.Tensor:
    """The converter's fixed (2, 3, 64, 64) batch in [-1, 1]."""
    rs = np.random.RandomState(FINGERPRINT_SEED)
    x = rs.rand(*FINGERPRINT_SHAPE).astype(np.float32) * 2.0 - 1.0
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def compute_tap_fingerprint(module: VGG19Features) -> np.ndarray:
    """(5, 2) float32 per-tap [mean, biased std] on the fixed batch."""
    dev = next(module.parameters()).device
    taps = module(preprocess_caffe(fingerprint_batch().to(dev)))
    return np.array([[t.mean().item(), t.std(correction=0).item()] for t in taps], np.float32)


def verify_tap_fingerprint(module: VGG19Features, expected: np.ndarray,
                           rtol: float = 2e-2) -> None:
    """Raise ValueError if the tower's tap statistics miss `expected` by more
    than rtol (relative, with a 1e-3 floor on the denominator)."""
    got = compute_tap_fingerprint(module)
    expected = np.asarray(expected, np.float32)
    if expected.shape != got.shape:
        raise ValueError(f"VGG19 fingerprint shape {expected.shape} != {got.shape}")
    rel = np.abs(got - expected) / np.maximum(np.abs(expected), 1e-3)
    if not np.all(rel <= rtol):
        raise ValueError(
            "VGG19 weights failed their stored activation fingerprint "
            f"(max rel error {float(rel.max()):.3g} > {rtol}): the file is corrupt, "
            "mis-converted, or from a different architecture"
        )


def load_vgg19_features(weights_path: str, device="cuda") -> Optional[VGG19Features]:
    """The frozen tower on `device`, or None (perceptual loss off) when no
    weights are available. weights_path: an .npz (see the module docstring)
    or 'random' / 'random:<seed>'."""
    device = torch.device(device)
    if weights_path and weights_path.split(":", 1)[0] == "random":
        seed = int(weights_path.split(":", 1)[1]) if ":" in weights_path else 0
        with torch.device(device):
            module = VGG19Features()
        gen = torch.Generator(device=device).manual_seed(seed)
        module.reset_parameters(gen)
        return module.requires_grad_(False)
    sd = load_vgg19_params(weights_path)
    if sd is None:
        return None
    with torch.device(device):
        module = VGG19Features()
    module.load_state_dict(sd)
    module.requires_grad_(False)
    with np.load(weights_path) as data:
        if FINGERPRINT_KEY in data:
            verify_tap_fingerprint(module, data[FINGERPRINT_KEY])
    return module

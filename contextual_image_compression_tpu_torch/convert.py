"""Weight carrier: JAX variables -> the port's state dicts.

Input: JAX variables as nested dicts of numpy arrays: the codec's
`{component: {"params": ..., "batch_stats": ...}}` (what
`AdaptiveCodec.init` returns), the discriminator's and the VGG19 tower's
`{"params": ..., ["batch_stats": ...]}`. Output: flat state dicts for the
port's `AdaptiveCodec`, `Discriminator` and `VGG19Features`. Optimizer
states are not carried: both packages start them fresh. Rules:

  * conv kernels HWIO -> OIHW;
  * ConvTranspose kernels (kh, kw, Cin, Cout) are flipped on both spatial
    axes and laid out (Cin, Cout, kh, kw), which makes flax's SAME
    transposed conv equal F.conv_transpose2d(stride=2, padding=1);
  * Dense (in, out) -> (out, in);
  * BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var (eps 1e-3 lives in the module);
  * the encoder and the discriminator flatten and the generator reshapes in
    NHWC order in JAX: the encoders' latent_dense rows, the discriminator's
    dense rows and the generators' fc columns and bias are permuted to NCHW
    order here, so the port needs no run-time permute.
    The w8 scales are per output column, so quantizing after the
    permutation gives the same numbers.

The mask engine (K1, K4) and the DCT baseline codec (K5) have no
parameters, so nothing here covers them. Reading flax msgpack checkpoint
files comes with a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from contextual_image_compression_tpu_torch.config import ModelConfig
from contextual_image_compression_tpu_torch.models.discriminator import disc_geometry


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _component_state(tree: Dict) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def join(prefix, key):
        return f"{prefix}.{key}" if prefix else key

    def walk_params(d, prefix):
        for key, val in d.items():
            if key == "Conv_0":
                sd[join(prefix, "weight")] = _t(val["kernel"]).permute(3, 2, 0, 1).contiguous()
                sd[join(prefix, "bias")] = _t(val["bias"])
            elif key == "ConvTranspose_0":
                k = _t(val["kernel"]).flip(0, 1)
                sd[join(prefix, "weight")] = k.permute(2, 3, 0, 1).contiguous()
                sd[join(prefix, "bias")] = _t(val["bias"])
            elif key == "Dense_0":
                sd[join(prefix, "weight")] = _t(val["kernel"]).T.contiguous()
                sd[join(prefix, "bias")] = _t(val["bias"])
            elif key == "BatchNorm_0":
                sd[join(prefix, "weight")] = _t(val["scale"])
                sd[join(prefix, "bias")] = _t(val["bias"])
            elif key == "gamma":
                sd[join(prefix, "gamma")] = _t(val).reshape(1)
            elif isinstance(val, dict):
                walk_params(val, join(prefix, key))
            else:
                raise KeyError(f"unexpected parameter {join(prefix, key)}")

    def walk_stats(d, prefix):
        for key, val in d.items():
            if key == "BatchNorm_0":
                sd[join(prefix, "running_mean")] = _t(val["mean"])
                sd[join(prefix, "running_var")] = _t(val["var"])
            elif isinstance(val, dict):
                walk_stats(val, join(prefix, key))

    walk_params(tree["params"], "")
    walk_stats(tree.get("batch_stats", {}), "")
    return sd


def _nhwc_rows_to_nchw(w: torch.Tensor, h: int, wd: int, c: int) -> torch.Tensor:
    """Dense weight (out, h*w*c in NHWC order) -> (out, c*h*w in NCHW order)."""
    out = w.shape[0]
    return w.reshape(out, h, wd, c).permute(0, 3, 1, 2).reshape(out, c * h * wd).contiguous()


def _nhwc_cols_to_nchw(w: torch.Tensor, b: torch.Tensor, h: int, wd: int, c: int):
    """Dense weight (h*w*c out in NHWC order, in) and bias -> NCHW order."""
    cin = w.shape[1]
    w2 = w.reshape(h, wd, c, cin).permute(2, 0, 1, 3).reshape(c * h * wd, cin).contiguous()
    b2 = b.reshape(h, wd, c).permute(2, 0, 1).reshape(-1).contiguous()
    return w2, b2


def component_state(name: str, tree: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """One JAX component's variables -> the state dict of the port's module
    of that component (keys without the component prefix)."""
    csd = _component_state(tree)
    h, w = cfg.img_size
    if name.endswith("_encoder"):
        csd["latent_dense.weight"] = _nhwc_rows_to_nchw(
            csd["latent_dense.weight"], h // 16, w // 16, cfg.encoder_channels[3]
        )
    elif name.endswith("_generator"):
        n = cfg.generator_base_hw
        csd["fc.weight"], csd["fc.bias"] = _nhwc_cols_to_nchw(
            csd["fc.weight"], csd["fc.bias"], n, n, cfg.generator_base_ch
        )
    return csd


def convert_codec_variables(variables: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX codec variables (numpy leaves) -> state dict of the port's AdaptiveCodec."""
    return {
        f"{comp}.{key}": val
        for comp, tree in variables.items()
        for key, val in component_state(comp, tree, cfg).items()
    }


def convert_discriminator_variables(variables: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX discriminator variables (numpy leaves) -> state dict of the port's
    Discriminator, with the NHWC-order `dense` rows permuted to NCHW."""
    sd = _component_state(variables)
    filters, hw = disc_geometry(cfg.img_size, cfg.disc_base_filters, cfg.disc_max_filters,
                                cfg.disc_max_stages)
    sd["dense.weight"] = _nhwc_rows_to_nchw(sd["dense.weight"], hw, hw, filters[-1])
    return sd


def convert_vgg_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX VGG19Features variables {"params": {block{i}_conv{j}: {kernel
    (HWIO), bias}}} -> state dict of the port's VGG19Features (OIHW)."""
    return {
        f"{name}.{key}": (_t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
                          if key == "weight" else _t(leaf["bias"]))
        for name, leaf in variables["params"].items()
        for key in ("weight", "bias")
    }

"""Skip-connection transposed-conv generator, in NCHW.

Counterpart of `contextual_image_compression_tpu/models/generator.py`:
    Dense(hw*hw*C0) -> reshape -> BN -> LeakyReLU   (W8A8 at inference under dense_int8)
    ConvT k4 s2 -> BN -> LReLU -> concat skip3 ; likewise skip2, skip1
    ConvT k4 s2 -> BN -> LReLU -> Conv k4 s1 -> tanh       (native tail)
or, at inference with packed_tail, the folded tail of models/packed_tail.py
(train-mode calls take the native tail, as the JAX generator does: batch
statistics cannot be folded). The int8 form folds its operands once and
keeps them (`_int8_operands`; `prepare_tail()` folds them ahead of the first
call, in the serving set-up), refolding when x's dtype or device or a source
weight or statistic has changed since (a state dict loaded, an in-place
edit, a move); it takes K8's int8 route for a square bf16 CUDA input within
the kernel's widths (models/packed_tail.py::int8_tail_forward).
polyphase=True lowers the deconvolutions as the JAX generator's
`generator_polyphase` does (layers.KConvT).
The fc output is reshaped in NCHW order; `convert.py` permutes the JAX
(NHWC-order) fc columns and bias to match.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from contextual_image_compression_tpu_torch.models.layers import (
    KBatchNorm,
    KConv,
    KConvT,
    KDense,
    leaky_relu,
    used,
)
from contextual_image_compression_tpu_torch.models.packed_tail import (
    fold_int8_tail,
    int8_tail_forward,
    packed_tail_forward,
)


class Generator(nn.Module):
    def __init__(
        self,
        latent_dim: int,
        out_channels: int = 3,
        channels: Tuple[int, ...] = (256, 128, 64, 32),
        skip_channels: Tuple[int, ...] = (64, 128, 256),
        base_hw: int = 16,
        base_ch: int = 512,
        leaky_slope: float = 0.2,
        packed_tail: bool = False,
        packed_tail_int8: bool = False,
        dense_w8: bool = False,
        dense_int8: bool = False,
        polyphase: bool = False,
    ):
        super().__init__()
        if len(channels) != 4:
            raise ValueError("the generator has four deconv stages")
        self.base_hw, self.base_ch = base_hw, base_ch
        self.leaky_slope = leaky_slope
        self.packed_tail, self.packed_tail_int8 = packed_tail, packed_tail_int8
        # column-parallel on a mesh that splits it
        self.fc = KDense(latent_dim, base_hw * base_hw * base_ch, w8=dense_w8,
                         int8=dense_int8, tensor_parallel=True)
        self.bn0 = KBatchNorm(base_ch)
        # skips concat after deconv1..3: skip3, skip2, skip1
        concat = (skip_channels[2], skip_channels[1], skip_channels[0], 0)
        cin = base_ch
        for i, (ch, extra) in enumerate(zip(channels, concat)):
            setattr(self, f"deconv{i + 1}", KConvT(cin, ch, polyphase=polyphase))
            setattr(self, f"bn{i + 1}", KBatchNorm(ch))
            cin = ch + extra
        self.out_conv = KConv(channels[3], out_channels, 4, 1)
        self._int8_tail = None  # (key, Int8Tail): the kept fold (_int8_operands)

    def reset_parameters(self, gen: torch.Generator):
        self.fc.reset_parameters(gen)
        for i in range(1, 5):
            getattr(self, f"deconv{i}").reset_parameters(gen)
        self.out_conv.reset_parameters(gen)

    def _tail_sources(self):
        bn = self.bn4
        return (self.deconv4.weight, self.deconv4.bias, bn.weight, bn.bias, bn.running_mean,
                bn.running_var, self.out_conv.weight, self.out_conv.bias)

    @staticmethod
    def _key(sources):
        # new storage (a load with assign=True, a cast, a move) changes the
        # address; an in-place write (load_state_dict's copy_) the version.
        # Tensors made under torch.inference_mode keep no version.
        return tuple((t.data_ptr(), None if t.is_inference() else t._version) for t in sources)

    def _fold(self, dt: torch.dtype, pack: bool):
        """The int8 tail's operands from the current weights (gathered where
        a mesh splits them), in dt; pack: also K8's tap tiles (bf16)."""
        bn = self.bn4
        return fold_int8_tail(
            used(self.deconv4, "weight").to(dt), used(self.deconv4, "bias").to(dt),
            used(bn, "weight"), used(bn, "bias"), bn.running_mean, bn.running_var,
            used(self.out_conv, "weight"), used(self.out_conv, "bias").to(dt), dt,
            bn_eps=bn.eps, leaky_slope=self.leaky_slope, pack=pack)

    def _kept_fold(self, dt: torch.dtype, device: torch.device):
        key = (dt, device, self._key(self._tail_sources()))
        if self._int8_tail is None or self._int8_tail[0] != key:
            with torch.no_grad():
                self._int8_tail = (key, self._fold(dt, pack=True))
        return self._int8_tail[1]

    def prepare_tail(self) -> None:
        """Fold the int8 tail's operands now, in the deconv weight's dtype, so
        that the first call finds them kept. A generator without the packed
        int8 tail has nothing to prepare."""
        if self.packed_tail and self.packed_tail_int8:
            w = self.deconv4.weight
            self._kept_fold(w.dtype, w.device)

    def _int8_operands(self, x: torch.Tensor):
        """The int8 tail's operands for x, in x's dtype: the kept fold, folded
        again first if x's dtype or device or a source changed since; a fresh
        fold, unpacked and not kept, when autograd wants the tail's
        gradients."""
        if torch.is_grad_enabled() and any(t.requires_grad for t in self._tail_sources()):
            return self._fold(x.dtype, pack=False)
        return self._kept_fold(x.dtype, x.device)

    def forward(self, latent: torch.Tensor, skips, train: bool = False) -> torch.Tensor:
        """latent (B, D), skips (skip1, skip2, skip3) NCHW -> (B, C, H, W) in
        [-1, 1]. train: BatchNorm on batch statistics (see KBatchNorm)."""
        skip1, skip2, skip3 = skips
        s = self.leaky_slope
        x = self.fc(latent, train)
        x = x.reshape(latent.shape[0], self.base_ch, self.base_hw, self.base_hw)
        x = leaky_relu(self.bn0(x, train), s)
        for i, skip in enumerate((skip3, skip2, skip1)):
            x = getattr(self, f"bn{i + 1}")(getattr(self, f"deconv{i + 1}")(x), train)
            x = torch.cat([leaky_relu(x, s), skip.to(x.dtype)], dim=1)
        if self.packed_tail and not train:
            if self.packed_tail_int8:
                return int8_tail_forward(x, self._int8_operands(x))
            bn = self.bn4
            return packed_tail_forward(
                x, used(self.deconv4, "weight").to(x.dtype),
                used(self.deconv4, "bias").to(x.dtype),
                used(bn, "weight"), used(bn, "bias"), bn.running_mean, bn.running_var,
                used(self.out_conv, "weight"), used(self.out_conv, "bias").to(x.dtype),
                bn_eps=bn.eps, leaky_slope=s,
            )
        x = leaky_relu(self.bn4(self.deconv4(x), train), s)
        return torch.tanh(self.out_conv(x))


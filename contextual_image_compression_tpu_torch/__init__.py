"""PyTorch / CUDA port of contextual_image_compression_tpu for the H100.

Two paths run here with hand-written Hopper kernels:

  * serving (serve.py): uint8 -> contextual mask -> adaptive dual-branch GAN
    codec -> uint8, through K1 the fused contextual mask (ops/fused_mask.py),
    K2 the SAGAN attention block (ops/attention.py) and K3 the adaptive
    quantizer (ops/quantize.py);
  * GAN training (train/): masks precomputed through K1 (data/pipeline.py),
    the fused step of train/gan_trainer.py and the loop of train/loop.py,
    with K2 and K3 in the codec forward and K3b, the quantizer's backward,
    in the one backward of each step.

Entry points run on the card unless the caller passes device="cpu", where
each kernel's plain PyTorch twin runs instead.
"""

from contextual_image_compression_tpu_torch.config import (
    LossConfig,
    ModelConfig,
    QuantizerConfig,
    SaliencyConfig,
    TrainConfig,
)

__all__ = ["LossConfig", "ModelConfig", "QuantizerConfig", "SaliencyConfig", "TrainConfig"]

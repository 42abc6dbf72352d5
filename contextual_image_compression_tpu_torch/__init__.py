"""PyTorch / CUDA port of contextual_image_compression_tpu for the H100.

These paths run here with hand-written Hopper kernels:

  * serving (serve.py): uint8 -> contextual mask -> adaptive dual-branch GAN
    codec -> uint8, through K1 the fused contextual mask (ops/fused_mask.py),
    K2 the SAGAN attention block (ops/attention.py) and K3 the adaptive
    quantizer (ops/quantize.py);
  * GAN training (train/): masks precomputed through K1 (data/pipeline.py),
    the fused step of train/gan_trainer.py and the loop of train/loop.py,
    with K2 and K3 in the codec forward and K3b, the quantizer's backward,
    in the one backward of each step;
  * the masks of the other saliency methods (ops/masks.py), smoothed by K4
    (ops/fused_mask.py), and the binary-threshold masks;
  * the DCT baseline codec (ops/dct.py) with K5, the 8x8 transform and
    quantizer, and range-coded streams (native/);
  * the storable codec (serve.py, ops/bitstream.py): latent streams and
    self-contained containers, decoded from bytes by the generators alone;
  * checkpoints in the JAX package's files (checkpoint/, convert.py):
    serving from a checkpoint directory, training save and resume;
  * the baseline autoencoder (models/autoencoder.py, train/ae_trainer.py),
    which runs on cuDNN and no kernel of the port;
  * the remaining kernel entry points, which no default path runs: K6 the
    attention core and K7a / K7b the fused SAGAN block (ops/attention.py),
    K8 the fused generator tail (packed_tail_forward(use_pallas=True),
    ops/generator_tail.py).

Entry points run on the card unless the caller passes device="cpu", where
each kernel's plain PyTorch twin runs instead.
"""

from contextual_image_compression_tpu_torch.config import (
    AutoencoderConfig,
    DCTCodecConfig,
    LossConfig,
    ModelConfig,
    QuantizerConfig,
    SaliencyConfig,
    TrainConfig,
)

__all__ = ["AutoencoderConfig", "DCTCodecConfig", "LossConfig", "ModelConfig", "QuantizerConfig",
           "SaliencyConfig", "TrainConfig"]

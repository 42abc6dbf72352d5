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
  * evaluation (eval/): the codec's bpp and rate-control sweeps with real
    bitstreams, metrics.txt, the rate-distortion CSV and plots
    (eval/harness.py, eval/plots.py), over images read by data/images.py
    (cv2 or PIL, or the native loader of native/) and masks through K1,
    in float32 or on its bf16 route (SaliencyConfig.mask_engine_dtype);
  * the baseline autoencoder (models/autoencoder.py, train/ae_trainer.py,
    eval/ae_eval.py), which runs on cuDNN and no kernel of the port;
  * the remaining kernel entry points, which no default path runs: K6 the
    attention core and K7a / K7b the fused SAGAN block (ops/attention.py),
    K8 the fused generator tail (packed_tail_forward(use_pallas=True),
    ops/generator_tail.py).

Entry points run on the card unless the caller passes device="cpu", where
each kernel's plain PyTorch twin runs instead. The JAX package's options run
too: `use_pallas=False` (ModelConfig.attention_use_pallas,
QuantizerConfig, SaliencyConfig.mask_use_pallas, DCTCodecConfig) computes
JAX's jnp formula with library calls and launches no kernel,
`ModelConfig(param_dtype="bfloat16")` builds and trains bf16 parameters,
`dense_w8` trains, `generator_polyphase` takes the polyphase deconvolution,
and `models.SpectralNormDense` is there as in JAX.
"""

from contextual_image_compression_tpu_torch.config import (
    AutoencoderConfig,
    DCTCodecConfig,
    EvalConfig,
    LossConfig,
    MeshConfig,
    ModelConfig,
    QuantizerConfig,
    SaliencyConfig,
    TrainConfig,
)
from contextual_image_compression_tpu_torch.version import __version__

__all__ = ["AutoencoderConfig", "DCTCodecConfig", "EvalConfig", "LossConfig", "MeshConfig", "ModelConfig", "QuantizerConfig",
           "SaliencyConfig", "TrainConfig", "__version__"]

"""Configuration dataclasses of the PyTorch port.

Field names and defaults are those of `contextual_image_compression_tpu.config`
(`SaliencyConfig`, `QuantizerConfig`, `ModelConfig`, `LossConfig`,
`TrainConfig`, `EvalConfig`, `DCTCodecConfig`, `AutoencoderConfig`), and
`analytic_bpp` is its function, so a default-constructed config describes
the same codec, mask engine, DCT baseline, GAN training run, evaluation
and autoencoder in both packages. `MeshConfig` names the (data, model) mesh
of parallel/mesh.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

IMG_SIZE: Tuple[int, int] = (256, 256)
BASE_LATENT_DIM: int = 512
BATCH_SIZE: int = 16
EPOCHS: int = 20
LEARNING_RATE: float = 1e-4
BPP_RANGE: Tuple[float, ...] = (0.1, 1.0, 2.0)
SEED: int = 42


@dataclasses.dataclass(frozen=True)
class SaliencyConfig:
    """Saliency and contextual-mask engine (spectral residual + fine-grained
    center-surround, combined 0.6/0.4, then bilateral -> Gaussian -> max-norm)."""

    # 'combined' with mask_smooth runs kernel K1; every other method, and
    # mask_smooth=False, runs compute_saliency_map -> create_saliency_mask
    # (the smooth mask through kernel K4).
    method: str = "combined"  # 'spectral_residual' | 'fine_grained' | 'combined'
    combined_spectral_weight: float = 0.6
    combined_fine_weight: float = 0.4
    spectral_resolution: int = 64
    spectral_blur_sigma: float = 3.0
    # The 64-point DFT pair as explicit matrix products; False takes the FFT
    # core (torch.fft, cuFFT on the card).
    spectral_dft_matmul: bool = True
    # Feed the fused mask kernel the 64^2 spectral map; it upsamples inside.
    mask_spec_small: bool = True
    fine_grained_scales: Tuple[int, ...] = (1, 2, 3, 4, 5, 6)
    mask_smooth: bool = True
    mask_bilateral_d: int = 9
    mask_bilateral_sigma_color: float = 75.0
    mask_bilateral_sigma_space: float = 75.0
    mask_gaussian_ksize: int = 31  # sigma derived per the OpenCV rule => 5.0
    # False runs JAX's off-TPU formulas instead of kernels K1 / K4:
    # compute_saliency_map, then bilateral -> Gaussian -> max-normalize in
    # image_ops, plain PyTorch on either device.
    mask_use_pallas: bool = True
    # 'bfloat16' runs K1's bf16 route ('combined' with mask_smooth only; the
    # other paths never read it)
    mask_engine_dtype: str = "float32"
    mask_threshold_min: float = 0.05
    mask_threshold_max: float = 0.5
    mask_percentile: float = 0.7


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """Saliency-adaptive latent quantization:
    scale = exp(scale_coeff * quant_strength * (1 - saliency)),
    out = round(latent * scale) / scale.

    grad_mode 'reference' and 'ste' have the same forward; 'auto' resolves
    from the skip topology (ModelConfig.resolved_quantizer)."""

    grad_mode: str = "auto"  # 'auto' | 'reference' | 'ste'
    scale_coeff: float = 3.0
    # False: JAX's jnp formula through autograd (no K3 / K3b), in the latent's dtype
    use_pallas: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Adaptive dual-branch GAN codec shapes and serving lowerings."""

    img_size: Tuple[int, int] = IMG_SIZE
    channels: int = 3
    base_latent_dim: int = BASE_LATENT_DIM  # LQ latent; HQ = 2x
    encoder_channels: Tuple[int, ...] = (64, 128, 256, 512)
    generator_channels: Tuple[int, ...] = (256, 128, 64, 32)
    generator_base_hw: int = 16
    generator_base_ch: int = 512
    generator_polyphase: bool = False
    # Inference tail with BN folded into the last deconv; the port evaluates
    # it in pixel layout with the same rounding (models/packed_tail.py).
    generator_packed_tail: bool = False
    # int8 storage of the tail's intermediate (requires generator_packed_tail).
    packed_tail_int8: bool = False
    encoder_s2d_convs: bool = False
    dense_int8: bool = False
    # Weight-only int8 for the latent/fc projections (inference only).
    dense_w8: bool = False
    leaky_slope: float = 0.2
    hq_attention: bool = True
    attention_use_pallas: bool = True  # False: JAX's jnp formula (einsum, softmax), no K2
    disc_base_filters: int = 16
    disc_max_filters: int = 128
    disc_max_stages: int = 4
    disc_dense_units: int = 128
    bpp_norm_divisor: float = 5.0
    overall_compression_slope: float = 0.8
    hq_lq_threshold_base: float = 0.9
    hq_lq_threshold_slope: float = 0.85
    quant_strength_base: float = 0.9
    quant_strength_slope: float = 0.8
    rate_mode: str = "reference"  # 'reference' | 'fixed'
    fixed_quant_base: float = 0.1
    fixed_quant_slope: float = 6.0
    fixed_quant_max: float = 4.0
    saliency_gamma: float = 0.7
    threshold_sharpness: float = 20.0
    threshold_mode: str = "sigmoid"  # 'sigmoid' | 'hard'
    skip_mode: str = "encoder"  # 'encoder' | 'zero' | 'mask'
    quant_bypass: bool = False
    quantizer: QuantizerConfig = QuantizerConfig()
    dtype: str = "float32"  # compute dtype; 'bfloat16' for serving
    param_dtype: str = "float32"  # 'bfloat16': parameters and Adam moments in bf16

    @property
    def img_shape(self) -> Tuple[int, int, int]:
        return (self.img_size[0], self.img_size[1], self.channels)

    @property
    def hq_latent_dim(self) -> int:
        return self.base_latent_dim * 2

    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def parameter_dtype(self) -> torch.dtype:
        """The torch dtype of `param_dtype` (the codec's and D's parameters;
        BatchNorm statistics stay float32, as flax keeps them)."""
        return torch_dtype(self.param_dtype)

    def resolved_quantizer(self) -> QuantizerConfig:
        """QuantizerConfig with grad_mode='auto' resolved by skip topology:
        'reference' for skip_mode='encoder', 'ste' otherwise."""
        q = self.quantizer
        if q.grad_mode != "auto":
            return q
        mode = "reference" if self.skip_mode == "encoder" else "ste"
        return dataclasses.replace(q, grad_mode=mode)


@dataclasses.dataclass(frozen=True)
class HiFiCConfig:
    """HiFiC (Mentzer et al., NeurIPS 2020, arXiv:2006.09965) at its
    published widths, served by models/hific.py: the encoder's filters
    (the generator's are their reverse), the latent's C_y, the
    hyperprior's N, the generator's residual blocks, the factorized prior
    of z, ChannelNorm's eps, the Gaussian conditional's lower bounds and
    the compute dtype. It has no JAX counterpart."""

    channels: int = 3
    encoder_filters: Tuple[int, ...] = (60, 120, 240, 480, 960)
    latent_channels: int = 220
    hyper_channels: int = 320
    residual_blocks: int = 9
    factorized_filters: Tuple[int, ...] = (3, 3, 3)
    norm_eps: float = 1e-3
    scale_lower_bound: float = 0.11
    likelihood_lower_bound: float = 1e-9
    dtype: str = "bfloat16"

    @property
    def stride(self) -> int:
        """Image pixels per z position: the analysis halves the image once
        per filter after the first, h_a twice more. Each image is padded to
        a multiple of it."""
        return 2 ** (len(self.encoder_filters) - 1) * 4

    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class TCMConfig:
    """TCM, the mixed Transformer-CNN codec (Liu, Sun, Katto, CVPR 2023,
    arXiv:2303.14978; jmliu206/LIC_TCM `models/tcm.py`), served by
    models/tcm.py: N (each CTB's conv and Swin halves, 2N between them), M
    (y's channels), the CTB pairs of each stage (g_a's three, g_s's three),
    their Swin head widths, the windows of g_a / g_s / the slices (8) and
    of the hyperprior (4), the slices of y and their support, SWAtten's
    width and head, z's channels, the factorized prior's filters, the
    Gaussian conditional's lower bounds and the compute dtype. It has no
    JAX counterpart."""

    channels: int = 3
    n: int = 128
    m: int = 320
    stage_blocks: Tuple[int, ...] = (2, 2, 2, 2, 2, 2)
    head_dims: Tuple[int, ...] = (8, 16, 32, 32, 16, 8)
    window: int = 8
    hyper_window: int = 4
    hyper_head_dim: int = 32
    num_slices: int = 5
    max_support_slices: int = 5
    swatten_dim: int = 128
    swatten_head_dim: int = 16
    cc_widths: Tuple[int, ...] = (224, 128)
    z_channels: int = 192
    factorized_filters: Tuple[int, ...] = (3, 3, 3, 3)
    scale_lower_bound: float = 0.11
    likelihood_lower_bound: float = 1e-9
    dtype: str = "bfloat16"

    @property
    def stride(self) -> int:
        """Each image is padded to a multiple of it: y sits at 1/16 and
        holds whole windows of `window`, the hyperprior's blocks at 1/32
        whole windows of `hyper_window`, z at 1/64 (128 at the published
        windows)."""
        return max(16 * self.window, 32 * self.hyper_window, 64)

    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    """The baseline skip-connection autoencoder and its training run."""

    img_size: Tuple[int, int] = (128, 128)
    channels: int = 3
    enc_channels: Tuple[int, int] = (32, 64)
    epochs: int = 50
    batch_size: int = 16
    validation_split: float = 0.1
    learning_rate: float = 1e-3  # keras Adam's default
    dtype: str = "float32"

    @property
    def img_shape(self) -> Tuple[int, int, int]:
        return (self.img_size[0], self.img_size[1], self.channels)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Generator, latent-saliency and RD loss weights and formula switches."""

    recon_weight: float = 0.35
    l1_weight: float = 0.15
    perceptual_weight: float = 0.15
    adv_weight: float = 0.15
    bitrate_weight: float = 0.20
    g_loss_floor: float = 0.5  # floor-offset hack: g += max(0, floor - g) * coeff
    g_loss_floor_coeff: float = 0.5
    ls_loss_weight: float = 0.1
    rd_loss_weight: float = 0.3
    rd_bitrate_weight: float = 0.7
    perceptual_layer_weights: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.3, 0.3)
    perceptual_scale: float = 0.5
    d_real_label: float = 0.9  # label smoothing
    d_fake_label: float = 0.1
    rd_target_bpp_divisor: float = 4.0
    rd_target_clip: Tuple[float, float] = (0.1, 0.9)
    # True reproduces the (B, 1) - (B,) broadcast of the reference's TF code,
    # which turns the latent-saliency and bitrate terms into (B, B) means.
    reference_broadcast_quirk: bool = False
    # weight * (MSE(img, hq_out) + MSE(img, lq_out)) added to the generator
    # loss; 0.0 leaves the term out.
    branch_recon_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """GAN training run. The artifact fields are kept so configs round-trip
    between packages; the port writes no artifacts yet."""

    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    saliency: SaliencyConfig = SaliencyConfig()
    batch_size: int = BATCH_SIZE
    epochs: int = EPOCHS
    learning_rate: float = LEARNING_RATE
    ls_lr_scale: float = 0.5  # latent-saliency optimizer learning rate scale
    rd_lr_scale: float = 0.5  # RD optimizer learning rate scale
    clipnorm: float = 1.0  # per-tensor L2 clip, keras semantics
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-7  # keras default
    bpp_range: Tuple[float, ...] = BPP_RANGE
    d_every_n_steps: int = 2  # D trained every other step
    fine_tune_epochs: int = 3
    seed: int = SEED
    use_perceptual: bool = True
    vgg_weights_path: str = ""  # .npz of VGG19 conv weights, or 'random[:seed]'
    checkpoint_every: int = 5
    results_dir: str = "results"
    model_dir: str = "models_ckpt"
    sample_visualizations: int = 4


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The device mesh of distributed training: its axis names and the
    model-parallel degree; data parallelism fills the rest of the ranks."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation harness (eval/harness.py): the bpp sweep, the rate-control
    sweep, where weights, test images and results live."""

    model: ModelConfig = ModelConfig()
    saliency: SaliencyConfig = SaliencyConfig()
    bpp_values: Tuple[float, ...] = BPP_RANGE
    rate_control_bpps: int = 10  # linspace(0.1, 2.0, 10)
    rate_control_bpp_range: Tuple[float, float] = (0.1, 2.0)
    rate_control_max_images: int = 4
    results_dir: str = "test_results"
    model_dir: str = "models_ckpt"
    test_dir: str = "test_dataset"
    batch_size: int = 16


@dataclasses.dataclass(frozen=True)
class DCTCodecConfig:
    """JPEG-style 8x8 DCT baseline codec (ops/dct.py)."""

    quality: int = 75
    block: int = 8
    use_pallas: bool = True  # False: JAX's einsum formula in float32 (TF32 off), no K5


def analytic_bpp(hq_ratio, base_latent_dim: int = BASE_LATENT_DIM,
                 img_size: Tuple[int, int] = IMG_SIZE):
    """The reference's analytic bits per pixel: 32 bits per float latent,
    bpp = (hq_ratio * 2D * 32 + (1 - hq_ratio) * D * 32) / (H * W), in
    [0.25, 0.50] for D = 512 at 256x256. hq_ratio: a float or numpy array."""
    hq_bits = hq_ratio * (base_latent_dim * 2) * 32.0
    lq_bits = (1.0 - hq_ratio) * base_latent_dim * 32.0
    return (hq_bits + lq_bits) / float(img_size[0] * img_size[1])


def torch_dtype(name: str) -> torch.dtype:
    """'float32' / 'bfloat16' / 'float16' -> the torch dtype."""
    table = {
        "float32": torch.float32,
        "bfloat16": torch.bfloat16,
        "float16": torch.float16,
    }
    if name not in table:
        raise ValueError(f"unsupported dtype name {name!r}")
    return table[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. The default is the card; without
    CUDA that raises unless the caller asked for the CPU explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev

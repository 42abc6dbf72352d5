"""Serving pipeline: uint8 RGB images in -> decoded uint8 images out.

Counterpart of `CompressionPipeline.__call__` in
`contextual_image_compression_tpu/serve.py`, on one device or a mesh:
contextual mask (K1) -> adaptive GAN codec (K2 in the HQ encoder, K3 on both latents) ->
uint8, plus the fp32 bitstream symbols computed from the latents before
quantization. The serving configuration is the JAX package's: bfloat16
compute, the folded generator tail with int8 storage, and weight-only int8
latent/fc projections; each codec makes its serving form in `prepare_serving`.

The storable codec: `serialize_latents` range-codes the symbols into
per-image latent streams, `encode_to_bitstream` packs them with the
downsampled mask and the target bpp into self-contained CICZ containers
(ops/bitstream.py, byte-identical to the JAX package's), and
`decode_from_bitstream` turns containers back into uint8 images through the
generators alone (`AdaptiveCodec.decode_latents`). A faithful round trip
needs a codec trained with skip_mode='zero' (or 'mask'): with the
reference's encoder skips the latents do not carry the whole image.

`model_dir=` serves a checkpoint directory of the JAX package's files
(checkpoint/store.py), with the JAX pipeline's provenance.

`mesh=` (parallel/mesh.py) serves data-parallel over every rank of the
mesh, as the JAX pipeline shards a request over data x model: the
parameters are replicated, every rank is given the whole request, which
is padded to a multiple of the mesh's size by `_padded_batch`, runs its
slice, and gathers the decoded images and the info from the others, so
each rank returns the whole answer. `decode_from_bitstream` pads a ragged
batch of containers the same way.

`model_config=HiFiCConfig(...)` serves HiFiC (models/hific.py) instead, on
one device: no mask stage; each image, of any size, as u8 / 255 padded by
reflection to a multiple of `HiFiCConfig.stride` and cropped back; the decoded
uint8 images and, per image, the symbols of y and z and the bits of both.
Upload, batch padding and download are the GAN codec's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
from contextual_image_compression_tpu_torch.config import (
    HiFiCConfig,
    ModelConfig,
    SaliencyConfig,
    resolve_device,
)
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
from contextual_image_compression_tpu_torch.models.hific import HiFiCCodec
from contextual_image_compression_tpu_torch.models.layers import const
from contextual_image_compression_tpu_torch.ops import bitstream as bs
from contextual_image_compression_tpu_torch.ops import masks as mask_ops
from contextual_image_compression_tpu_torch.ops.saliency import (
    _full_fp32_matmul,
    resize_op_matrix,
)
from contextual_image_compression_tpu_torch.parallel import sharding
from contextual_image_compression_tpu_torch.utils.profiling import annotate


def load_codec_checkpoint(codec: AdaptiveCodec, model_dir: str) -> Dict[str, str]:
    """Load the codec's components from a checkpoint directory by the
    store's ladder, in float32, into `codec` (built and seeded); returns the
    provenance of each component. A component the ladder leaves at "init"
    keeps the codec's current values."""
    templates = convert.codec_variables(codec, leaf=convert.placeholder)
    loaded, provenance = CheckpointStore(model_dir).load_components(templates)
    for comp, tree in loaded.items():
        if provenance[comp] != "init":
            getattr(codec, comp).load_state_dict(convert.component_state(comp, tree, codec.cfg))
    return provenance


def _serving_model_config(cfg: ModelConfig) -> ModelConfig:
    """bf16 inference with the folded int8 generator tail and weight-only
    int8 latent/fc projections (the JAX package's serving configuration)."""
    return dataclasses.replace(
        cfg, dtype="bfloat16", generator_packed_tail=True, dense_w8=True,
        packed_tail_int8=True,
    )


class CompressionPipeline:
    """Batched uint8 -> uint8 contextual-compression serving pipeline.

    pipe = CompressionPipeline(model_dir="models_ckpt", device="cuda")
    decoded_u8, info = pipe(images_u8, target_bpp=1.0)

    `images_u8`: (B, H, W, 3) uint8 (numpy or tensor). Returns the decoded
    uint8 batch as numpy and a dict of tensors on the device with the keys of
    the JAX pipeline's info. Ragged batches pad up to the smallest batch
    size already run that fits, else to the next power of two, as the JAX
    pipeline buckets its compiled executables.

    Weights, as the JAX pipeline takes them: `state_dict` (a converted state
    dict; provenance {"all": "provided"}), else `model_dir`, a checkpoint
    directory of the JAX package's files loaded component by component
    through the store's ladder final -> latest epoch_N -> init (provenance
    {component: "final" / "epoch_N" / "init"}, the JAX pipeline's), else
    the port's own seeded init (provenance {"all": "init"}). A component
    that falls to "init" keeps the port's seeded init (`seed`), whose
    values differ from the JAX package's PRNGKey(0) init.

    A `HiFiCConfig` serves HiFiC (module docstring) from `state_dict` or
    the port's seeded init; its info holds `y_symbols`, `z_symbols` and
    `bits`, and it takes no mesh, checkpoint directory or bitstream."""

    def __init__(
        self,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        model_config: Optional[Union[ModelConfig, HiFiCConfig]] = None,
        saliency_config: Optional[SaliencyConfig] = None,
        device="cuda",
        seed: int = 0,
        model_dir: Optional[str] = None,
        mesh=None,
    ):
        self.mesh = mesh
        self._world = mesh.world.size if mesh is not None else 1
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self._seen_batches: set = set()
        hific = isinstance(model_config, HiFiCConfig)
        if hific and (mesh is not None or model_dir is not None):
            raise ValueError("HiFiC serves on one device from a state_dict or the seeded "
                             "init: no mesh, no checkpoint directory")
        self.mcfg = model_config if hific else _serving_model_config(model_config or ModelConfig())
        self.scfg = saliency_config or SaliencyConfig()
        with torch.device(self.device):
            codec = (HiFiCCodec if hific else AdaptiveCodec)(self.mcfg)
        if state_dict is not None:
            codec.load_state_dict(state_dict)
            self.provenance = {"all": "provided"}
        else:
            codec.reset_parameters(seed)
            if model_dir is not None:
                self.provenance = load_codec_checkpoint(codec, model_dir)
            else:
                self.provenance = {"all": "init"}
        self.codec = codec.prepare_serving()

    @property
    def hific(self) -> bool:
        return isinstance(self.mcfg, HiFiCConfig)

    def _gan_only(self, what: str) -> None:
        if self.hific:
            raise TypeError(f"{what} is the GAN codec's (a fixed image size, CICZ containers)")

    @torch.no_grad()
    def _run(self, imgs_u8: torch.Tensor, bpp: torch.Tensor):
        if self.hific:
            return self._run_hific(imgs_u8)
        ct = self.mcfg.compute_dtype()
        dev = imgs_u8.device
        coeff = float(self.mcfg.quantizer.scale_coeff)
        with annotate("pipeline.mask"):
            mask = mask_ops.compute_contextual_mask(imgs_u8, self.scfg)[..., None]
        with annotate("pipeline.codec"):
            img = imgs_u8.to(ct) * const(1.0 / 127.5, ct, dev) - const(1.0, ct, dev)
            out = self.codec.apply(img, mask.to(ct), bpp)
            decoded = (out.blended.float() + 1.0) * 127.5
            decoded = torch.clamp(torch.round(decoded), 0, 255).to(torch.uint8)
        with annotate("pipeline.symbols"):
            # Symbols in fp32 from the pre-quantization latents, with the JAX
            # pipeline's association exp((coeff * qs) * (1 - s)).
            qs = out.quant_strength.float()
            hq_scale = torch.exp(coeff * qs * (1.0 - out.hq_saliency_quant.float()))
            lq_scale = torch.exp(coeff * qs * (1.0 - out.lq_saliency_quant.float()))
            hq_sym = torch.round(out.hq_latent.float() * hq_scale)
            lq_sym = torch.round(out.lq_latent.float() * lq_scale)
        return decoded, {
            "bit_allocation": out.dynamic_threshold[..., 0],
            "hq_latent_q": out.hq_latent_q,
            "lq_latent_q": out.lq_latent_q,
            "hq_saliency": out.hq_saliency_quant,
            "lq_saliency": out.lq_saliency_quant,
            "quant_strength": out.quant_strength,
            "hq_symbols": hq_sym,
            "lq_symbols": lq_sym,
            "hq_scale": hq_scale[:, 0],
            "lq_scale": lq_scale[:, 0],
            "mask": mask[..., 0],
        }

    @torch.no_grad()
    def _run_hific(self, imgs_u8: torch.Tensor):
        cfg = self.mcfg
        _, h, w, _ = imgs_u8.shape
        with annotate("pipeline.codec"):
            # the (B, H, W, 3) upload viewed as (B, 3, H, W) is channels_last,
            # the codec's layout: no copy in, and none out
            x = (imgs_u8.permute(0, 3, 1, 2) / 255.0).to(cfg.compute_dtype())
            k = cfg.stride
            if h % k or w % k:
                x = F.pad(x, (0, -w % k, 0, -h % k), mode="reflect")
            out = self.codec.apply(x)
            decoded = torch.round(out.x_hat[:, :, :h, :w].float() * 255.0)
            decoded = torch.clamp(decoded, 0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        return decoded.contiguous(), {"y_symbols": out.y_symbols, "z_symbols": out.z_symbols,
                                      "bits": out.bits}

    def warmup(self, batch: int) -> None:
        self._gan_only("warmup")
        h, w = self.mcfg.img_size
        self(np.zeros((batch, h, w, self.mcfg.channels), np.uint8), target_bpp=1.0)

    def _padded_batch(self, b: int) -> int:
        """The smallest batch size already run that fits b, else the next
        power of two, rounded up to a multiple of the mesh's size."""
        fitting = [c for c in self._seen_batches if c >= b]
        if fitting:
            return min(fitting)
        p = 1
        while p < b:
            p *= 2
        return -(-p // self._world) * self._world

    def _on_mesh(self, fn, *args):
        """fn on this rank's slice of args (leading axis split over the
        whole mesh), its outputs gathered from every rank."""
        if self.mesh is None:
            return fn(*args)
        w, pos = self._world, self.mesh.position
        out = fn(*(a.chunk(w, 0)[pos] for a in args))
        return sharding.gather_batch(out, self.mesh.world)

    def __call__(self, images_u8, target_bpp: float = 1.0) -> Tuple[np.ndarray, Dict]:
        with annotate("pipeline.upload"):
            imgs = torch.as_tensor(images_u8)
            if imgs.dtype != torch.uint8 or imgs.ndim != 4:
                raise TypeError("images_u8 must be a (B, H, W, C) uint8 array")
            b = imgs.shape[0]
            bp = self._padded_batch(b)
            if bp != b:
                pad = torch.zeros((bp - b,) + tuple(imgs.shape[1:]), dtype=imgs.dtype)
                imgs = torch.cat([imgs.cpu(), pad], dim=0)
            imgs = imgs.to(self.device)
            bpp = torch.full((bp, 1), float(target_bpp), dtype=self.mcfg.compute_dtype(),
                             device=self.device)
        decoded, info = self._on_mesh(self._run, imgs, bpp)
        self._seen_batches.add(bp)
        with annotate("pipeline.download"):
            if bp != b:
                decoded = decoded[:b]
                info = {k: v[:b] for k, v in info.items()}
            return decoded.cpu().numpy(), info

    def serialize_latents(self, info: Dict) -> Tuple[List[Tuple[bytes, bytes]], np.ndarray]:
        """Range-code the float32 symbols of a call's info into per-image
        (hq, lq) latent streams; returns (streams, measured bits per pixel)."""
        self._gan_only("serialize_latents")

        def host(key):
            return info[key].float().cpu().numpy()

        streams = bs.pack_codec_symbols(host("hq_symbols"), host("lq_symbols"),
                                        host("hq_scale"), host("lq_scale"))
        return streams, bs.measured_bpp(streams, self.mcfg.img_size)

    def encode_to_bitstream(self, images_u8, target_bpp: float = 1.0,
                            mask_downsample: int = 8) -> List[bytes]:
        """uint8 (B, H, W, C) -> one self-contained container per image: the
        latent streams, the mask downsampled to uint8 and the target bpp."""
        self._gan_only("encode_to_bitstream")
        _, info = self(images_u8, target_bpp=target_bpp)
        latent_streams, _ = self.serialize_latents(info)
        mask = info["mask"].float().cpu().numpy()
        return [bs.pack_container(hq, lq, mask[i], target_bpp, self.mcfg.img_size,
                                  mask_downsample)
                for i, (hq, lq) in enumerate(latent_streams)]

    @torch.no_grad()
    def _decode(self, hq: torch.Tensor, lq: torch.Tensor, mask_small: torch.Tensor,
                bpp: torch.Tensor) -> torch.Tensor:
        h, w = self.mcfg.img_size
        dev = hq.device
        # jax.image.resize(..., "bilinear") upsampling: half-pixel centres, no antialias
        rh = torch.from_numpy(resize_op_matrix(mask_small.shape[1], h)).to(dev)
        rw = torch.from_numpy(resize_op_matrix(mask_small.shape[2], w)).to(dev)
        with _full_fp32_matmul(dev):
            mask = (rh @ mask_small) @ rw.T
        img = self.codec.decode_latents(hq, lq, mask[..., None], bpp)
        decoded = (img.float() + 1.0) * 127.5
        return torch.clamp(torch.round(decoded), 0, 255).to(torch.uint8)

    def decode_from_bitstream(self, streams) -> np.ndarray:
        """Containers (one bytes object or a list) -> decoded uint8 images
        (B, H, W, C), with no encoder in the loop."""
        self._gan_only("decode_from_bitstream")
        if isinstance(streams, (bytes, bytearray)):
            streams = [streams]
        parts = [bs.unpack_container(s) for s in streams]
        h, w = self.mcfg.img_size
        for p in parts:
            if p["img_hw"] != (h, w):
                raise ValueError(f"stream image size {p['img_hw']} != pipeline {(h, w)}")

        def stack(key):
            return torch.from_numpy(np.stack([p[key] for p in parts])).to(self.device)

        bpp = torch.tensor([[p["target_bpp"]] for p in parts], dtype=torch.float32,
                           device=self.device)
        args = [stack("hq_latent"), stack("lq_latent"), stack("mask_small"), bpp]
        b = len(parts)
        bp = self._padded_batch(b) if self.mesh is not None else b
        if bp != b:
            args = [torch.cat([a, a.new_zeros((bp - b,) + tuple(a.shape[1:]))]) for a in args]
        return self._on_mesh(self._decode, *args)[:b].cpu().numpy()

"""GAN codec evaluation harness.

Counterpart of `contextual_image_compression_tpu/eval/harness.py::
CodecEvaluator`, on one device or a (data, model) mesh:

  * `load_models`: the codec's components from a checkpoint directory of
    the JAX package's files, by the store's ladder final -> latest epoch_N
    -> init (checkpoint/store.py), with the provenance of each;
  * `run_batch`: the codec forward (`AdaptiveCodec.apply`, inference, under
    `torch.no_grad()`) over an image set at one target bpp, in device
    batches, the last one padded to the full batch with copies of its last
    image and sliced back, as the JAX harness pads its jitted batch;
  * `compress_and_reconstruct`: PSNR / SSIM / MSE on the device, the HQ
    ratio and the analytic bpp, and the measured bpp of real bitstreams:
    the quantized latents range-coded (ops/bitstream.py) at each image's
    quantizer scale exp(coeff * quant_strength * (1 - saliency));
  * `test_compression`: the bpp sweep, with per-bpp `metrics.txt`,
    compressed images and visualizations under `results_dir/bpp_<b>/`;
  * `test_rate_control`: the fine rate-control sweep, linspace(0.1, 2.0,
    10) over the first 4 images, and its scatter plots;
  * `run`: the whole flow from `model_dir` and `test_dir`.

The masks come from `data/pipeline.py::prepare_masks` with
`EvalConfig.saliency` ('combined' runs kernel K1, in float32 or on its bf16
route). The codec runs in `EvalConfig.model`'s dtype: K2 in the HQ encoder,
K3 on both latents. Artifacts: metrics.txt is written before the images and
plots, so it exists where matplotlib (the plots) is missing.

`mesh=` (parallel/mesh.py): the codec's parameters are placed by the state
rules (parallel/sharding.py: the largest split over 'model', the latent and
fc projections then computing over the model group) and each device batch
is split over 'data'; the outputs are gathered back, so every rank holds
every result, and mesh position 0 alone writes the artifacts.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
from contextual_image_compression_tpu_torch.config import EvalConfig, analytic_bpp, resolve_device
from contextual_image_compression_tpu_torch.data import images as image_io
from contextual_image_compression_tpu_torch.data.pipeline import prepare_masks
from contextual_image_compression_tpu_torch.eval import plots
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec, CodecOutput
from contextual_image_compression_tpu_torch.ops import bitstream
from contextual_image_compression_tpu_torch.ops import metrics as metric_ops
from contextual_image_compression_tpu_torch.parallel import sharding

# The bpps of the bit-allocation panels of the rate-control artifacts.
_VIS_BPPS = (0.1, 1.0, 2.0)


class CodecEvaluator:
    """Evaluates a codec of `cfg.model` on `device` ('cuda' unless the caller
    asks for the CPU, where every kernel wrapper runs its plain twin).
    `seed` seeds the port's init of components a checkpoint lacks; `mesh`
    see the module docstring."""

    def __init__(self, cfg: EvalConfig = EvalConfig(), device="cuda", seed: int = 0,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.writer = mesh is None or mesh.is_writer
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.seed = seed
        with torch.device(self.device):
            self.codec = AdaptiveCodec(cfg.model)
        self.codec.reset_parameters(seed)
        self.codec.eval().requires_grad_(False)

    # ------------------------------------------------------------------ load
    def load_models(self, model_dir: Optional[str] = None):
        """Load the codec's components by the ladder final -> latest epoch_N
        -> init; a component left at 'init' keeps the seeded init. Returns
        (codec, provenance); the codec is what the methods below take."""
        templates = convert.codec_variables(self.codec, leaf=convert.placeholder)
        loaded, provenance = CheckpointStore(model_dir or self.cfg.model_dir).load_components(
            templates)
        for comp, tree in loaded.items():
            if provenance[comp] != "init":
                getattr(self.codec, comp).load_state_dict(
                    convert.component_state(comp, tree, self.cfg.model))
        if self.mesh is not None:
            sharding.shard_state(self.codec, self.mesh)
        return self.codec, provenance

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def run_batch(self, codec: AdaptiveCodec, images: np.ndarray, masks: np.ndarray, bpp: float,
                  batch_size: Optional[int] = None) -> List[CodecOutput]:
        """The codec forward over an image set at one target bpp, in device
        batches of `batch_size` (cfg.batch_size); the last batch is padded
        with copies of its last image and its outputs sliced back."""
        bs = batch_size or self.cfg.batch_size
        outs = []
        for start in range(0, len(images), bs):
            img_np = images[start:start + bs]
            mask_np = masks[start:start + bs]
            n = len(img_np)
            if n < bs:
                pad = bs - n
                img_np = np.concatenate([img_np, np.repeat(img_np[-1:], pad, 0)])
                mask_np = np.concatenate([mask_np, np.repeat(mask_np[-1:], pad, 0)])
            img = torch.from_numpy(np.ascontiguousarray(img_np, np.float32)).to(self.device)
            mask = torch.from_numpy(np.ascontiguousarray(mask_np, np.float32)).to(self.device)
            bpp_t = torch.full((bs, 1), bpp, dtype=torch.float32, device=self.device)
            if self.mesh is None:
                out = codec.apply(img, mask, bpp_t)
            else:
                part = sharding.shard_batch((img, mask, bpp_t), self.mesh, node_local=False)
                out = sharding.gather_batch(codec.apply(*part), self.mesh.data)
            if n < bs:
                out = CodecOutput(*(x[:n] for x in out))
            outs.append(out)
        return outs

    def compress_and_reconstruct(self, codec: AdaptiveCodec, images: np.ndarray,
                                 masks: np.ndarray, target_bpp: float) -> Dict[str, np.ndarray]:
        """Per-image arrays of one target bpp: the decoded images, the bit
        allocation maps, PSNR / SSIM / MSE, the HQ and LQ ratios, the
        analytic and the measured (real bitstream) bpp and the compression
        ratio."""
        mcfg = self.cfg.model
        all_metrics = {"psnr": [], "ssim": [], "mse": []}
        compressed, allocations, hq_ratios, measured = [], [], [], []
        offset = 0

        def host(t):
            return t.float().cpu().numpy()

        for out in self.run_batch(codec, images, masks, target_bpp):
            n = out.blended.shape[0]
            original = torch.from_numpy(np.ascontiguousarray(images[offset:offset + n],
                                                             np.float32)).to(self.device)
            with torch.no_grad():
                m = metric_ops.gan_metrics(original, out.blended.float())
            offset += n
            for k in all_metrics:
                all_metrics[k].append(host(m[k]))
            compressed.append(host(out.blended))
            allocations.append(host(out.dynamic_threshold))
            hq_ratios.append(host(torch.mean(out.dynamic_threshold.float(), dim=(1, 2, 3))))
            # real bitstream sizes beside the analytic accounting: the
            # quantized latents range-coded at each image's quantizer scale
            qs = host(out.quant_strength)[:, 0]
            coeff = mcfg.quantizer.scale_coeff
            hq_scales = np.exp(coeff * qs * (1.0 - host(out.hq_saliency_quant)[:, 0]))
            lq_scales = np.exp(coeff * qs * (1.0 - host(out.lq_saliency_quant)[:, 0]))
            streams = bitstream.pack_codec_latents(host(out.hq_latent_q), host(out.lq_latent_q),
                                                   hq_scales, lq_scales)
            measured.append(bitstream.measured_bpp(streams, mcfg.img_size))

        hq_ratio = np.concatenate(hq_ratios)
        actual_bpp = np.asarray(analytic_bpp(hq_ratio, mcfg.base_latent_dim, mcfg.img_size))
        original_bits = mcfg.img_size[0] * mcfg.img_size[1] * 3 * 8
        total_bits = actual_bpp * mcfg.img_size[0] * mcfg.img_size[1]
        return {
            "compressed": np.concatenate(compressed),
            "bit_allocation": np.concatenate(allocations),
            "psnr": np.concatenate(all_metrics["psnr"]),
            "ssim": np.concatenate(all_metrics["ssim"]),
            "mse": np.concatenate(all_metrics["mse"]),
            "hq_ratio": hq_ratio,
            "lq_ratio": 1.0 - hq_ratio,
            "actual_bpp": actual_bpp,
            "measured_bpp": np.concatenate(measured),
            "compression_ratio": original_bits / np.maximum(total_bits, 1e-9),
        }

    # ------------------------------------------------------------------ sweep
    def test_compression(self, codec: AdaptiveCodec, images: np.ndarray, masks: np.ndarray,
                         file_names: Sequence[str], results_dir: Optional[str] = None,
                         save_artifacts: bool = True) -> Dict[str, Dict]:
        """The bpp sweep over cfg.bpp_values: per-image metrics, their
        averages and, with save_artifacts, `bpp_<b>/metrics.txt`, the
        compressed images under `bpp_<b>/compressed/` and the figures under
        `bpp_<b>/visualizations/`."""
        results_dir = results_dir or self.cfg.results_dir
        results_by_bpp: Dict[float, Dict[str, list]] = {}
        avg_metrics: Dict[float, Dict[str, float]] = {}

        for bpp in self.cfg.bpp_values:
            r = self.compress_and_reconstruct(codec, images, masks, bpp)
            results_by_bpp[bpp] = {
                "psnr": list(map(float, r["psnr"])),
                "ssim": list(map(float, r["ssim"])),
                "mse": list(map(float, r["mse"])),
                "compression_ratio": list(map(float, r["compression_ratio"])),
                "actual_bpp": list(map(float, r["actual_bpp"])),
                "measured_bpp": list(map(float, r["measured_bpp"])),
                "hq_ratio": list(map(float, r["hq_ratio"])),
            }
            avg_metrics[bpp] = {
                k: float(np.mean(v)) if v else 0.0
                for k, v in results_by_bpp[bpp].items()
            }

            if save_artifacts and self.writer:
                bpp_dir = os.path.join(results_dir, f"bpp_{bpp}")
                out_dir = os.path.join(bpp_dir, "compressed")
                vis_dir = os.path.join(bpp_dir, "visualizations")
                image_io.create_directories([bpp_dir, out_dir, vis_dir])
                self._write_metrics_txt(os.path.join(bpp_dir, "metrics.txt"), bpp,
                                        avg_metrics[bpp], results_by_bpp[bpp], file_names)
                for i, name in enumerate(file_names):
                    image_io.save_image(r["compressed"][i], os.path.join(out_dir, name))
                for i, name in enumerate(file_names):
                    plots.visualize_results(
                        images[i], masks[i, :, :, 0], r["compressed"][i],
                        os.path.join(vis_dir, f"{os.path.splitext(name)[0]}_vis.png"),
                        r["bit_allocation"][i],
                    )

        return {"by_bpp": results_by_bpp, "avg_metrics": avg_metrics}

    @staticmethod
    def _write_metrics_txt(path, bpp, avg, per_image, file_names):
        """metrics.txt: the averages, then each image's metrics."""
        with open(path, "w") as f:
            f.write(f"Target BPP: {bpp}\n\n")
            f.write(f"Average PSNR: {avg['psnr']:.2f} dB\n")
            f.write(f"Average SSIM: {avg['ssim']:.4f}\n")
            f.write(f"Average MSE: {avg['mse']:.6f}\n")
            f.write(f"Average Compression Ratio: {avg['compression_ratio']:.2f}x\n")
            f.write(f"Average Actual BPP: {avg['actual_bpp']:.4f}\n")
            f.write(f"Average Measured BPP (real bitstream): {avg['measured_bpp']:.4f}\n")
            f.write(f"Average HQ Region Ratio: {avg['hq_ratio'] * 100:.2f}%\n\n")
            f.write("Image-by-image metrics:\n")
            for i, name in enumerate(file_names):
                f.write(f"\n{name}:\n")
                f.write(f"  PSNR: {per_image['psnr'][i]:.2f} dB\n")
                f.write(f"  SSIM: {per_image['ssim'][i]:.4f}\n")
                f.write(f"  MSE: {per_image['mse'][i]:.6f}\n")
                f.write(f"  Compression Ratio: {per_image['compression_ratio'][i]:.2f}x\n")
                f.write(f"  Actual BPP: {per_image['actual_bpp'][i]:.4f}\n")
                f.write(f"  Measured BPP: {per_image['measured_bpp'][i]:.4f}\n")
                f.write(f"  HQ Region Ratio: {per_image['hq_ratio'][i] * 100:.2f}%\n")

    # ----------------------------------------------------------- rate control
    def test_rate_control(self, codec: AdaptiveCodec, images: np.ndarray, masks: np.ndarray,
                          file_names: Sequence[str], results_dir: Optional[str] = None,
                          save_artifacts: bool = True) -> Dict[str, list]:
        """The fine rate-control sweep: cfg.rate_control_bpps target bpps over
        cfg.rate_control_bpp_range on the first cfg.rate_control_max_images
        images. With save_artifacts, `rate_control_test/` gets each image's
        bit-allocation strip at 0.1, 1.0 and 2.0 bpp and the two scatter
        plots."""
        cfg = self.cfg
        results_dir = results_dir or cfg.results_dir
        k = min(cfg.rate_control_max_images, len(images))
        sub_images, sub_masks = images[:k], masks[:k]
        sub_names = list(file_names[:k])
        test_bpps = np.linspace(*cfg.rate_control_bpp_range, cfg.rate_control_bpps)

        results = {"target_bpp": [], "actual_bpp": [], "hq_ratio": [], "image": []}
        allocations_per_image: List[Dict[float, np.ndarray]] = [dict() for _ in range(k)]
        for bpp in test_bpps:
            r = self.compress_and_reconstruct(codec, sub_images, sub_masks, float(bpp))
            for i in range(k):
                results["target_bpp"].append(float(bpp))
                results["actual_bpp"].append(float(r["actual_bpp"][i]))
                results["hq_ratio"].append(float(r["hq_ratio"][i]))
                results["image"].append(sub_names[i])
                if float(bpp) in _VIS_BPPS:
                    allocations_per_image[i][float(bpp)] = r["bit_allocation"][i]
        if save_artifacts:
            # the panels are at exactly 0.1, 1.0 and 2.0 bpp; the linspace
            # holds only the ends, so the missing ones run here
            for bpp in _VIS_BPPS:
                if any(bpp not in allocations_per_image[i] for i in range(k)):
                    r = self.compress_and_reconstruct(codec, sub_images, sub_masks, bpp)
                    for i in range(k):
                        allocations_per_image[i][bpp] = r["bit_allocation"][i]
        if save_artifacts and self.writer:
            rc_dir = os.path.join(results_dir, "rate_control_test")
            image_io.create_directories([rc_dir])
            for i, name in enumerate(sub_names):
                if allocations_per_image[i]:
                    plots.visualize_bit_allocation_by_bpp(
                        sub_images[i], allocations_per_image[i],
                        os.path.join(rc_dir, f"{os.path.splitext(name)[0]}_bit_allocation.png"),
                    )
            plots.plot_rate_control_scatter(results, rc_dir)
        return results

    # ------------------------------------------------------------------- main
    def run(self, model_dir: Optional[str] = None, test_dir: Optional[str] = None):
        """The whole flow: load, read the test folder, masks, the bpp sweep,
        the rate-control sweep and the rate-distortion CSV and curves."""
        cfg = self.cfg
        codec, provenance = self.load_models(model_dir)
        print(f"Loaded components: {provenance}")
        images, file_names, _sizes = image_io.load_folder_gan(test_dir or cfg.test_dir,
                                                              cfg.model.img_size)
        if len(images) == 0:
            print("No test images found!")
            return None
        masks = prepare_masks(images, cfg.saliency, device=self.device)
        if self.writer:
            image_io.create_directories([cfg.results_dir])
        results = self.test_compression(codec, images, masks, file_names)
        self.test_rate_control(codec, images, masks, file_names)
        if results["avg_metrics"] and self.writer:
            plots.plot_rate_distortion_curve(results["avg_metrics"], cfg.results_dir)
        return results

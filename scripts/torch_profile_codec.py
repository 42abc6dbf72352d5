#!/usr/bin/env python
"""Per-component throughput breakdown of the adaptive codec forward with the
PyTorch port, with the flags and the JSON keys of scripts/profile_codec.py.

The codec is `ModelConfig(dtype="bfloat16")` with seeded weights cast to
bf16 (as the JAX script casts its variables), at --batch images of the
config's size. Each component is timed on its own and reported in images
per second: the whole codec forward (`codec_full`), the saliency and mask
engine (`saliency_mask`, kernel K1), each encoder, the SAGAN layer alone on
the HQ encoder's attention-stage features with bf16 parameters through
kernel K2 (`attention_pallas`) and through the JAX package's jnp formula
(`attention_xla`, use_pallas=False: no K2), each generator on fixed latents
and skips, and the glue (latent-saliency MLPs, the RD network and schedule,
K3 twice, the blend). On the card a time is the median of `measure.event_ms`
(CUDA events, the host's launch inside); on the CPU the host clock of
`utils/profiling.benchmark`. The per-row lines go to stderr, one JSON object
to stdout.

Usage: python scripts/torch_profile_codec.py [--batch 128] [--iters 20] [--trace DIR]

--trace DIR writes a torch.profiler Chrome trace (utils/profiling.trace) of
five codec_full calls there. It runs on the card; main(device="cpu") runs it
on the CPU.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--trace", default=None, help="write a torch.profiler trace here")
    args = p.parse_args(argv)

    import torch

    from contextual_image_compression_tpu_torch import measure
    from contextual_image_compression_tpu_torch.config import (
        ModelConfig,
        SaliencyConfig,
        resolve_device,
    )
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
    from contextual_image_compression_tpu_torch.models.attention import SelfAttention
    from contextual_image_compression_tpu_torch.ops import masks as mask_ops
    from contextual_image_compression_tpu_torch.ops.quantize import adaptive_quantize
    from contextual_image_compression_tpu_torch.utils import profiling
    from contextual_image_compression_tpu_torch.utils.tree import cast_floats

    dev = resolve_device(device)
    batch = args.batch
    bf = torch.bfloat16
    cfg = ModelConfig(dtype="bfloat16")
    h, w = cfg.img_size
    with torch.device(dev):
        codec = AdaptiveCodec(cfg)
    codec.reset_parameters(0)
    cast_floats(codec, bf)
    codec.eval()
    imgs = torch.from_numpy(synthetic_images(batch, cfg.img_size, seed=0)).to(dev, bf)
    mask = torch.full((batch, h, w, 1), 0.5, dtype=bf, device=dev)
    bpp = torch.ones((batch, 1), dtype=bf, device=dev)
    x = imgs.permute(0, 3, 1, 2)
    scfg = SaliencyConfig()

    out = {"batch": batch, "backend": dev.type}

    def run(name, fn):
        with torch.no_grad():
            if dev.type == "cuda":
                ms = measure.event_ms(fn, reps=args.iters)
            else:
                ms = 1e3 * profiling.benchmark(fn, warmup=1, iters=args.iters)["sec_per_call"]
        ips = batch / (ms / 1e3)
        out[name] = round(ips, 1)
        print(f"{name:32s} {ips:10.0f} img/s  ({1e3 * ms / batch:8.1f} us/img)",
              file=sys.stderr, flush=True)

    def codec_step():
        return codec.apply(imgs, mask, bpp).blended

    run("codec_full", codec_step)
    run("saliency_mask", lambda: mask_ops.compute_contextual_mask(imgs.float(), scfg))
    run("encoder_hq(with attn)", lambda: codec.hq_encoder(x))
    run("encoder_lq", lambda: codec.lq_encoder(x))

    # the SAGAN layer alone on the attention stage's features, bf16 parameters
    c3 = cfg.encoder_channels[2]
    gen = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn((batch, c3, h // 8, w // 8), generator=gen, device=dev).to(bf)
    with torch.device(dev):
        attn = SelfAttention(c3, use_pallas=True)
        attn_x = SelfAttention(c3, use_pallas=False)
    attn.reset_parameters(torch.Generator(device=dev).manual_seed(2))
    cast_floats(attn, bf)
    attn_x.load_state_dict(attn.state_dict())
    cast_floats(attn_x, bf)
    run("attention_pallas", lambda: attn(feats))
    run("attention_xla", lambda: attn_x(feats))

    # generators on fixed latents and skips
    with torch.no_grad():
        lat_hq, skips_hq = codec.hq_encoder(x)
        lat_lq, skips_lq = codec.lq_encoder(x)
    run("generator_hq", lambda: codec.hq_generator(lat_hq, skips_hq))
    run("generator_lq", lambda: codec.lq_generator(lat_lq, skips_lq))

    # glue: latent saliency + RD + quantize + threshold + blend
    hq_out = torch.zeros((batch, h, w, 3), dtype=bf, device=dev)
    m = mask.permute(0, 3, 1, 2)
    qcfg = cfg.resolved_quantizer()

    def glue():
        s_hq = codec.latent_saliency_hq(lat_hq)
        s_lq = codec.latent_saliency_lq(lat_lq)
        rd = codec.rd_optimizer(m, bpp)
        _, thr, qs = codec.rd_schedule(bpp)
        dyn = codec.dynamic_threshold(m, thr).permute(0, 2, 3, 1)
        zq_hq = adaptive_quantize(lat_hq, s_hq, qs, qcfg)
        zq_lq = adaptive_quantize(lat_lq, s_lq, qs, qcfg)
        return hq_out * dyn + imgs * (1 - dyn), zq_hq, zq_lq, rd

    run("glue(ls+rd+quant+blend)", glue)

    if args.trace:
        with torch.no_grad(), profiling.trace(args.trace):
            for _ in range(5):
                codec_step()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        print(f"trace written to {args.trace}", file=sys.stderr)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

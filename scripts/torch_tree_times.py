"""K1, K2 / K6 float32, K3, K3b, K4, K5, K7a, K7b, K8 and the serving call of
one checkout of the port, timed on one GPU, for parent / change comparisons
within one run.

    python3 scripts/torch_tree_times.py PATH_TO_CHECKOUT

Imports contextual_image_compression_tpu_torch from the checkout at PATH
(the kernels build there at first use) and prints one JSON line: the card,
and for K1 (16, 256, 256), K3 (one serving call's pair, bf16, under
no_grad), K3b (one training step's pair, float32), K4 (64, 256, 256), K7a
and K7b (the fused SAGAN block on a (16, 256, 32, 32) bf16 activation with
seeded weights of the HQ encoder's shapes, C 256 and C/8 32, gamma 0.5;
K7b on the NCHW tensor viewed (B, H, W, C)) and K8 (the fused generator
tail on a (16, 128, 128, 128) bf16 input, Cmid 32, Co 3), in bf16 and
float32, K2 and K6 in float32 at the paths' shape (q, k (16, 1024, 32), v
and residual (16, 1024, 256), gamma 0.5) beside their yardsticks
softmax(q k^T) v in three calls (TF32 off) and one SDPA call (scale 1),
and K5 on the level-shifted planes of 128 synthetic 256^2 images at
quality 75, each by `measure.event_ms` (the host's launch inside) and
`measure.device_ms` (the device alone), then the median, min and max of 15 serving calls of
CompressionPipeline(ModelConfig()) at B = 16 after 3 warm-up calls. Run it
for parent and change in turns (parent, change, change, parent) on one
machine, one after another: host-inclusive times move between processes
and machines. It needs a CUDA device.

Beside each kernel's times it prints the SHA-256 of its output at these
seeded inputs, so two trees compare bit for bit. `--save FILE` writes the
K7 / K8 outputs to an .npz, and `--against FILE` (another tree's --save)
prints, per kernel of both, whether the outputs are bitwise equal and
their largest difference:

    python3 scripts/torch_tree_times.py PARENT --save parent.npz
    python3 scripts/torch_tree_times.py CHANGE --against parent.npz
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", help="root of a checkout holding contextual_image_compression_tpu_torch")
    ap.add_argument("--save", help="write the K7 / K8 outputs to this .npz")
    ap.add_argument("--against", help="an .npz from another tree's --save to compare with")
    args = ap.parse_args()
    root = os.path.realpath(args.checkout)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from contextual_image_compression_tpu_torch.config import ModelConfig, QuantizerConfig
    from contextual_image_compression_tpu_torch.measure import (
        card_name_and_power, device_ms, event_ms, randomize_stats, structured_images)
    from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck
    from contextual_image_compression_tpu_torch.ops import image_ops, saliency
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.ops.attention import (
        attention_block, attention_core, sagan_block, sagan_block_spatial)
    from contextual_image_compression_tpu_torch.ops.dct import (
        dct_strips, quality_tables, rgb_to_ycbcr)
    from contextual_image_compression_tpu_torch.ops.generator_tail import fused_tail
    from contextual_image_compression_tpu_torch.ops.fused_mask import contextual_mask, smooth_mask
    from contextual_image_compression_tpu_torch.ops.quantize import (
        adaptive_quantize, adaptive_quantize_bwd)
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    if not ck.__file__.startswith(root):
        raise RuntimeError(f"imported {ck.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ck.library()
    out = {"tree": root, "card": card_name_and_power()}
    u8 = torch.from_numpy(structured_images(np.random.RandomState(0), 16, 256)).to(dev)
    gray = image_ops.rgb_to_gray(u8.float()).contiguous()
    spec = saliency.spectral_residual_small(gray, 64, 3.0).contiguous()
    sal = torch.rand(64, 256, 256, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    cfg = QuantizerConfig(grad_mode="reference")
    gen = torch.Generator(device=dev).manual_seed(3)
    q_cases = []
    for d in (1024, 512):  # the HQ and LQ latents of one call
        z = (torch.randn(16, d, device=dev, generator=gen) * 2).to(torch.bfloat16)
        s = torch.rand(16, 1, device=dev, generator=gen).to(torch.bfloat16)
        q = (torch.rand(16, 1, device=dev, generator=gen) * 0.9).to(torch.bfloat16)
        q_cases.append((z, s, q))
    b_cases = [(z.float(), s.float(), q.float(),
                torch.randn(z.shape, device=dev, generator=gen) * 1e-3) for z, s, q in q_cases]

    def k3_pair():
        with torch.no_grad():  # as serving calls it
            return [adaptive_quantize(z, s, q, cfg) for z, s, q in q_cases]

    fns = {
        "K1": lambda: contextual_mask(gray, spec),
        "K3": k3_pair,
        "K3b": lambda: [adaptive_quantize_bwd(*c) for c in b_cases],
        "K4": lambda: smooth_mask(sal),
    }
    # K7 / K8 inputs, seeded, at the entry points' full-width shapes
    gen = torch.Generator(device=dev).manual_seed(7)

    def r(*shape, scale=0.1):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    act = r(16, 256, 32, 32, scale=0.5)
    sagan_w = [r(256, 32), r(32), r(256, 32), r(32), r(256, 256), r(256)]
    tail_in = r(16, 128, 128, 128, scale=0.5)
    tail_w = [r(128, 32, 4, 4), r(32), r(3, 32, 4, 4), r(3)]
    g = torch.tensor(0.5, device=dev)
    for dt, tag in ((torch.bfloat16, ""), (torch.float32, "_float32")):
        x = act.to(dt)
        w = [t.to(dt) if i % 2 == 0 else t for i, t in enumerate(sagan_w)]
        xf = x.permute(0, 2, 3, 1).reshape(16, 1024, 256)
        view = x.permute(0, 2, 3, 1)
        tx = tail_in.to(dt)
        tw = [t.to(dt) for t in tail_w[:3]] + [tail_w[3]]
        fns["K7a" + tag] = lambda xf=xf, w=w: sagan_block(xf, *w, g)
        fns["K7b" + tag] = lambda view=view, w=w: sagan_block_spatial(view, *w, g)
        fns["K8" + tag] = lambda tx=tx, tw=tw: fused_tail(tx, *tw)
    # K2 / K6 float32 and their yardsticks at the paths' shape
    gen = torch.Generator(device=dev).manual_seed(2)
    aq, ak = (torch.randn(16, 1024, 32, device=dev, generator=gen) * 0.4 for _ in range(2))
    av, ares = (torch.randn(16, 1024, 256, device=dev, generator=gen) for _ in range(2))
    fns["K2_float32"] = lambda: attention_block(aq, ak, av, ares, g)
    fns["K6_float32"] = lambda: attention_core(aq, ak, av)
    fns["three_calls_float32"] = lambda: torch.softmax(aq @ ak.transpose(1, 2), dim=-1) @ av
    fns["sdpa_float32"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        aq, ak, av, scale=1.0)
    imgs = torch.from_numpy(synthetic_images(128, (256, 256), seed=50)).to(dev)
    planes = (rgb_to_ycbcr((imgs + 1.0) * 127.5) - 128.0).permute(0, 3, 1, 2).contiguous()
    tables = torch.from_numpy(quality_tables(75)).to(dev)
    fns["K5"] = lambda: dct_strips(planes, tables)
    saved = {}
    with torch.no_grad():
        for name, fn in fns.items():
            res = fn()
            torch.cuda.synchronize()
            flat = [t.detach().float().cpu().numpy().ravel() for t in _tensors(res)]
            digest = hashlib.sha256(b"".join(a.tobytes() for a in flat)).hexdigest()
            if name.startswith(("K7", "K8")):
                saved[name] = np.concatenate(flat)
            out[name] = {"ms": event_ms(fn), "device_ms": device_ms(fn), "sha256": digest}
    if args.save:
        np.savez(args.save, **saved)
    if args.against:
        other = np.load(args.against)
        out["against"] = {
            name: {"bitwise_equal": bool(np.array_equal(saved[name], other[name])),
                   "max_abs_diff": float(np.abs(saved[name] - other[name]).max())}
            for name in sorted(set(saved) & set(other.files))}

    pipe = CompressionPipeline(model_config=ModelConfig(), device=dev, seed=0)
    randomize_stats(pipe.codec, 0)
    imgs = structured_images(np.random.RandomState(1), 16, 256)
    for _ in range(3):
        pipe(imgs, target_bpp=1.0)
    torch.cuda.synchronize()
    times = []
    for _ in range(15):
        t = time.perf_counter()
        pipe(imgs, target_bpp=1.0)  # ends in a device->host copy
        times.append((time.perf_counter() - t) * 1e3)
    out["serving_call_ms"] = {"median": float(np.median(times)), "min": float(np.min(times)),
                              "max": float(np.max(times))}
    print(json.dumps(out), flush=True)
    return 0


def _tensors(res):
    """The tensors of a kernel call's result, in order (a tensor, or nested
    tuples and lists of them)."""
    if torch.is_tensor(res):
        return [res]
    return [t for part in res for t in _tensors(part)]


if __name__ == "__main__":
    sys.exit(main())

"""K7's float32 route (the fused SAGAN block) held against its twin and
against a float64 reference over input scales, for one checkout of the port.

    python3 scripts/torch_k7_f32_error.py PATH_TO_CHECKOUT [--json FILE] [--seeds N]

Imports contextual_image_compression_tpu_torch from the checkout at PATH
(the kernels build there at first use) and, for each case below, runs
`sagan_block` in float32 on the card and prints one JSON line: the route
it took, max |kernel - twin| (`sagan_block_plain` on the card, TF32 off;
the bar is 1e-5), max |kernel - ref| and max |twin - ref| against the same
block in float64, the largest |score| of the float64 reference, the
device time of one call (`measure.device_ms`), and whether K7b on the
NCHW layout of the same input keeps that layout and gives K7a's bits. Where the checkout's float32
route writes the TF32 scratch of K2's float32 kernel (`_pack_qkv_tf32`), it
also reads Q, K and V back from that scratch (hi + lo) and splits the
kernel's error into the projections' (max |Q - ref|, |K - ref|, |V - ref|,
beside the twin's float32 projections) and the attention's own (the
kernel's output against float64 attention on the kernel's own Q, K, V).

Cases (gamma 0.5, inputs seeded): `params` is the card tests' weights
(every weight and bias ~ N(0, 0.01)) with x ~ N(0, 1), at C 64 / 128 / 256
and N 100 / 1024, B 2; `tree_times` is scripts/torch_tree_times.py's K7
input (16, 1024, 256), x ~ N(0, 0.25), weights ~ N(0, 0.01); `init` is the
SelfAttention convs' glorot-uniform init with x ~ N(0, 0.25); `scale_*`
sweeps the std of x at C 256, N 1024 with the `params` weights. Run it for
several checkouts in turns on one machine to compare their routes.

Then one line `kernels`: the device kernels of one K7a and one K7b call
at the `tree_times` input and their device times (torch.profiler); and with
`--seeds N`, one line per seeded family with the min, median and max of
max |kernel - twin| over N seeds: `ragged` (the card test
test_k7a_ragged_matches_twin's (2, 100, 128) with the `params` weights,
x ~ N(0, 1)) and `tree_times` (its shapes and scales, seeds 0..N-1).
"""

import argparse
import json
import os
import sys

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", help="root of a checkout holding contextual_image_compression_tpu_torch")
    ap.add_argument("--json", help="also write the lines to this file")
    ap.add_argument("--seeds", type=int, default=0, help="seeds of the error spread")
    args = ap.parse_args()
    root = os.path.realpath(args.checkout)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from contextual_image_compression_tpu_torch.measure import card_name_and_power, device_ms
    from contextual_image_compression_tpu_torch.ops import attention as attn_ops
    from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck

    if not ck.__file__.startswith(root):
        raise RuntimeError(f"imported {ck.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ck.library()
    lines = [{"tree": root, "card": card_name_and_power()}]
    for case in cases(dev):
        lines.append(measure_case(attn_ops, ck, device_ms, *case))
        print(json.dumps(lines[-1]), flush=True)
    lines.append(kernel_times(attn_ops, dev))
    print(json.dumps(lines[-1]), flush=True)
    for family in ("ragged", "tree_times") if args.seeds else ():
        errs = sorted(spread_case(attn_ops, dev, family, seed) for seed in range(args.seeds))
        lines.append({"spread": family, "seeds": args.seeds, "min": errs[0],
                      "median": errs[len(errs) // 2], "max": errs[-1]})
        print(json.dumps(lines[-1]), flush=True)
    print(json.dumps(lines[0]))
    if args.json:
        with open(args.json, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


def cases(dev):
    """(name, x (B, N, C) float32, [wq, bq, wk, bk, wv, bv], gamma) for each case."""
    g = torch.tensor(0.5, device=dev)

    def params(c, gen):
        inner = c // 8
        shapes = [(c, inner), (inner,), (c, inner), (inner,), (c, c), (c,)]
        return [torch.randn(*s, device=dev, generator=gen) * 0.1 for s in shapes]

    for c in (64, 128, 256):
        for n in (100, 1024):
            gen = torch.Generator(device=dev).manual_seed(3 * n + c)
            w = params(c, gen)
            x = torch.randn(2, n, c, device=dev, generator=gen)
            yield f"params_c{c}_n{n}", x, w, g
    act, w = tree_times_input(dev, torch.Generator(device=dev).manual_seed(7))
    yield "tree_times", act.permute(0, 2, 3, 1).reshape(16, 1024, 256), w, g
    gen = torch.Generator(device=dev).manual_seed(5)

    def glorot(fan_in, fan_out):
        lim = (6.0 / (fan_in + fan_out)) ** 0.5
        return (torch.rand(fan_in, fan_out, device=dev, generator=gen) * 2 - 1) * lim

    w = [glorot(256, 32), torch.zeros(32, device=dev), glorot(256, 32),
         torch.zeros(32, device=dev), glorot(256, 256), torch.zeros(256, device=dev)]
    yield "init", torch.randn(2, 1024, 256, device=dev, generator=gen) * 0.5, w, g
    for std in (0.25, 0.5, 1.0, 2.0):
        gen = torch.Generator(device=dev).manual_seed(11)
        w = params(256, gen)
        yield f"scale_{std}", torch.randn(2, 1024, 256, device=dev, generator=gen) * std, w, g


def tree_times_input(dev, gen):
    """scripts/torch_tree_times.py's K7 input and weights, drawn in its order."""
    def r(*shape, scale=0.1):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    act = r(16, 256, 32, 32, scale=0.5)
    w = [r(256, 32), r(32), r(256, 32), r(32), r(256, 256), r(256)]
    return act, w


def kernel_times(attn_ops, dev):
    """Device kernels of one K7a call (contiguous (B, N, C)) and one K7b call
    (the NCHW activation viewed (B, H, W, C)) at the tree_times input."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    act, w = tree_times_input(dev, torch.Generator(device=dev).manual_seed(7))
    g = torch.tensor(0.5, device=dev)
    xf = act.permute(0, 2, 3, 1).reshape(16, 1024, 256).contiguous()
    view = act.permute(0, 2, 3, 1)
    out = {"kernels": {}}
    for name, call in (("K7a", lambda: attn_ops.sagan_block(xf, *w, g)),
                       ("K7b", lambda: attn_ops.sagan_block_spatial(view, *w, g))):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
                times[key] = times.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / 10
        out["kernels"][name] = times
    return out


def spread_case(attn_ops, dev, family, seed):
    """max |kernel - twin| of one seeded input of the family."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.tensor(0.5, device=dev)
    if family == "ragged":
        shapes = [(128, 16), (16,), (128, 16), (16,), (128, 128), (128,)]
        w = [torch.randn(*s, device=dev, generator=gen) * 0.1 for s in shapes]
        x = torch.randn(2, 100, 128, device=dev, generator=gen)
    else:
        act, w = tree_times_input(dev, gen)
        x = act.permute(0, 2, 3, 1).reshape(16, 1024, 256)
    got = attn_ops.sagan_block(x, *w, g)
    return (got - attn_ops.sagan_block_plain(x, *w, g)).abs().max().item()


def reference(x, w, gamma):
    """The block in float64: projections, scores, softmax, gamma * ctx + x."""
    x64 = x.double()
    wq, bq, wk, bk, wv, bv = (t.double() for t in w)
    q, k, v = x64 @ wq + bq, x64 @ wk + bk, x64 @ wv + bv
    s = q @ k.transpose(1, 2)
    out = float(gamma) * (torch.softmax(s, dim=-1) @ v) + x64
    return out, q, k, v, s.abs().max().item()


def scratch_qkv(attn_ops, ck, x, w, gamma):
    """Run the float32 route's two launches on a scratch of our own and read
    Q, K and V (hi + lo) back from it: K2's float32 scratch layout
    (csrc/attention.cuh Tf32Scratch), V^T's keys in fragment order."""
    b, n, c = x.shape
    inner = w[0].shape[1]
    wqkv, bias = attn_ops._pack_qkv_tf32(*w)
    try:  # with room for the sum of e.V segments where the tree has it
        elems = attn_ops._tf32_scratch_elems(b, n, inner, c, with_acc=True)
    except TypeError:
        elems = attn_ops._tf32_scratch_elems(b, n, inner, c)
    scratch = torch.zeros(elems, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    g = gamma.reshape(1).float().contiguous()
    err = ck.library().cic_sagan_block(
        x.data_ptr(), *x.stride(), wqkv.data_ptr(), bias.data_ptr(), g.data_ptr(),
        scratch.data_ptr(), elems, out.data_ptr(), *out.stride(), b, n, c, inner,
        ck.stream_ptr(x.device))
    ck.check(err, "cic_sagan_block")
    dkp = 32 if inner <= 32 else 64
    np_ = -(-n // 32) * 32
    nq, nv = b * n * dkp, b * c * np_
    parts = torch.split(scratch[:4 * nq + 2 * nv], [nq] * 4 + [nv] * 2)
    q = (parts[0] + parts[1]).reshape(b, n, dkp)[..., :inner]
    k = (parts[2] + parts[3]).reshape(b, n, dkp)[..., :inner]
    e = torch.arange(n, device=x.device)
    slot = (e & ~7) + ((e & 7) >> 1) + (((e & 7) & 1) << 2)
    v = (parts[4] + parts[5]).reshape(b, c, np_)[..., slot].transpose(1, 2)
    return out, q, k, v


def measure_case(attn_ops, ck, device_ms, name, x, w, gamma):
    before = dict(attn_ops.sagan_block.route_launches)
    got = attn_ops.sagan_block(x, *w, gamma)
    route = [r for r, n in attn_ops.sagan_block.route_launches.items() if n != before.get(r, 0)]
    twin = attn_ops.sagan_block_plain(x, *w, gamma)
    ref, q64, k64, v64, smax = reference(x, w, gamma)
    torch.cuda.synchronize()
    line = {
        "case": name, "shape": list(x.shape), "x_std": round(x.std().item(), 4),
        "route": route, "max_abs_score": smax,
        "kernel_vs_twin": (got - twin).abs().max().item(),
        "kernel_vs_f64": (got.double() - ref).abs().max().item(),
        "twin_vs_f64": (twin.double() - ref).abs().max().item(),
        "device_ms": device_ms(lambda: attn_ops.sagan_block(x, *w, gamma)),
    }
    # K7b on the NCHW layout of the same input: bitwise K7a's output
    b, n, c = x.shape
    view = x.transpose(1, 2).contiguous().reshape(b, c, n, 1).permute(0, 2, 3, 1)
    got_b = attn_ops.sagan_block_spatial(view, *w, gamma)
    line["k7b_bitwise"] = bool(torch.equal(got_b.reshape(b, n, c), got))
    line["k7b_layout_kept"] = got_b.stride() == view.stride()
    if hasattr(attn_ops, "_pack_qkv_tf32"):
        out, q, k, v = scratch_qkv(attn_ops, ck, x, w, gamma)
        tq = attn_ops._project(x, w[0], w[1])
        tk = attn_ops._project(x, w[2], w[3])
        tv = attn_ops._project(x, w[4], w[5])
        own = float(gamma) * (torch.softmax(q.double() @ k.double().transpose(1, 2), dim=-1)
                              @ v.double()) + x.double()
        line.update({
            "scratch_out_equal": bool(torch.equal(out, got)),
            "kernel_qkv_vs_f64": [(a.double() - r).abs().max().item()
                                  for a, r in ((q, q64), (k, k64), (v, v64))],
            "twin_qkv_vs_f64": [(a.double() - r).abs().max().item()
                                for a, r in ((tq, q64), (tk, k64), (tv, v64))],
            "attention_vs_f64_on_own_qkv": (out.double() - own).abs().max().item(),
        })
    return line


if __name__ == "__main__":
    sys.exit(main())

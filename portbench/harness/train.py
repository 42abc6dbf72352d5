"""Training cells: `GANStepBuilder.train_step` on the port's dataset.

Set-up: `corpus` uint8 images from the seed on the card; their masks by
the program's `prepare_masks`; `CompressionDataset` device-resident with
batches of `batch`; the train state from `GANStepBuilder.init_state`,
loaded with the seed's codec and D weights (and VGG19's, with the
perceptual loss). The state then takes its first `setup_steps` steps
through the window's own call, D on every `d_every_n_steps`-th step of an
epoch as `GANTrainer.fit` schedules it; the first three are what the
reference follows: their losses, the first step's raw gradients (read as
each optimizer receives them) and the change of every leaf after three
steps. Window: steps until `--seconds` have passed, then a synchronize.

End-to-end: train_img_per_s (images of every step in the window / the
window's seconds).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import check, inputs, trace
from portbench.harness.common import log
from portbench.harness.serve import model_config
from portbench.reference import codec as ref_codec
from portbench.reference import masks as ref_masks
from portbench.reference import train as ref_train
from portbench.reference.precision import FLOAT32

FOLLOWED = 3  # steps the reference follows


def dataset_seed(seed: int) -> int:
    return int(seed) % (1 << 32)


def train_config(spec: dict, traffic: dict):
    from contextual_image_compression_tpu_torch.config import LossConfig, TrainConfig

    mcfg, scfg = model_config(spec)
    t = spec["train"]
    loss = LossConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in t["loss"].items()})
    return TrainConfig(model=mcfg, loss=loss, saliency=scfg, batch_size=t["batch_size"],
                       learning_rate=t["learning_rate"], ls_lr_scale=t["ls_lr_scale"],
                       rd_lr_scale=t["rd_lr_scale"], clipnorm=t["clipnorm"],
                       adam_b1=t["adam_b1"], adam_b2=t["adam_b2"], adam_eps=t["adam_eps"],
                       bpp_range=tuple(t["bpp_range"]), d_every_n_steps=t["d_every_n_steps"],
                       use_perceptual=traffic["use_perceptual"])


def seed_weights(spec: dict, traffic: dict, seed: int, dev):
    m = spec["model"]
    codec = inputs.make_weights(ref_codec.codec_shapes(m), seed, "codec", dev)
    disc = inputs.make_weights(ref_train.disc_shapes(m), seed, "disc", dev)
    vgg = (inputs.make_weights(ref_train.vgg_shapes(), seed, "vgg", dev, vgg=True)
           if traffic["use_perceptual"] else None)
    return codec, disc, vgg


class Schedule:
    """Batches of the dataset's epochs, and whether D trains on each."""

    def __init__(self, dataset, d_every: int):
        self.dataset, self.d_every = dataset, d_every
        self.it, self.k = dataset.epoch(), 0

    def next(self):
        if self.k == self.dataset.steps_per_epoch:
            self.it, self.k = self.dataset.epoch(), 0
        batch = next(self.it)
        do_d = self.k % self.d_every == 0
        self.k += 1
        return batch, do_d


def _names(state) -> Dict[int, str]:
    names = {id(p): n for n, p in state.codec.named_parameters()}
    names.update({id(p): "disc." + n for n, p in state.disc.named_parameters()})
    return names


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tensors)
    if not keys:
        return {}
    norms = torch.stack([n.float() for n in torch._foreach_norm([tensors[k] for k in keys])])
    return dict(zip(keys, norms.cpu().tolist()))


def capture_first_gradients(state, sink: Dict[str, float]):
    """Wrap each optimizer's step to record the raw gradient norms it
    receives; returns the function that removes the wrappers."""
    names = _names(state)
    opts = (state.g_opt, state.ls_opt, state.rd_opt, state.d_opt)

    saved = [(opt, vars(opt).get("step")) for opt in opts]

    def wrap(opt):
        orig = opt.step

        def step():
            sink.update(_leaf_norms({names[id(p)]: (p.grad if p.grad is not None
                                                    else torch.zeros_like(p))
                                     for p in opt.params}))
            return orig()

        opt.step = step

    for opt in opts:
        wrap(opt)

    def undo():
        for opt, own in saved:
            if own is None:
                del opt.step
            else:
                opt.step = own

    return undo


def program_changes(state, codec0: dict, disc0: dict) -> Dict[str, float]:
    now = {k: v for k, v in state.codec.state_dict().items()}
    now.update({"disc." + k: v for k, v in state.disc.state_dict().items()})
    start = dict(codec0)
    start.update({"disc." + k: v for k, v in disc0.items()})
    return _leaf_norms({k: now[k].float() - start[k] for k in start})


def run(ctx, fault=None) -> dict:
    """fault: None, or a function (builder, state) -> None that breaks the
    timed path (harness/faults.py)."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset,
        prepare_masks,
    )
    from contextual_image_compression_tpu_torch.models.vgg import VGG19Features
    from contextual_image_compression_tpu_torch.train.gan_trainer import GANStepBuilder

    spec, traffic, dev = ctx.cell["config_spec"], ctx.cell["traffic_spec"], ctx.device
    torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]
    torch.backends.cudnn.allow_tf32 = spec["tf32"]
    m, t = spec["model"], spec["train"]
    tcfg = train_config(spec, traffic)
    b = t["batch_size"]

    ctx.phase("imports")
    images = inputs.structured_images(ctx.seed, traffic["corpus"], m["img_size"][0], dev)
    images_np = images.cpu().numpy()
    masks = prepare_masks(images_np, tcfg.saliency, device=dev)
    ctx.phase("images and masks")
    floats = (images.float() / 127.5 - 1.0).cpu().numpy()
    del images
    dataset = CompressionDataset(floats, masks, batch_size=b, bpp_range=tcfg.bpp_range,
                                 seed=dataset_seed(ctx.seed), device_resident=True, device=dev)
    codec0, disc0, vgg_sd = seed_weights(spec, traffic, ctx.seed, dev)
    ctx.sync()
    ctx.phase("weights")
    vgg = None
    if vgg_sd is not None:
        with torch.device(dev):
            vgg = VGG19Features()
        vgg.load_state_dict(vgg_sd)
        vgg.requires_grad_(False)
        del vgg_sd
    builder = GANStepBuilder(tcfg, vgg=vgg, device=dev)
    ctx.sync()
    ctx.phase("VGG19")
    state = builder.init_state(0)
    ctx.sync()
    ctx.phase("init_state")
    state.codec.load_state_dict(codec0)
    state.disc.load_state_dict(disc0)
    ctx.phase("train state")
    if fault is not None:
        fault(builder, state)

    sched = Schedule(dataset, t["d_every_n_steps"])
    got = {"losses": [], "grads": {}, "changes": {}}
    undo = capture_first_gradients(state, got["grads"])
    for step in range(max(traffic["setup_steps"], FOLLOWED)):
        batch, do_d = sched.next()
        state, metrics = builder.train_step(state, batch, do_d)
        if step == 0:
            undo()
        if step < FOLLOWED:
            got["losses"].append({k: float(v) for k, v in metrics.items()})
        if step == FOLLOWED - 1:
            got["changes"] = program_changes(state, codec0, disc0)
            del codec0, disc0
        ctx.sync()
        ctx.phase(f"step {step}")
    ctx.mark_setup_done()

    # ---- the window
    ops.reset_launch_counts()
    n = n_d = 0
    t_start = time.perf_counter()
    while True:
        batch, do_d = sched.next()
        state, _ = builder.train_step(state, batch, do_d)
        n += 1
        n_d += do_d
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t_start
    log(f"launches per step: { {k: v / n for k, v in ops.launch_counts().items() if v} }")
    log(f"window: {n} steps ({n_d} with D) of {b} in {window_s:.3f} s")
    e2e = {"train_img_per_s": {"value": n * b / window_s, "unit": "images/s"}}

    summary = None
    if ctx.trace:
        summary = _traced_tail(ctx, builder, state, sched, traffic, spec)
        summary["untraced"] = {"steps": n, "steps_with_d": n_d, "seconds": window_s,
                               "images": n * b}
    ctx.read_memory_peak()
    del builder, state, dataset, vgg, sched
    ctx.free()
    want = reference_steps(spec, traffic, ctx.seed, dev)
    details: dict = {}
    checks = check.training_gaps(got, want, details)
    return {"attempted": n, "failed": 0, "end_to_end": e2e, "summary": summary,
            "checks": checks, "details": details}


def _traced_tail(ctx, builder, state, sched, traffic, spec) -> dict:
    r = trace.Ranges()
    r.method(builder, "train_step", "train.step")
    r.method(builder, "codec_forward", "train.codec_forward")
    r.method(builder, "d_phase", "train.d_phase")
    r.method(builder, "g_backward", "train.g_backward")
    r.method(builder, "g_update", "train.g_update")
    r.module(state.codec.hq_encoder.attention, "hq_attention")
    n_d = 0

    def tail():
        nonlocal n_d
        for _ in range(traffic["trace_steps"]):
            batch, do_d = sched.next()
            builder.train_step(state, batch, do_d)
            n_d += do_d

    try:
        summary = trace.profile(tail, r)
    finally:
        r.close()
    m, b = spec["model"], spec["train"]["batch_size"]
    work = ctx.work
    flops, nbytes = work.attention(m, b)
    perc = traffic["use_perceptual"]
    summary["work"] = {"step_flops_d": work.step_flops(m, b, True, perc),
                       "step_flops_no_d": work.step_flops(m, b, False, perc),
                       "attention_flops": flops, "attention_bytes": nbytes,
                       "peak_flops": spec["peak_flops"],
                       "peak_bytes_per_s": spec["peak_bytes_per_s"]}
    return summary


def reference_batches(spec: dict, traffic: dict, seed: int, dev, steps: int = FOLLOWED):
    """The first `steps` batches as the dataset draws them from
    RandomState(seed) (each epoch a shuffle, then a target bpp a sample a
    batch), with whether D trains on each and the reference's masks."""
    t, m = spec["train"], spec["model"]
    b, n = t["batch_size"], traffic["corpus"]
    per_epoch = max(1, n // b)
    rng = np.random.RandomState(dataset_seed(seed))
    images = inputs.structured_images(seed, n, m["img_size"][0], dev)
    out = []
    for s in range(steps):
        k = s % per_epoch
        if k == 0:
            idx = np.arange(n)
            rng.shuffle(idx)
        sel = torch.from_numpy(idx[k * b:(k + 1) * b]).to(dev)
        bpp = rng.choice(t["bpp_range"], size=(b, 1)).astype(np.float32)
        u8 = images.index_select(0, sel)
        mask = ref_masks.contextual_mask(u8, spec["saliency"])[:, None]
        img = (u8.float() / 127.5 - 1.0).permute(0, 3, 1, 2).contiguous()
        out.append((img, mask, torch.from_numpy(bpp).to(dev), k % t["d_every_n_steps"] == 0))
    return out


def reference_steps(spec: dict, traffic: dict, seed: int, dev, rnd=FLOAT32) -> dict:
    """The reference's first three steps from the seed's weights: losses,
    the first raw gradients' norms, each leaf's change."""
    codec0, disc0, vgg = seed_weights(spec, traffic, seed, dev)
    tr = ref_train.Trainer(codec0, disc0, vgg, spec["model"], spec["train"], rnd)
    losses: List[Dict[str, float]] = []
    grads: Dict[str, float] = {}
    for s, (img, mask, bpp, do_d) in enumerate(reference_batches(spec, traffic, seed, dev)):
        lo, g = tr.step(img, mask, bpp, do_d, traffic["use_perceptual"])
        losses.append(lo)
        if s == 0:
            grads = _leaf_norms(g)
            for name in tr.g_opt.names + tr.ls_opt.names + tr.rd_opt.names:
                grads.setdefault(name, 0.0)
            for name in tr.d_opt.names:
                grads.setdefault("disc." + name, 0.0)
    start = dict(codec0)
    start.update({"disc." + k: v for k, v in disc0.items()})
    now = dict(tr.p)
    now.update({"disc." + k: v for k, v in tr.d.items()})
    changes = _leaf_norms({k: now[k] - start[k] for k in start})
    return {"losses": losses, "grads": grads, "changes": changes}

"""Faults planted under the timed path, each of which the check must see
(`correct` false): the tests of portbench/tests run every one at a tiny
size, and `calibrate.py` reads them at a cell's own size.

Serving (applied to the pipeline):
  * answer_altered: the first image of every call decoded inverted and its
    first symbol moved by one, where `_run` produces them;
  * half_batch: `_run` computes the first half of each batch and repeats it
    for the rest.
Training (applied to the step builder and its state):
  * state_unchanged: the optimizers step nothing and the BatchNorm
    statistics are not committed;
  * half_batch: every step takes the first half of its batch, the means
    over the rest;
  * answer_altered: one leaf's gradient doubled where the backward leaves
    it, before the optimizer reads it.
"""

from __future__ import annotations

import torch


def serve_answer_altered(pipe) -> None:
    run = pipe._run

    def altered(imgs, bpp):
        decoded, info = run(imgs, bpp)
        decoded = decoded.clone()
        decoded[0] = 255 - decoded[0]
        info = dict(info)
        info["hq_symbols"] = info["hq_symbols"].clone()
        info["hq_symbols"][0, 0] += 1.0
        return decoded, info

    pipe._run = altered


def serve_half_batch(pipe) -> None:
    run = pipe._run

    def half(imgs, bpp):
        h = max(1, imgs.shape[0] // 2)
        decoded, info = run(imgs[:h], bpp[:h])
        reps = -(-imgs.shape[0] // h)

        def fill(t):
            return t.repeat((reps,) + (1,) * (t.ndim - 1))[:imgs.shape[0]]

        return fill(decoded), {k: fill(v) for k, v in info.items()}

    pipe._run = half


def train_state_unchanged(builder, state) -> None:
    for opt in (state.g_opt, state.ls_opt, state.rd_opt, state.d_opt):
        opt.step = lambda: None
    builder.g_update = lambda st: None


def train_half_batch(builder, state) -> None:
    step = builder.train_step

    def half(st, batch, do_d):
        h = max(1, batch.image.shape[0] // 2)
        return step(st, type(batch)(batch.image[:h], batch.mask[:h], batch.bpp[:h]), do_d)

    builder.train_step = half


def train_answer_altered(builder, state) -> None:
    update = builder.g_update
    leaf = next(p for n, p in state.codec.named_parameters() if n.endswith("conv2.weight"))

    def altered(st):
        if leaf.grad is not None:
            with torch.no_grad():
                leaf.grad.mul_(2.0)
        return update(st)

    builder.g_update = altered


SERVE = {"answer_altered": serve_answer_altered, "half_batch": serve_half_batch}
TRAIN = {"state_unchanged": train_state_unchanged, "half_batch": train_half_batch,
         "answer_altered": train_answer_altered}

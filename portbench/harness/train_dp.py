"""Data-parallel training cells: `GANStepBuilder.train_step` on a (world, 1)
mesh over torch.distributed, one process a card.

Rank 0 is the run's own process. It builds the kernel library (the other
ranks then find it built), picks a free localhost port, writes the cell to
a temporary file and starts ranks 1 .. world - 1 as `python3 -m
portbench.harness.train_dp`, each logging to a file beside it. Every rank
joins the process group through parallel/mesh.py's `initialize_multihost`
(NCCL where each rank has a card of its own; gloo where ranks share a card
or run on the CPU) and builds a (world, 1) mesh. Every rank makes the same
corpus, masks, weights and dataset from the seed, at the global batch
(`per_rank` x world); `place_batch` takes its slice, `place` its replica
of the state, and each step sums the gradients over the mesh
(`step.allreduce`), so the step is JAX's SPMD step on the global batch.

Set-up, window and traced tail are train.py's, with D on every
`d_every_n_steps`-th step. The window's length is rank 0's: after each step
rank 0 broadcasts over a gloo group whether `--seconds` have passed, a flag
on the host that leaves the card unsynchronized, and every rank stops after
the same step, then synchronizes. Rank 0 alone traces its tail, with
train.py's ranges and the program's spans; the others run the same steps
untraced.

End-to-end: train_img_per_s, the global images of the window's steps over
rank 0's window seconds.

The check is rank 0's, after the others have left the group: the
reference's first three steps on the global batch (train.reference_steps,
one card, float32) against rank 0's losses, the first gradients as its
optimizers receive them (summed over the mesh) and each leaf's change
after three steps, under train.py's numbers and limits.

A watchdog thread bounds every rank: rank 0 exits with code 5 when a rank
it started has failed, a started rank when rank 0 has gone, and any rank
with code 6 when the process group has not formed within the traffic's
`init_timeout_s`, so a failed NCCL start ends the run instead of hanging it.

Faults (`FAULTS`, named to `run` and planted on every rank), each of
which the check must see:
  * no_allreduce: `_reduce` sums nothing, so every rank steps on its own
    slice's gradients;
  * slice_lost: the last rank trains on rank 0's slice of each batch, so
    the global batch loses the last rank's slice and counts rank 0's
    twice.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

from portbench.harness import check, common, inputs, trace, train
from portbench.harness.common import log

POLL_S = 0.5


def global_spec(cell: dict) -> dict:
    """The configuration with the global batch, per_rank x world."""
    spec = copy.deepcopy(cell["config_spec"])
    t = cell["traffic_spec"]
    spec["train"]["batch_size"] = t["per_rank"] * t["world"]
    return spec


class Watchdog:
    """Ends the process (os._exit) when a peer fails or the process group
    has not formed in time; `formed()` and `stop()` disarm it."""

    def __init__(self, init_timeout_s: float, children=(), parent_pid: Optional[int] = None):
        self.children, self.parent_pid = list(children), parent_pid
        self.deadline = time.monotonic() + init_timeout_s
        self._formed = threading.Event()
        self._stop = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def formed(self) -> None:
        self._formed.set()

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        while not self._stop.wait(POLL_S):
            for rank, proc, logfile in self.children:
                if proc.poll() not in (None, 0):
                    log(f"train_dp: rank {rank} exited with {proc.returncode}:\n"
                        + _tail(logfile))
                    os._exit(5)
            if self.parent_pid is not None and os.getppid() != self.parent_pid:
                log("train_dp: rank 0 has gone")
                os._exit(5)
            if not self._formed.is_set() and time.monotonic() > self.deadline:
                log("train_dp: the process group did not form in time")
                os._exit(6)


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError as e:
        return f"(no log: {e})"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def no_allreduce(builder, rank: int, world: int) -> None:
    builder._reduce = lambda module: None


def slice_lost(builder, rank: int, world: int) -> None:
    if rank != world - 1:
        return

    def rank0_slice(batch):
        n = batch.image.shape[0] // world
        return type(batch)(batch.image[:n], batch.mask[:n], batch.bpp[:n])

    builder.place_batch = rank0_slice


FAULTS = {"no_allreduce": no_allreduce, "slice_lost": slice_lost}


def run(ctx, backend: Optional[str] = None, devices: Optional[List[str]] = None,
        fault: Optional[str] = None) -> dict:
    """Rank 0. backend: default NCCL when every rank has a card of its own,
    else gloo. devices: each rank's device (default cuda:<rank>, or the
    CPU for a CPU run). fault: None, or a name in FAULTS, planted on every
    rank."""
    traffic = ctx.cell["traffic_spec"]
    world = traffic["world"]
    if devices is None:
        devices = [f"cuda:{r}" if ctx.device.type == "cuda" else "cpu" for r in range(world)]
    if backend is None:
        distinct = len(set(devices)) == world and ctx.device.type == "cuda"
        backend = "nccl" if distinct else "gloo"
    if ctx.device.type == "cuda":
        from contextual_image_compression_tpu_torch.ops import cuda_kernels

        cuda_kernels.build()
        ctx.phase("kernel library")
    port = _free_port()
    tmp = Path(tempfile.mkdtemp(prefix="train_dp-"))
    cell_path = tmp / "cell.json"
    cell_path.write_text(json.dumps(ctx.cell))
    children = []
    try:
        for rank in range(1, world):
            logfile = tmp / f"rank{rank}.log"
            with open(logfile, "w") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "portbench.harness.train_dp", "--cell", str(cell_path),
                     "--seed", str(ctx.seed), "--seconds", str(ctx.seconds),
                     "--trace", str(int(ctx.trace)), "--rank", str(rank), "--world", str(world),
                     "--device", devices[rank], "--backend", backend, "--port", str(port),
                     "--parent", str(os.getpid())] + (["--fault", fault] if fault else []),
                    cwd=str(common.ROOT), stdout=out, stderr=subprocess.STDOUT)
            children.append((rank, proc, logfile))
        dog = Watchdog(traffic["init_timeout_s"], children)
        res = rank_main(ctx, 0, world, devices[0], backend, port, dog, fault)
        dog.stop()
        for rank, proc, logfile in children:
            if proc.wait(timeout=traffic["init_timeout_s"]) != 0:
                raise common.RunError(f"rank {rank} exited with {proc.returncode}:\n"
                                      + _tail(logfile))
        return res
    finally:
        for _, proc, _ in children:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def rank_main(ctx, rank: int, world: int, device: str, backend: str, port: int,
              dog: Watchdog, fault: Optional[str] = None) -> Optional[dict]:
    """One rank's run; rank 0 returns the driver's result, the others
    None."""
    import torch.distributed as dist

    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset,
        prepare_masks,
    )
    from contextual_image_compression_tpu_torch.models.vgg import VGG19Features
    from contextual_image_compression_tpu_torch.parallel.mesh import (
        create_mesh,
        initialize_multihost,
    )
    from contextual_image_compression_tpu_torch.train.gan_trainer import GANStepBuilder

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    local = dev.index if backend == "nccl" else None
    initialize_multihost(f"tcp://localhost:{port}", world, rank, local, backend=backend)
    mesh = create_mesh(1, device=dev)
    ctl = dist.new_group(backend="gloo")
    dist.barrier(group=ctl)
    dog.formed()
    ctx.phase("process group")

    cell, traffic = ctx.cell, ctx.cell["traffic_spec"]
    spec = global_spec(cell)
    torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]
    torch.backends.cudnn.allow_tf32 = spec["tf32"]
    m, t = spec["model"], spec["train"]
    tcfg = train.train_config(spec, traffic)
    b = t["batch_size"]

    images = inputs.structured_images(ctx.seed, traffic["corpus"], m["img_size"][0], dev)
    masks = prepare_masks(images.cpu().numpy(), tcfg.saliency, device=dev)
    floats = (images.float() / 127.5 - 1.0).cpu().numpy()
    del images
    dataset = CompressionDataset(floats, masks, batch_size=b, bpp_range=tcfg.bpp_range,
                                 seed=train.dataset_seed(ctx.seed), device_resident=True,
                                 device=dev)
    codec0, disc0, vgg_sd = train.seed_weights(spec, traffic, ctx.seed, dev)
    vgg = None
    if vgg_sd is not None:
        with torch.device(dev):
            vgg = VGG19Features()
        vgg.load_state_dict(vgg_sd)
        vgg.requires_grad_(False)
        del vgg_sd
    builder = GANStepBuilder(tcfg, vgg=vgg, mesh=mesh)
    state = builder.init_state(0)
    state.codec.load_state_dict(codec0)
    state.disc.load_state_dict(disc0)
    builder.place(state)
    if fault is not None:
        FAULTS[fault](builder, rank, world)
    ctx.sync()
    ctx.phase("train state")

    sched = train.Schedule(dataset, t["d_every_n_steps"])

    def step():
        batch, do_d = sched.next()
        _, metrics = builder.train_step(state, builder.place_batch(batch), do_d)
        return metrics, do_d

    got = {"losses": [], "grads": {}, "changes": {}}
    undo = train.capture_first_gradients(state, got["grads"])
    for i in range(max(traffic["setup_steps"], train.FOLLOWED)):
        metrics, _ = step()
        if i == 0:
            undo()
        if i < train.FOLLOWED:
            got["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == train.FOLLOWED - 1:
            got["changes"] = train.program_changes(state, codec0, disc0)
            del codec0, disc0
        ctx.sync()
        ctx.phase(f"step {i}")
    ctx.mark_setup_done()

    # ---- the window
    ops.reset_launch_counts()
    stop = torch.zeros(1, dtype=torch.int32)
    n = n_d = 0
    t_start = time.perf_counter()
    while True:
        _, do_d = step()
        n += 1
        n_d += do_d
        if rank == 0:
            stop[0] = int(time.perf_counter() - t_start >= ctx.seconds)
        dist.broadcast(stop, src=0, group=ctl)
        if stop[0]:
            break
    ctx.sync()
    window_s = time.perf_counter() - t_start
    log(f"rank {rank}: window: {n} steps ({n_d} with D) of {b} in {window_s:.3f} s")
    e2e = {"train_img_per_s": {"value": n * b / window_s, "unit": "images/s"}}

    summary = None
    if ctx.trace:
        if rank == 0:
            summary = _traced_tail(ctx, builder, state, step, traffic, spec, world)
            summary["untraced"] = {"steps": n, "steps_with_d": n_d, "seconds": window_s,
                                   "images": n * b}
        else:
            for _ in range(traffic["trace_steps"]):
                step()
            ctx.sync()
    ctx.read_memory_peak()
    del builder, state, dataset, vgg, sched
    dist.barrier(group=ctl)
    dist.destroy_process_group()
    dog.stop()
    if rank != 0:
        return None
    ctx.free()
    want = train.reference_steps(spec, traffic, ctx.seed, dev)
    details: dict = {}
    checks = check.training_gaps(got, want, details)
    return {"attempted": n, "failed": 0, "end_to_end": e2e, "summary": summary,
            "checks": checks, "details": details}


def _traced_tail(ctx, builder, state, step, traffic, spec, world) -> dict:
    from contextual_image_compression_tpu_torch.utils import profiling

    r = trace.Ranges()
    r.names.update(getattr(profiling, "SPANS", ()))
    r.method(builder, "train_step", "train.step")
    r.method(builder, "codec_forward", "train.codec_forward")
    r.method(builder, "d_phase", "train.d_phase")
    r.method(builder, "g_backward", "train.g_backward")
    r.method(builder, "g_update", "train.g_update")
    r.module(state.codec.hq_encoder.attention, "hq_attention")

    def tail():
        for _ in range(traffic["trace_steps"]):
            step()

    try:
        summary = trace.profile(tail, r)
    finally:
        r.close()
    m, per_rank = spec["model"], traffic["per_rank"]
    work, perc = ctx.work, traffic["use_perceptual"]
    flops, nbytes = work.attention(m, per_rank)
    summary["work"] = {"step_flops_d": world * work.step_flops(m, per_rank, True, perc),
                       "step_flops_no_d": world * work.step_flops(m, per_rank, False, perc),
                       "peak_flops": world * spec["peak_flops"],
                       "attention_flops": flops, "attention_bytes": nbytes,
                       "card_peak_flops": spec["peak_flops"],
                       "peak_bytes_per_s": spec["peak_bytes_per_s"]}
    return summary


def main() -> int:
    """A started rank (1 .. world - 1)."""
    p = argparse.ArgumentParser(description="one rank of a train_dp cell")
    for name, kind in (("cell", str), ("seed", int), ("seconds", float), ("trace", int),
                       ("rank", int), ("world", int), ("device", str), ("backend", str),
                       ("port", int), ("parent", int)):
        p.add_argument(f"--{name}", type=kind, required=True)
    p.add_argument("--fault", choices=sorted(FAULTS))
    a = p.parse_args()
    common.set_cache_dirs()
    from portbench.harness import runner

    cell = json.loads(Path(a.cell).read_text())
    dog = Watchdog(cell["traffic_spec"]["init_timeout_s"], parent_pid=a.parent)
    ctx = runner.Context(cell, a.seed, a.seconds, bool(a.trace), a.device, time.perf_counter())
    rank_main(ctx, a.rank, a.world, a.device, a.backend, a.port, dog, a.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())

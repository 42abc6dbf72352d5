#!/usr/bin/env python
"""Per-world-size SPMD record of the port's GAN train step (the port's
counterpart of scripts/mesh_scaling.py).

For each world size W it starts W gloo ranks (one process each) on the CPU,
or all on one card with --device cuda, builds a (W / M, M) mesh, places the
same seeded train state and global batch on it and takes --steps steps with
D. What this CAN and CANNOT show:

  * CAN: that the step gives the SAME losses at every world size (the
    global-batch step, computed with explicit collectives), and that the
    batch and the split leaves are sharded: each rank holds 1 / D of the
    batch and 1 / M of the leaves the rule splits (shapes recorded).
  * CANNOT: a speedup. The ranks share the host's cores (or one card, the
    collectives going through the host), so the work per step does not
    shrink and collectives only add; the step time is a record of that cost.

Writes runs/mesh_scaling_torch.json (never JAX's runs/mesh_scaling.json) and
prints it.

Usage: python scripts/torch_mesh_scaling.py [--world-sizes 1,2,4] [--steps 3]
       [--model-parallel 1] [--device cpu|cuda]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _config(args):
    from contextual_image_compression_tpu_torch.config import ModelConfig, TrainConfig

    mcfg = ModelConfig(img_size=(args.img_size, args.img_size), base_latent_dim=args.latent,
                       encoder_channels=(8, 16, 24, 32), generator_channels=(24, 16, 8, 8),
                       generator_base_hw=args.img_size // 16, generator_base_ch=32)
    return TrainConfig(model=mcfg, batch_size=args.global_batch, use_perceptual=False)


def rank_main(args):
    """One rank: the step on the mesh; rank 0 writes its record."""
    import numpy as np
    import torch

    from contextual_image_compression_tpu_torch.parallel import (
        create_mesh, initialize_multihost, sharding)
    from contextual_image_compression_tpu_torch.train.gan_trainer import Batch, GANStepBuilder

    torch.set_num_threads(1)
    dev = "cuda:0" if args.device == "cuda" else "cpu"
    initialize_multihost(f"file://{args.rdzv}", args.world, args.rank, local_rank=0,
                         backend="gloo")
    mesh = create_mesh(args.model_parallel, device=dev)
    cfg = _config(args)
    rng = np.random.RandomState(0)
    n, s = args.global_batch, args.img_size
    batch = Batch(torch.from_numpy(rng.rand(n, 3, s, s).astype(np.float32) * 2 - 1).to(dev),
                  torch.from_numpy(rng.rand(n, 1, s, s).astype(np.float32)).to(dev),
                  torch.from_numpy(rng.choice([0.1, 1.0, 2.0], (n, 1)).astype(np.float32)).to(dev))
    builder = GANStepBuilder(cfg, bn_mode="frozen", device=dev, mesh=mesh)
    state = builder.place(builder.init_state(0), args.min_shard_elems)
    local = builder.place_batch(batch)
    builder.train_step(state, local, True)  # warm-up
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        _, metrics = builder.train_step(state, local, True)
    losses = {k: float(v) for k, v in metrics.items()}
    dt = (time.perf_counter() - t0) / args.steps
    if args.rank == 0:
        Path(args.record).write_text(json.dumps({
            "mesh": mesh.shape,
            "step_time_s": dt,
            "per_rank_batch_shard": list(local.image.shape),
            "split_leaves": {k: [list(full), list(mine)] for k, (full, mine) in
                             sharding.sharded_shapes(state.codec).items()},
            "losses": losses}))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--world-sizes", default="1,2,4")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--min-shard-elems", type=int, default=1 << 20)
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--img-size", type=int, default=32)
    p.add_argument("--latent", type=int, default=64)
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--out", default=str(ROOT / "runs" / "mesh_scaling_torch.json"))
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    p.add_argument("--record", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return 0
    if os.path.abspath(args.out) == str(ROOT / "runs" / "mesh_scaling.json"):
        raise SystemExit("runs/mesh_scaling.json is the JAX script's record")
    if args.device == "cuda":
        from contextual_image_compression_tpu_torch.ops import cuda_kernels

        cuda_kernels.build()  # once, before the ranks load it
    results = {"global_batch": args.global_batch, "img_size": args.img_size,
               "steps": args.steps, "model_parallel": args.model_parallel,
               "device": args.device, "per_world_size": {}}
    base = None
    with tempfile.TemporaryDirectory() as tmp:
        for world in (int(w) for w in args.world_sizes.split(",")):
            record = os.path.join(tmp, f"record_{world}.json")
            cmd = [sys.executable, os.path.abspath(__file__), *(argv or sys.argv[1:]),
                   "--world", str(world), "--rdzv", os.path.join(tmp, f"rdzv_{world}"),
                   "--record", record]
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env) for r in range(world)]
            try:
                codes = [q.wait(timeout=1800) for q in procs]
            finally:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
            if any(codes):
                raise SystemExit(f"world size {world}: ranks exited {codes}")
            rec = json.loads(Path(record).read_text())
            results["per_world_size"][str(world)] = rec
            shard = rec["per_rank_batch_shard"][0]
            if shard != args.global_batch // rec["mesh"]["data"]:
                raise SystemExit(f"batch axis not sharded 1/D at world size {world}: {shard}")
            print(f"world size {world} {rec['mesh']}: {rec['step_time_s'] * 1e3:.1f} ms/step, "
                  f"per-rank shard {rec['per_rank_batch_shard']}", file=sys.stderr, flush=True)
            base = base or rec["losses"]
            for k, v in rec["losses"].items():
                if abs(v - base[k]) > 1e-4 + 1e-3 * abs(base[k]):
                    raise SystemExit(f"world size {world}: {k} {v} against {base[k]}")
    results["spmd_loss_equivalence"] = "losses match across world sizes " + args.world_sizes
    results["note"] = ("the ranks share the host's cores (or one card, the collectives through "
                       "the host): step time records the collectives' cost, not scaling; see the "
                       "module docstring")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

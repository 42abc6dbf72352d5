"""Rank processes for the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_sharded_train.py): gloo over file:// on the CPU, one thread
a rank, the port's plain kernel versions.

    python tests/torch_mesh_worker.py SCENARIO RANK WORLD DIR

runs SCENARIO(rank, world, dir) and writes what it returns to
DIR/SCENARIO_RANK.pt (torch.save); a failing rank writes its traceback to
DIR/SCENARIO_RANK.err and exits 1. `spawn` starts WORLD ranks and waits.
The parent writes a scenario's inputs (weights, batches) into DIR first.
Each rank splits leaves from SMALL_SHARD elements
(sharding.DEFAULT_MIN_SHARD_ELEMS), so the model axis engages on the tiny
model.
"""

from __future__ import annotations

import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from contextual_image_compression_tpu_torch.config import (  # noqa: E402
    AutoencoderConfig,
    EvalConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)

TINY = ModelConfig(img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
                   generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32)
SMALL_SHARD = 1 << 12  # low threshold so the model axis engages on the tiny model
LR = 1e-4


def spawn(scenario: str, world: int, directory, timeout: float = 300.0):
    """Run `scenario` on `world` ranks; returns [result of each rank]."""
    directory = Path(directory)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, scenario, str(r), str(world),
                               str(directory)], env=env, cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        err = directory / f"{scenario}_{r}.err"
        detail = err.read_text() if err.exists() else out
        assert p.returncode == 0, f"{scenario} rank {r} failed:\n{detail}\n{out[-4000:]}"
    return [torch.load(directory / f"{scenario}_{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------------ helpers


def _mesh(model_parallel, directory, multihost=False, nodes=None):
    """create_mesh on the CPU; `nodes`: the node of each rank, standing in
    for the host names (a rehearsal of several nodes in one host)."""
    import contextual_image_compression_tpu_torch.parallel.mesh as mesh_module

    if nodes is None:
        return mesh_module.create_mesh(model_parallel, multihost, device="cpu")
    host_names = mesh_module._node_keys
    mesh_module._node_keys = lambda world: list(nodes)
    try:
        return mesh_module.create_mesh(model_parallel, multihost, device="cpu")
    finally:
        mesh_module._node_keys = host_names


def _batch(directory):
    from contextual_image_compression_tpu_torch.train.gan_trainer import Batch

    d = np.load(directory / "batch.npz")
    return Batch(torch.from_numpy(d["image"]).permute(0, 3, 1, 2).contiguous(),
                 torch.from_numpy(d["mask"]).permute(0, 3, 1, 2).contiguous(),
                 torch.from_numpy(d["bpp"]))


def train_state(cfg: TrainConfig, directory, bn_mode="train", mesh=None):
    """A seeded GAN state on the CPU with the weights the parent stored, and
    its builder (on `mesh` when given; the random VGG19 of cfg when it uses
    the perceptual term)."""
    from contextual_image_compression_tpu_torch.models.vgg import load_vgg19_features
    from contextual_image_compression_tpu_torch.train.gan_trainer import GANStepBuilder

    vgg = load_vgg19_features(cfg.vgg_weights_path, "cpu") if cfg.use_perceptual else None
    builder = GANStepBuilder(cfg, vgg=vgg, bn_mode=bn_mode, device="cpu", mesh=mesh)
    state = builder.init_state(0)
    weights = torch.load(Path(directory) / "weights.pt")
    state.codec.load_state_dict(weights["codec"])
    state.disc.load_state_dict(weights["disc"])
    return builder, state


STEP_CASES = ("plain", "quirk", "perceptual")


def step_cfg(case: str) -> TrainConfig:
    """'plain': the default losses without the perceptual term; 'quirk': the
    broadcast quirk's (B, B) terms; 'perceptual': the perceptual term on a
    random VGG19 (its z-scores' global moments)."""
    return TrainConfig(model=TINY, batch_size=8, use_perceptual=case == "perceptual",
                       vgg_weights_path="random:0", learning_rate=LR,
                       loss=LossConfig(reference_broadcast_quirk=case == "quirk"))


def _step_on_mesh(directory, mesh, case):
    from contextual_image_compression_tpu_torch.parallel import sharding

    builder, state = train_state(step_cfg(case), directory, mesh=mesh)
    builder.place(state)
    shapes = sharding.sharded_shapes(state.codec)
    _, metrics = builder.train_step(state, builder.place_batch(_batch(directory)), True)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "codec": sharding.full_state_dict(state.codec),
            "disc": sharding.full_state_dict(state.disc), "sharded": shapes}


# ---------------------------------------------------------------- scenarios


def step(rank, world, directory):
    """One D-step on a (2, 2) mesh for each of STEP_CASES."""
    mesh = _mesh(2, directory)
    return {"mesh": (dict(mesh.shape), mesh.data_index, mesh.model_index),
            **{case: _step_on_mesh(directory, mesh, case) for case in STEP_CASES}}


def mesh(rank, world, directory):
    """create_mesh's shapes, groups and errors on 4 ranks, then serving and
    evaluation on a (2, 2) mesh."""
    import pytest

    from contextual_image_compression_tpu_torch.eval.harness import CodecEvaluator
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    out = {}
    for m in (1, 2, 4):
        mm = _mesh(m, directory)
        out[m] = (dict(mm.shape), mm.data_index, mm.model_index, mm.position,
                  mm.data.ranks, mm.model.ranks)
    with pytest.raises(ValueError, match="not divisible"):
        _mesh(3, directory)
    with pytest.raises(ValueError, match="straddle"):
        _mesh(4, directory, multihost=True, nodes=[0, 0, 1, 1])
    split = _mesh(2, directory, multihost=True, nodes=["b", "a", "b", "a"])
    out["nodes"] = (split.position, split.data.ranks, split.model.ranks, split.nodes)

    mm = _mesh(2, directory)
    d = np.load(directory / "serve.npz")
    imgs = d["images"]
    pipe = CompressionPipeline(model_config=serve_cfg(), device="cpu", mesh=mm)
    dec, info = pipe(imgs, target_bpp=1.0)
    dec3, _ = pipe(imgs[:3], target_bpp=1.0)
    streams = pipe.encode_to_bitstream(imgs[:3], target_bpp=1.0, mask_downsample=8)
    out["serve"] = {"decoded": dec, "hq_symbols": info["hq_symbols"].numpy(),
                    "decoded3": dec3, "streams": streams,
                    "from_streams": pipe.decode_from_bitstream(streams)}

    ev = CodecEvaluator(eval_cfg(), device="cpu", mesh=mm)
    codec, _ = ev.load_models()
    e = np.load(directory / "eval.npz")
    r = ev.compress_and_reconstruct(codec, e["images"], e["masks"], 1.0)
    from contextual_image_compression_tpu_torch.parallel import sharding
    out["eval"] = {k: r[k] for k in ("psnr", "hq_ratio", "ssim", "measured_bpp")}
    out["eval_sharded"] = sharding.sharded_shapes(codec)
    return out


def serve_cfg() -> ModelConfig:
    return ModelConfig(img_size=(64, 64), base_latent_dim=64, generator_base_hw=4,
                       skip_mode="zero")


def eval_cfg() -> EvalConfig:
    return EvalConfig(model=TINY, batch_size=8,
                      model_dir=str(REPO / "tests" / "fixtures" / "jax_tiny_gan"))


def rehearsal(rank, world, directory):
    """Two nodes of one rank each: per-node dataset shards, the global batch
    from the local ones, a global reduction."""
    from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
    from contextual_image_compression_tpu_torch.parallel import sharding

    mm = _mesh(1, directory, multihost=True, nodes=[0, 1])
    rng = np.random.RandomState(0)  # the same global corpus on both nodes
    images = rng.rand(16, 8, 8, 3).astype(np.float32) * 2 - 1
    masks = rng.rand(16, 8, 8, 1).astype(np.float32)
    ds = CompressionDataset(images, masks, batch_size=8, process_index=mm.nodes[mm.position],
                            process_count=2, seed=3, device="cpu")
    local = sharding.shard_batch(next(ds.epoch(shuffle=False)), mm)
    glob = sharding.gather_batch(local, mm.data)
    total = local.image.sum().reshape(1)
    mm.world.all_reduce_(total)
    return {"local": local.image.shape[0], "global": glob.image.permute(0, 2, 3, 1).numpy(),
            "total": float(total[0]), "bpp": local.bpp.numpy()}


def fit(rank, world, directory):
    """GANTrainer.fit on a (2, 2) mesh for 2 epochs, then a resume on a
    (4, 1) mesh and one more epoch."""
    from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
    from contextual_image_compression_tpu_torch.parallel import sharding
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    d = np.load(directory / "fit.npz")
    cfg = fit_cfg(directory)
    ds = CompressionDataset(d["images"], d["masks"], batch_size=8, device="cpu")
    t1 = GANTrainer(cfg, mesh=_mesh(2, directory), log_fn=lambda s: None)
    t1.init_state(resume=False)
    sharded = sharding.sharded_shapes(t1.state.codec)
    hist = t1.fit(ds, epochs=2, artifacts=False)
    full1 = sharding.full_state_dict(t1.state.codec)
    t2 = GANTrainer(cfg, mesh=_mesh(1, directory), log_fn=lambda s: None)
    t2.init_state(resume=True)
    resumed = {"history": {k: list(v) for k, v in t2.history.items()}, "step": t2.state.step,
               "equal": all(torch.equal(full1[k], v)
                            for k, v in sharding.full_state_dict(t2.state.codec).items()),
               "sharded": sharding.sharded_shapes(t2.state.codec)}
    hist2 = t2.fit(ds, epochs=1, artifacts=False)
    return {"history": {k: list(v) for k, v in hist.items()}, "sharded": sharded,
            "resumed": resumed, "history2": {k: list(v) for k, v in hist2.items()},
            "meta": t2.store.latest_metadata(), "step": t2.state.step}


def fit_cfg(directory) -> TrainConfig:
    return TrainConfig(model=TINY, batch_size=8, use_perceptual=False, epochs=2,
                       checkpoint_every=1, results_dir=str(Path(directory) / "results"),
                       model_dir=str(Path(directory) / "models"))


def ae(rank, world, directory):
    """AETrainer on a (2, 2) mesh for one epoch."""
    from contextual_image_compression_tpu_torch.parallel import sharding
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    images = np.load(directory / "ae.npz")["images"]
    tr = AETrainer(ae_cfg(), log_fn=lambda s: None, mesh=_mesh(2, directory))
    tr.init(seed=1)
    hist = tr.fit(images, epochs=1, batch_size=8, seed=4)
    path = tr.save(str(directory / "ae_model"))
    return {"history": hist, "state": sharding.full_state_dict(tr.model),
            "sharded": sharding.sharded_shapes(tr.model), "path": path}


def ae_cfg() -> AutoencoderConfig:
    return AutoencoderConfig(img_size=(16, 16), epochs=1, batch_size=8)


def main():
    scenario, rank, world, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        Path(sys.argv[4])
    torch.set_num_threads(1)
    try:
        from contextual_image_compression_tpu_torch.parallel import initialize_multihost, sharding

        sharding.DEFAULT_MIN_SHARD_ELEMS = SMALL_SHARD

        init = f"file://{directory / ('rdzv_' + scenario)}"
        assert initialize_multihost(init, world, rank, backend="gloo") == (rank, world)
        assert initialize_multihost(init, world, rank, backend="gloo") == (rank, world)
        out = globals()[scenario](rank, world, directory)
        torch.save(out, directory / f"{scenario}_{rank}.pt")
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        (directory / f"{scenario}_{rank}.err").write_text(traceback.format_exc())
        raise


if __name__ == "__main__":
    main()

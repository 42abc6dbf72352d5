"""The port's mesh layer (contextual_image_compression_tpu_torch/parallel)
against the JAX package's: MeshConfig, create_mesh's shapes, groups and
errors, leaf_spec on the JAX layouts, the dataset's process shards, a
two-node rehearsal, and serving and evaluation on a (2, 2) mesh against one
device.

The mesh runs as gloo ranks on the CPU (tests/torch_mesh_worker.py, one
spawn of 4 ranks and one of 2 for the file); JAX runs in-process on the
8-device virtual CPU mesh of tests/conftest.py. Bars: serving bytes and
symbols bitwise (tests/test_serve.py's), evaluation PSNR 1e-3 and hq_ratio
1e-5 (tests/test_sharding.py's), dataset arrays bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_mesh_worker as W

from contextual_image_compression_tpu.config import MeshConfig as JMeshConfig
from contextual_image_compression_tpu.data.pipeline import CompressionDataset as JDataset
from contextual_image_compression_tpu.parallel import create_mesh as jcreate_mesh
from contextual_image_compression_tpu.parallel import sharding as jsharding
from contextual_image_compression_tpu_torch import convert
from contextual_image_compression_tpu_torch.config import MeshConfig, ModelConfig
from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
from contextual_image_compression_tpu_torch.eval.harness import CodecEvaluator
from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
from contextual_image_compression_tpu_torch.models.discriminator import Discriminator
from contextual_image_compression_tpu_torch.parallel import collectives as C
from contextual_image_compression_tpu_torch.parallel import create_mesh, sharding
from contextual_image_compression_tpu_torch.serve import CompressionPipeline


def test_mesh_config_matches_jax():
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(JMeshConfig())


def test_mesh_without_a_process_group():
    """One process, no process group: a (1, 1) mesh that issues no collective."""
    mesh = create_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    assert (mesh.data_index, mesh.model_index, mesh.position, mesh.is_writer) == (0, 0, 0, True)
    assert mesh.data_parallel_group() is None
    x = torch.arange(6.0).reshape(3, 2)
    assert C.sum_replicated(x, mesh.data) is x and C.gather(x, mesh.world) is x
    assert sharding.shard_batch(x, mesh) is x
    with pytest.raises(ValueError, match="not divisible"):
        create_mesh(2, device="cpu")


SHAPES = [(4096, 1024), (1024, 4096), (8, 8), (), (3, 5), (4, 4, 512, 256), (4, 4, 64, 64),
          (131072, 1024), (1024, 131072), (512,), (4, 4, 3, 6)]


@pytest.mark.parametrize("model_parallel", [2, 4])
@pytest.mark.parametrize("min_elems", [1 << 20, 1 << 12, 1])
def test_leaf_spec_matches_jax(eight_devices, model_parallel, min_elems):
    jmesh = jcreate_mesh(model_parallel=model_parallel)
    port = dataclasses.replace(create_mesh(device="cpu"),
                               shape={"data": 8 // model_parallel, "model": model_parallel})
    for shape in SHAPES:
        want = tuple(jsharding.leaf_spec(shape, jmesh, min_shard_elems=min_elems))
        assert sharding.leaf_spec(shape, port, min_elems) == want, shape


def _modules(cfg, device="cpu"):
    with torch.device(device):
        return AdaptiveCodec(cfg), Discriminator(cfg.img_size, cfg.channels, cfg.disc_base_filters,
                                                 cfg.disc_max_filters, cfg.disc_max_stages,
                                                 cfg.disc_dense_units, cfg.leaky_slope)


def test_layout_maps_are_convert_rules():
    """jax_layout's shape of every parameter is the shape convert.py's rule
    gives it in JAX's layout."""
    for module in _modules(W.TINY):
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                jshape, perm = sharding.jax_layout(mod, name, tuple(p.shape))
                rule = convert._KERNEL_RULES.get(type(mod))
                want = tuple(rule[1](p.detach()).shape) if rule and name == "weight" else \
                    tuple(p.shape)
                assert jshape == want and sorted(perm) == list(range(p.dim())), (mod, name)


def test_full_width_split_leaves(eight_devices):
    """At ModelConfig()'s widths (meta tensors) and model_parallel 2 the rule
    splits the four projections, conv4, deconv1 / 2 and D's dense, the same
    leaves JAX's leaf_spec splits on their JAX shapes (420.9M parameters)."""
    jmesh = jcreate_mesh(model_parallel=2)
    port = dataclasses.replace(create_mesh(device="cpu"), shape={"data": 4, "model": 2})
    split, total = [], 0
    for prefix, module in zip(("", "disc."), _modules(ModelConfig(), "meta")):
        for mname, mod in module.named_modules():
            for name, p in mod.named_parameters(recurse=False):
                total += p.numel()
                jshape, perm = sharding.jax_layout(mod, name, tuple(p.shape))
                spec = sharding.leaf_spec(jshape, port)
                assert spec == tuple(jsharding.leaf_spec(jshape, jmesh)), (mname, name)
                if spec:
                    split.append((f"{prefix}{mname}.{name}", perm[spec.index("model")]))
    assert round(total / 1e6, 1) == 420.9
    assert sorted(split) == sorted(
        [(f"{b}_encoder.latent_dense.weight", 1) for b in ("hq", "lq")]
        + [(f"{b}_generator.fc.weight", 0) for b in ("hq", "lq")]
        + [(f"{b}_encoder.conv4.weight", 0) for b in ("hq", "lq")]
        + [(f"{b}_generator.deconv{i}.weight", 0) for b in ("hq", "lq") for i in (1, 2)]
        + [("disc.dense.weight", 1)])


@pytest.mark.parametrize("count", [2, 3])
def test_dataset_process_shards_match_jax(count):
    """Each process's shard, local batches, shuffles and bpps equal JAX's;
    a with_target_bpp view does not slice again."""
    rng = np.random.RandomState(0)
    images = rng.rand(12, 8, 8, 3).astype(np.float32)
    masks = rng.rand(12, 8, 8, 1).astype(np.float32)
    for p in range(count):
        kw = dict(batch_size=6, process_index=p, process_count=count, seed=5)
        port, jax_ds = CompressionDataset(images, masks, device="cpu", **kw), JDataset(images,
                                                                                      masks, **kw)
        np.testing.assert_array_equal(port.images, images[p::count])
        assert (len(port), port.batch_size, port.seed, port.process_count) == \
            (len(jax_ds), jax_ds.batch_size, jax_ds.seed, jax_ds.process_count)
        for _ in range(2):
            for tb, jb in zip(port.epoch(), jax_ds.epoch(), strict=True):
                np.testing.assert_array_equal(tb.image.permute(0, 2, 3, 1).numpy(), jb.image)
                np.testing.assert_array_equal(tb.mask.permute(0, 2, 3, 1).numpy(), jb.mask)
                np.testing.assert_array_equal(tb.bpp.numpy(), jb.bpp)
        view = port.with_target_bpp(0.1)
        assert len(view) == len(port) and view.batch_size == 6 // count
        assert np.all(next(view.epoch()).bpp.numpy() == np.float32(0.1))
    with pytest.raises(ValueError, match="divisible"):
        CompressionDataset(images, masks, batch_size=9, process_count=2, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        CompressionDataset(images, masks, batch_size=8, process_index=2, process_count=2,
                           device="cpu")


# ----------------------------------------------------------- 4 gloo ranks


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.RandomState(5)
    np.savez(d / "serve.npz", images=rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8))
    np.savez(d / "eval.npz", images=rng.rand(8, 32, 32, 3).astype(np.float32) * 2 - 1,
             masks=rng.rand(8, 32, 32, 1).astype(np.float32))
    return d, W.spawn("mesh", 4, d)


def test_create_mesh_shapes_groups_and_errors(four_ranks):
    """Every (data, model) shape of 4 ranks, in rank order; the errors (not
    divisible, a model group straddling nodes) raised in every rank; ranks
    ordered by (node, rank) when nodes interleave."""
    _, res = four_ranks
    for r, out in enumerate(res):
        for m in (1, 2, 4):
            shape, di, mi, pos, data_ranks, model_ranks = out[m]
            assert shape == {"data": 4 // m, "model": m} and (di, mi, pos) == (r // m, r % m, r)
            assert model_ranks == tuple(range(di * m, di * m + m))
            assert data_ranks == tuple(range(mi, 4, m))
    # nodes b, a, b, a: ranks 0 and 2 on the first node, in mesh order 0, 2, 1, 3
    order = (0, 2, 1, 3)
    for r, out in enumerate(res):
        pos, data_ranks, model_ranks, nodes = out["nodes"]
        assert pos == order.index(r) and nodes == (0, 0, 1, 1)
        assert model_ranks == order[pos // 2 * 2:pos // 2 * 2 + 2]
        assert data_ranks == order[pos % 2::2]


def test_pipeline_on_mesh_gives_single_device_bytes(four_ranks):
    """CompressionPipeline(mesh=) on a (2, 2) mesh: the bytes and symbols of
    one device, a ragged request padded to the mesh and sliced back, and the
    storable path with a ragged decode batch, on every rank."""
    d, res = four_ranks
    imgs = np.load(d / "serve.npz")["images"]
    ref = CompressionPipeline(model_config=W.serve_cfg(), device="cpu")
    dec, info = ref(imgs, target_bpp=1.0)
    streams = ref.encode_to_bitstream(imgs[:3], target_bpp=1.0, mask_downsample=8)
    from_streams = ref.decode_from_bitstream(streams)
    assert from_streams.shape == (3, 64, 64, 3)
    for out in res:
        s = out["serve"]
        np.testing.assert_array_equal(s["decoded"], dec)
        np.testing.assert_array_equal(s["hq_symbols"], info["hq_symbols"].numpy())
        np.testing.assert_array_equal(s["decoded3"], dec[:3])
        assert s["streams"] == streams
        np.testing.assert_array_equal(s["from_streams"], from_streams)


def test_evaluator_on_mesh_matches_single_device(four_ranks):
    """CodecEvaluator(mesh=) with the tiny JAX-trained GAN split at 1 << 12
    elements (the projections row- and column-parallel): PSNR within 1e-3,
    hq_ratio within 1e-5 of one device (measured: equal)."""
    d, res = four_ranks
    e = np.load(d / "eval.npz")
    ev = CodecEvaluator(W.eval_cfg(), device="cpu")
    codec, _ = ev.load_models()
    want = ev.compress_and_reconstruct(codec, e["images"], e["masks"], 1.0)
    for out in res:
        got = out["eval"]
        np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-3)
        np.testing.assert_allclose(got["hq_ratio"], want["hq_ratio"], atol=1e-5)
        np.testing.assert_array_equal(got["measured_bpp"], want["measured_bpp"])
    split = res[0]["eval_sharded"]
    assert split["hq_encoder.latent_dense.weight"] == ((32, 128), (32, 64))  # row-parallel
    assert split["hq_generator.fc.weight"] == ((128, 32), (64, 32))          # column-parallel


# ----------------------------------------------------------- 2 gloo ranks


def test_two_node_rehearsal(tmp_path):
    """JAX tests/test_multihost.py's rehearsal on two nodes of one rank:
    each node's dataset shard gives a local batch of 4, the global batch of
    8 is the nodes' local batches in node order, and a global sum matches."""
    res = W.spawn("rehearsal", 2, tmp_path)
    rng = np.random.RandomState(0)
    images = rng.rand(16, 8, 8, 3).astype(np.float32) * 2 - 1
    want = np.concatenate([images[0::2][:4], images[1::2][:4]])
    for out in res:
        assert out["local"] == 4
        np.testing.assert_array_equal(out["global"], want)
        np.testing.assert_allclose(out["total"], want.sum(), rtol=1e-5)
    assert not np.array_equal(res[0]["bpp"], res[1]["bpp"])  # per-node streams (seed + p)

"""The port's sharding rules and its gather, against the reference.

* every case of ``tests/test_sharding.py``, on the port's ``MeshShape``;
* for all 13 configs on both production meshes, fsdp off and on: the
  port's ``param_spec`` of every leaf of ``specs.params_struct`` equals the
  reference's ``param_spec`` of the same path and shape, as tuples; so do
  ``cache_spec`` on every decode cache leaf of each applicable decode
  shape and ``batch_spec`` on every batch leaf (the reference's rules are
  pure functions of (path, shape, mesh), called here on a shape-only mesh
  as its own test calls them);
* on 4 gloo ranks, a (2, 2) ("data", "model") mesh: ``shard`` then
  ``gather`` gives the global tensor back bit for bit, and the gather's
  backward is the reduce-scatter (each rank's block gets the sum over the
  ranks of their upstream gradients' matching blocks).
"""
import math

import numpy as np
import pytest
import torch

from repro.configs.shapes import SHAPES
from repro.parallel import sharding as jshd
from repro_torch import tree
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.shapes import applicable
from repro_torch.launch import specs
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.meshctx import MeshShape

P = shd.PartitionSpec
MESH = MeshShape(("data", "model"), (16, 16))
MESH3 = MeshShape(("pod", "data", "model"), (2, 16, 16))


def test_fit_divisibility():
    assert shd._fit(MESH, "model", 64) == "model"
    assert shd._fit(MESH, "model", 63) is None
    assert shd._fit(MESH, ("pod", "data"), 32) == "data"     # shrinks to data
    assert shd._fit(MESH3, ("pod", "data"), 32) == ("pod", "data")
    assert shd._fit(MESH3, ("pod", "data"), 16) == "data"    # shrinks


def test_moe_weight_layout_is_fse_dp():
    """d_expert must shard over model: one copy of every expert a group."""
    spec = shd.param_spec("periods/0/moe/w_up", (24, 32, 1024, 512), MESH,
                          fsdp=False)
    assert spec == P(None, None, None, "model")
    spec = shd.param_spec("periods/0/moe/w_down", (24, 32, 512, 1024), MESH,
                          fsdp=False)
    assert spec == P(None, None, "model", None)


def test_dense_ffn_tp():
    assert shd.param_spec("periods/0/ffn/w_up", (32, 2048, 8192), MESH,
                          fsdp=False) == P(None, None, "model")
    assert shd.param_spec("periods/0/ffn/w_down", (32, 8192, 2048), MESH,
                          fsdp=True) == P(None, "model", "data")


def test_attention_heads_tp():
    assert shd.param_spec("periods/0/attn/wq", (32, 4096, 4096), MESH,
                          fsdp=False) == P(None, None, "model")
    assert shd.param_spec("periods/0/attn/wo", (32, 4096, 4096), MESH,
                          fsdp=False) == P(None, "model", None)


def test_vocab_sharding():
    assert shd.param_spec("embed", (256000, 6144), MESH, fsdp=False) \
        == P(None, "model")
    assert shd.param_spec("lm_head", (6144, 256000), MESH, fsdp=False) \
        == P(None, "model")
    assert shd.param_spec("embed", (49155, 1023), MESH, fsdp=False) \
        == P(None, None)


def test_norms_replicated():
    assert shd.param_spec("periods/0/norm1/scale", (32, 1024), MESH,
                          fsdp=False) == P()


def test_cache_specs():
    spec = shd.cache_spec("caches/0/kv/k", (32, 128, 32768, 8, 128), MESH,
                          batch_axes=("data",))
    assert spec == P(None, "data", "model", None, None)
    spec = shd.cache_spec("caches/0/kv/k", (4, 1, 524288, 8, 128), MESH,
                          batch_axes=("data",))
    assert spec == P(None, None, "model", None, None)
    spec = shd.cache_spec("caches/0/ssm/ssd", (48, 128, 32, 64, 128), MESH,
                          batch_axes=("data",))
    assert spec == P(None, "data", "model", None, None)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "mamba2-370m", "whisper-base"])
def test_param_specs_cover_all_leaves(arch):
    """Every parameter leaf of every family gets a spec whose axes divide
    its dims, and the block shape follows."""
    for path, leaf in tree.leaves_with_path(specs.params_struct(
            get_config(arch))):
        key = shd.path_key(path)
        spec = shd.param_spec(key, leaf.shape, MESH, fsdp=False)
        assert len(spec) <= leaf.dim(), (key, spec, leaf.shape)
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * 10):
            if ax is not None:
                size = MESH.shape[ax] if isinstance(ax, str) else \
                    math.prod(MESH.shape[a] for a in ax)
                assert dim % size == 0, (key, spec, leaf.shape)
        shd.NamedSharding(MESH, spec).block_shape(leaf.shape)


def test_path_keys_are_the_references():
    assert shd.path_key("0/.kv/.k") == "0/kv/k"
    assert shd.path_key(".self_kv/.k") == "self_kv/k"
    assert shd.path_key("periods/0/moe/w_up") == "periods/0/moe/w_up"


def test_production_meshes_shape_only():
    m = make_production_mesh(shape_only=True)
    m3 = make_production_mesh(multi_pod=True, shape_only=True)
    assert (m.shape, m3.shape) == (MESH.shape, MESH3.shape)
    assert data_axes(m3) == ("pod", "data") and m3.world_size == 512


@pytest.mark.parametrize("fsdp", [False, True], ids=["fsdp_off", "fsdp_on"])
@pytest.mark.parametrize("mesh", [MESH, MESH3], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_configs())
def test_specs_equal_the_references(arch, mesh, fsdp):
    cfg = get_config(arch)
    baxes = data_axes(mesh)
    n = 0
    for path, leaf in tree.leaves_with_path(specs.params_struct(cfg)):
        key = shd.path_key(path)
        got = shd.param_spec(key, tuple(leaf.shape), mesh, fsdp=fsdp)
        want = jshd.param_spec(key, tuple(leaf.shape), mesh, fsdp=fsdp)
        assert tuple(got) == tuple(want), (key, got, want)
        n += 1
    assert n > 0
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape = SHAPES[name]
        if not applicable(cfg, shape)[0]:
            continue
        structs = specs.input_specs(cfg, shape)
        leaves = tree.leaves_with_path(structs["caches"]) \
            if shape.kind == "decode" else ()
        for path, leaf in leaves:
            key = shd.path_key(path)
            got = shd.cache_spec(key, tuple(leaf.shape), mesh,
                                 batch_axes=baxes)
            want = jshd.cache_spec(key, tuple(leaf.shape), mesh,
                                   batch_axes=baxes)
            assert tuple(got) == tuple(want), (name, key, got, want)
        batch = structs if shape.kind != "decode" else {
            "token": structs["token"], "cache_len": structs["cache_len"]}
        for k, v in batch.items():
            assert tuple(shd.batch_spec(k, tuple(v.shape), mesh, baxes)) == \
                tuple(jshd.batch_spec(k, tuple(v.shape), mesh, baxes))


# --- on 4 gloo ranks --------------------------------------------------------

SPECS = [P(None, ("data", "model")), P("data", "model"),
         P("model", None, "data"), P(None, "model"), P()]
SHAPES_3 = {2: (4, 8), 3: (4, 2, 6)}


def _global(spec, seed):
    nd = max(len(spec), 2)
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SHAPES_3[nd]).astype(np.float32)


def _rank_roundtrip(rank, world):
    from repro_torch.parallel import meshctx
    mesh = meshctx.ProcessMesh.create((2, 2), ("data", "model"))
    out = []
    for i, spec in enumerate(SPECS):
        sh = shd.NamedSharding(mesh, spec)
        full = torch.from_numpy(_global(spec, i))
        block = sh.shard(full).contiguous().requires_grad_(True)
        back = sh.gather(block)
        # each rank's own upstream gradient, from its rank
        up = torch.from_numpy(_global(spec, 100 + rank))
        (g,) = torch.autograd.grad(torch.sum(back * up), block)
        out.append((tuple(block.shape), back.detach().numpy(), g.numpy()))
    return out


@pytest.fixture(scope="module")
def roundtrip():
    from repro_torch.parallel import localrun
    return localrun.run(_rank_roundtrip, 4)


@pytest.mark.parametrize("i", range(len(SPECS)),
                         ids=[str(tuple(s)) for s in SPECS])
def test_shard_gather_roundtrip_and_reduce_scatter(roundtrip, i):
    """(data, model) = (r // 2, r % 2).  The gather gives every rank the
    global tensor bit for bit; its backward gives rank r the sum, over the
    ranks its gather spans (the ones that share r's coordinates on the
    other axes), of their upstream gradients' block at r's position."""
    from repro_torch.parallel import meshctx
    spec = SPECS[i]
    full = _global(spec, i)
    named = set(a for e in spec for a in shd._axes(e))
    for r, per_spec in enumerate(roundtrip):
        bshape, back, g = per_spec[i]
        np.testing.assert_array_equal(back, full)
        coords = (r // 2, r % 2)
        fake = meshctx.ProcessMesh(("data", "model"), (2, 2), coords,
                                   (None, None), ((), ()), r)
        sh = shd.NamedSharding(fake, spec)
        assert sh.block_shape(full.shape) == bshape
        peers = [q for q in range(4) if all(
            (q // 2, q % 2)[j] == coords[j] for j, a in
            enumerate(("data", "model")) if a not in named)]
        want = sum(_global(spec, 100 + q) for q in peers)
        np.testing.assert_allclose(
            g, sh.shard(torch.from_numpy(want)).numpy(), rtol=1e-6,
            atol=1e-6)

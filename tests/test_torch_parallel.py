"""The port's mesh and sharding rules (``karanta_tpu_torch.parallel``) against
the JAX package's, and its row-parallel products on two gloo ranks.

``MeshConfig.resolve`` gives the JAX package's dims and errors;
``spec_from_logical`` gives JAX's ``PartitionSpec`` entries for every leaf of
``param_axes`` at the tiny and 7B configs; ``shard_params`` slices put back
together give every leaf; the row-parallel W8A8 product on two ranks (each
holding half the input dim) is bit-equal to the unsharded one, the weight-only
and plain products equal it to float32 rounding; uneven splits are refused.
The two ranks are spawned processes on the CPU that meet through a
``file://`` rendezvous under the test's tmp_path, each with a timeout.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from karanta_tpu.models.qwen25_vl.config import get_config as j_get_config
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import param_axes as j_param_axes
from karanta_tpu.parallel.mesh import MeshConfig as JMeshConfig
from karanta_tpu.parallel.mesh import create_mesh as j_create_mesh
from karanta_tpu.parallel.sharding import DEFAULT_RULES as J_DEFAULT_RULES
from karanta_tpu.parallel.sharding import REPLICATED_RULES as J_REPL_RULES
from karanta_tpu.parallel.sharding import spec_from_logical as j_spec
from karanta_tpu_torch.models.qwen25_vl.config import get_config, tiny_config
from karanta_tpu_torch.models.qwen25_vl.model import (init_params,
                                                      param_axes,
                                                      serving_param_axes)
from karanta_tpu_torch.ops.quantization import (matmul, matmul_w8a8,
                                                quantize_decoder_params,
                                                quantize_vision_params,
                                                quantize_weight)
from karanta_tpu_torch.parallel.launch import run_ranks
from karanta_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh, MeshConfig
from karanta_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                 REPLICATED_RULES,
                                                 shard_leaf, shard_params,
                                                 spec_from_logical)
from karanta_tpu_torch.utils.tree import flatten_tree
from tests.torch_ranks import RANK_TIMEOUT_S, products_rank


@pytest.mark.parametrize("fields,n", [
    ({}, 8), ({"data": 2, "fsdp": 2, "model": 2}, 8),
    ({"data": -1, "model": 2}, 8), ({"data": 2, "fsdp": -1}, 8),
    ({"data": 1, "model": -1, "seq": 2}, 8), ({"pipe": 2, "data": -1}, 4),
    ({"data": 2, "model": 2}, 4), ({"data": 1, "fsdp": 1, "model": 1}, 1),
    ({"data": -1, "model": -1}, 8), ({"data": -1, "model": 3}, 8),
    ({"data": 2, "model": 2}, 8), ({"data": 4, "model": 4}, 8),
], ids=lambda v: str(v))
def test_mesh_config_resolve_matches_jax(fields, n):
    """The same dims, or the same error, as the JAX package's MeshConfig."""
    try:
        want = JMeshConfig(**fields).resolve(n)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            MeshConfig(**fields).resolve(n)
        assert str(got.value) == str(exc)
        return
    assert MeshConfig(**fields).resolve(n) == want
    assert MeshConfig(**fields).layout_dims == \
        JMeshConfig(**fields).layout_dims


def _axes_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _axes_leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("rules", ["default", "replicated"])
@pytest.mark.parametrize("preset", ["tiny", "qwen2.5-vl-7b"])
def test_spec_from_logical_matches_jax(preset, rules):
    """param_axes equals the JAX package's, and every leaf's spec gives the
    entries of JAX's PartitionSpec."""
    if preset == "tiny":
        cfg, jcfg = tiny_config(vocab_size=272), j_tiny_config(vocab_size=272)
    else:
        cfg, jcfg = get_config(preset), j_get_config(preset)
    ours = dict(_axes_leaves(param_axes(cfg)))
    theirs = dict(_axes_leaves(j_param_axes(jcfg)))
    assert ours == theirs
    r, jr = ((DEFAULT_RULES, J_DEFAULT_RULES) if rules == "default"
             else (REPLICATED_RULES, J_REPL_RULES))
    assert r == jr
    for path, axes in ours.items():
        want = j_spec(axes, jr)
        assert isinstance(want, PartitionSpec)
        assert spec_from_logical(axes, r) == tuple(want), path


def _fake_mesh(data: int, model: int, rank: int) -> Mesh:
    """Rank `rank`'s coordinates on a (data, model) mesh, without a process
    group: enough for shard_leaf and shard_params."""
    dims = dict(zip(AXIS_NAMES, (data, 1, 1, 1, model)))
    coords = dict(zip(AXIS_NAMES, (rank // model, 0, 0, 0, rank % model)))
    return Mesh(rank=rank, dims=dims, coords=coords,
                groups={a: None for a in AXIS_NAMES}, world_group=None,
                cpu_group=None, backend=None, device=torch.device("cpu"))


def test_mesh_layout_matches_jax_devices():
    """The port's rank order is the JAX mesh's device order: rank r sits at
    the coordinates where JAX's (data, pipe, fsdp, seq, model) array holds
    device r."""
    jmesh = j_create_mesh(JMeshConfig(data=2, fsdp=1, model=2),
                          devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(4):
        mesh = _fake_mesh(2, 2, rank)
        pos = tuple(mesh.coords[a] for a in AXIS_NAMES)
        assert ids[pos] == jax.devices()[rank].id
        assert mesh.rank_of(**mesh.coords) == rank


@pytest.mark.parametrize("quantize", [False, True])
def test_shard_params_slices_reassemble(quantize):
    """Each rank's serving shards of the tiny model, put back together along
    their sharded dims, are the whole leaves (quantized leaves: the int8
    matrix along its axes, the scale along its output axis)."""
    cfg = tiny_config(vocab_size=272)
    params = init_params(cfg, 0, torch.float32, device="cpu")
    if quantize:
        params = {"text": quantize_decoder_params(params["text"]),
                  "visual": quantize_vision_params(params["visual"])}
    axes = serving_param_axes(cfg, "int8" if quantize else None)
    shards = [flatten_tree(shard_params(params, axes, _fake_mesh(1, 2, r)))
              for r in range(2)]
    whole = flatten_tree(params)
    flat_axes = {"/".join(p): a for p, a in _axes_leaves(axes)}
    for key, leaf in whole.items():
        base = key.rsplit("/", 1)[0] if key.endswith(("int8_q", "scale")) \
            else key
        spec = spec_from_logical(flat_axes[base])
        if key.endswith("scale"):
            spec = spec[:-2] + (None, spec[-1])
        dims = [d for d, a in enumerate(spec) if a == "model"]
        parts = [s[key] for s in shards]
        if not dims:
            assert all(torch.equal(p, leaf) for p in parts), key
            continue
        assert torch.equal(torch.cat(parts, dims[0]), leaf), key
        assert parts[0].shape[dims[0]] * 2 == leaf.shape[dims[0]], key


def test_uneven_split_refused():
    """A dim that does not split evenly raises ValueError naming the leaf
    and the axis, as jax.device_put refuses it."""
    w = torch.zeros((3, 8, 6))
    with pytest.raises(ValueError, match=r"text/layers/attn/wk.*'model'"):
        shard_leaf(w, ("layers", "embed", "kv_heads"), _fake_mesh(1, 4, 1),
                   name="text/layers/attn/wk")
    with pytest.raises(ValueError, match="logical axes"):
        shard_leaf(w, ("layers", "embed"), _fake_mesh(1, 2, 0))
    assert shard_leaf(w, ("layers", "embed", "kv_heads"),
                      _fake_mesh(1, 2, 1)).shape == (3, 8, 3)


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    url = f"file://{tmp_path_factory.mktemp('rdzv')}/store"
    outs = run_ranks(products_rank, 2, (x, w), init_url=url,
                     timeout_s=4 * RANK_TIMEOUT_S)
    return x, w, outs


def test_row_parallel_w8a8_bit_equal(products):
    """W8A8 on two ranks, each with half the row: the amax over the whole
    row and the exact int32 sum make it bit-equal to one rank's."""
    x, w, outs = products
    want = matmul_w8a8(torch.from_numpy(x), quantize_weight(
        torch.from_numpy(w))).numpy()
    for out in outs:
        np.testing.assert_array_equal(out["w8a8"], want)


@pytest.mark.parametrize("kind", ["weight_only", "plain", "auto_plain"])
def test_row_parallel_float_products(products, kind):
    """The weight-only int8 and plain products sum float32 partials: equal
    to one rank's within float32 rounding, and the same on both ranks."""
    x, w, outs = products
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = (matmul(xt, quantize_weight(wt)) if kind == "weight_only"
            else xt @ wt).numpy()
    np.testing.assert_allclose(outs[0][kind], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(outs[0][kind], outs[1][kind])


def test_collective_helpers(products):
    """all_gather_last in rank order, all_reduce_max, broadcast_objects
    from rank 1, gather_objects to rank 0 and the mesh coordinates."""
    _, _, outs = products
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["gathered"], [0, 1, 2, 10, 11, 12])
        np.testing.assert_array_equal(out["max"], [1.0, 0.0])
        assert out["objects"] == [1, {"r": 1}]
        assert out["coords"]["model"] == rank and out["coords"]["data"] == 0
    assert outs[0]["gathered_objects"] == [0, 1]
    assert outs[1]["gathered_objects"] is None

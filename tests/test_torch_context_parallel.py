"""Context (sequence) parallelism of the PyTorch port
(``karanta_tpu_torch/parallel/context.py``) against the JAX package's
``make_context_parallel_attention`` on its virtual CPU mesh, case by case
the twins of tests/test_context_parallel.py.

The port's ranks are spawned gloo processes on the CPU (``tests/
torch_ranks.py``): at seq = 2 and at seq = 2 x model = 2. Each rank computes
its block of the output and of the gradients; the blocks are reassembled
here. Tolerances are the JAX tests': outputs rtol/atol 2e-5, attention
gradients 5e-5, the loss rtol 1e-5 and parameter gradients rtol/atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.parallel.context import \
    make_context_parallel_attention as j_make_cp
from karanta_tpu.parallel.mesh import MeshConfig as JMeshConfig
from karanta_tpu.parallel.mesh import create_mesh as j_create_mesh
from karanta_tpu_torch.parallel.context import (
    make_context_parallel_attention, seq_chunk, sequence_sharded_batch)
from karanta_tpu_torch.parallel.launch import run_ranks
from karanta_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh
from tests.torch_ranks import (RANK_TIMEOUT_S, jobs_rank,
                               shard_attention_inputs)


@pytest.fixture(scope="module")
def sp_mesh():
    assert len(jax.devices()) == 8
    return j_create_mesh(JMeshConfig(data=2, fsdp=1, model=2, seq=2))


def _qkv(seed=0, b=2, s=64, h=4, kvh=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))


def _mask(seed=2, b=2, s=64):
    mask = np.random.default_rng(seed).integers(0, 2, size=(b, s))
    mask[:, 0] = 1
    return mask.astype(np.float32)


CASES = {
    "forward": dict(seed=0),
    "mask": dict(seed=1, mask=True),
    "grads": dict(seed=3),
    "batch1": dict(seed=6, b=1, ones_mask=True),
}


def _inputs(name):
    c = CASES[name]
    q, k, v = _qkv(seed=c["seed"], b=c.get("b", 2))
    mask = None
    if c.get("mask"):
        mask = _mask()
    elif c.get("ones_mask"):
        mask = np.ones((q.shape[0], q.shape[1]), np.float32)
    return q, k, v, mask


def _jax(name, mesh):
    """The JAX context-parallel output and gradients of sum(out ** 2)."""
    q, k, v, mask = _inputs(name)
    cp = j_make_cp(mesh)
    m = None if mask is None else jnp.asarray(mask, jnp.int32)

    def loss(q, k, v):
        return (cp(q, k, v, kv_mask=m, causal=True) ** 2).sum()

    out = jax.jit(lambda q, k, v: cp(q, k, v, kv_mask=m, causal=True))(
        q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assemble(ranks, shape, key, q_like=True):
    out = np.full(shape, np.nan, np.float32)
    for r in ranks:
        rows, pos, qh, kh = r["index"]
        out[rows, pos, qh if q_like else kh] = r[key]
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's blocks of every case, at seq = 2 and seq = 2 x model = 2
    (one spawn each)."""
    out = {}
    for label, dims, world in (("seq2", {"seq": 2}, 2),
                               ("seq2_model2", {"seq": 2, "model": 2}, 4)):
        jobs = []
        for name in CASES:
            q, k, v, mask = _inputs(name)
            jobs.append(("context_job",
                         {"q": q, "k": k, "v": v, "mask": mask}))
        url = f"file://{tmp_path_factory.mktemp(label)}/rdv"
        ranks = run_ranks(jobs_rank, world, (dims, jobs), init_url=url,
                          timeout_s=4 * RANK_TIMEOUT_S)
        out[label] = {name: [r[i] for r in ranks]
                      for i, name in enumerate(CASES)}
    return out


LAYOUTS = ("seq2", "seq2_model2")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_matches_jax(sp_mesh, port_runs, layout):
    want, _ = _jax("forward", sp_mesh)
    got = _assemble(port_runs[layout]["forward"], want.shape, "out")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_with_mask_matches_jax(sp_mesh, port_runs, layout):
    want, _ = _jax("mask", sp_mesh)
    got = _assemble(port_runs[layout]["mask"], want.shape, "out")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gradients_match_jax(sp_mesh, port_runs, layout):
    _, (dq, dk, dv) = _jax("grads", sp_mesh)
    ranks = port_runs[layout]["grads"]
    for key, want, q_like in (("dq", dq, True), ("dk", dk, False),
                              ("dv", dv, False)):
        got = _assemble(ranks, want.shape, key, q_like)
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5,
                                   err_msg=key)


def test_indivisible_batch_falls_back_to_replicated(sp_mesh, port_runs):
    # b = 1 does not divide "data": every rank takes the whole batch, and
    # the JAX package replicates it too
    want, _ = _jax("batch1", sp_mesh)
    got = _assemble(port_runs["seq2"]["batch1"], want.shape, "out")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    mesh = _fake_mesh(data=2, seq=2, model=2)
    q, k, v, mask = _inputs("batch1")
    *_, (rows, _, _) = shard_attention_inputs(
        mesh, *(torch.from_numpy(x) for x in (q, k, v, mask)))
    assert rows == slice(None)


def _fake_mesh(**dims) -> Mesh:
    """A rank's view of a mesh (coordinates 0) with no process groups: the
    cases that raise before any collective, or run on one rank."""
    sizes = {a: dims.get(a, 1) for a in AXIS_NAMES}
    return Mesh(rank=0, dims=sizes, coords={a: 0 for a in AXIS_NAMES},
                groups={a: None for a in AXIS_NAMES}, world_group=None,
                cpu_group=None, backend=None, device=torch.device("cpu"))


def test_indivisible_sequence_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv(s=63))
    mesh = _fake_mesh(seq=2)
    with pytest.raises(ValueError, match="divide"):
        shard_attention_inputs(mesh, q, k, v)
    with pytest.raises(ValueError, match="divide"):
        sequence_sharded_batch(mesh, {"token_ids": torch.zeros((1, 63))})


def test_seq_axis_one_falls_through():
    mesh = j_create_mesh(JMeshConfig(data=2, fsdp=2, model=2))
    q, k, v = _qkv(seed=4)
    want = j_make_cp(mesh)(q, k, v, causal=True)
    got = make_context_parallel_attention(_fake_mesh(data=2, model=2))(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert seq_chunk(_fake_mesh(), 63) == (0, 63)


# ---------------------------------------------------------------------------
# the training loss and step under "seq"
# ---------------------------------------------------------------------------

def _tiny():
    from karanta_tpu.inference.tokenizer import ByteTokenizer
    from karanta_tpu.models.qwen25_vl.config import tiny_config

    return tiny_config(vocab_size=ByteTokenizer().vocab_size)


def _batch(cfg, b=2, s=64):
    rng = np.random.default_rng(7)
    ids = rng.integers(12, cfg.text.vocab_size, size=(b, s)).astype(np.int32)
    labels = np.array(ids)
    labels[:, :8] = -100
    # a target right after the chunk boundary: the shift must reach it
    labels[:, s // 2] = ids[:, s // 2]
    positions = np.tile(np.arange(s, dtype=np.int32), (3, b, 1))
    return {"token_ids": ids, "labels": labels, "positions": positions}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The port's seq = 2 loss, gradients and AdamW step on the JAX tiny
    weights (one spawn)."""
    from karanta_tpu.models.qwen25_vl.model import init_params

    cfg = _tiny()
    jparams = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    spec = {"cfg": "tiny", "params": jax.tree.map(np.asarray, jparams),
            "batch": _batch(cfg),
            "cases": [dict(optimizer="adamw", lr=1e-3, grad_accum=1,
                           sp=True, grads=True)]}
    url = f"file://{tmp_path_factory.mktemp('sp_train')}/rdv"
    ranks = run_ranks(jobs_rank, 2, ({"seq": 2}, [("train_job", spec)]),
                      init_url=url, timeout_s=4 * RANK_TIMEOUT_S)
    return cfg, jparams, [r[0]["cases"][0] for r in ranks]


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_loss_and_grads_match_jax(sp_mesh, train_runs):
    from karanta_tpu.models.qwen25_vl.model import param_axes
    from karanta_tpu.parallel.sharding import DEFAULT_RULES, shard_pytree
    from karanta_tpu.training.train_step import make_loss_fn

    cfg, params, ranks = train_runs
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    with sp_mesh:
        sharded = shard_pytree(params, param_axes(cfg), sp_mesh,
                               DEFAULT_RULES)
        loss_fn = make_loss_fn(cfg, sp_mesh=sp_mesh)
        loss, _ = jax.jit(loss_fn)(sharded, batch)
        grads = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(
            sharded, batch)
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], float(loss), rtol=1e-5)
    want = _flat(grads)
    assert set(ranks[0]["grads"]) == set(want)
    for r in ranks:
        for path, w in want.items():
            np.testing.assert_allclose(r["grads"][path], w, rtol=2e-4,
                                       atol=2e-4, err_msg=path)


def test_full_train_step_matches_jax(sp_mesh, train_runs):
    from karanta_tpu.models.qwen25_vl.model import param_axes
    from karanta_tpu.parallel.sharding import DEFAULT_RULES, shard_pytree
    from karanta_tpu.training.optimizer import make_optimizer
    from karanta_tpu.training.train_step import (create_train_state,
                                                 make_train_step)

    cfg, params, ranks = train_runs
    with sp_mesh:
        sharded = shard_pytree(params, param_axes(cfg), sp_mesh,
                               DEFAULT_RULES)
        optimizer = make_optimizer("adamw", 1e-3)
        state = create_train_state(sharded, optimizer)
        step = jax.jit(make_train_step(cfg, optimizer, sp_mesh=sp_mesh))
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in _batch(cfg).items()})
    assert int(state.step) == 1
    want = _flat(state.params)
    for r in ranks:
        assert np.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], float(metrics["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"],
                                   float(metrics["grad_norm"]), rtol=1e-4)
        for path, w in want.items():
            np.testing.assert_allclose(r["params"][path], w, rtol=2e-4,
                                       atol=2e-4, err_msg=path)


def test_label_shift_crosses_the_chunk_boundary():
    # the port shifts the labels over the whole sequence before cutting it:
    # the last position of chunk 0 predicts chunk 1's first token
    batch = {k: torch.from_numpy(v) for k, v in _batch(_tiny()).items()}
    labels = batch["labels"]
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                        -100)], 1)
    mesh = _fake_mesh(seq=2)
    chunk0, off0 = sequence_sharded_batch(mesh, {**batch,
                                                 "labels": shifted})
    assert off0 == 0
    assert torch.equal(chunk0["labels"][:, -1], batch["token_ids"][:, 32])

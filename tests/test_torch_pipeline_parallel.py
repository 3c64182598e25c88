"""Pipeline parallelism of the PyTorch port (``karanta_tpu_torch/parallel/
pipeline.py``, ``decoder.pipeline_prefill_forward`` and ``make_train_step
(pp_mesh=)``) against the JAX package's GPipe on its virtual CPU mesh, case
by case the twins of tests/test_pipeline_parallel.py.

The port's ranks are spawned gloo processes on the CPU (``tests/
torch_ranks.py``): pipe = 2, and data = 2 x pipe = 2 (rows split over
"data" as the trainer feeds them). Tolerances are the JAX tests': the
schedule's outputs 1e-5, its gradients 1e-4, the decoder's hidden states
2e-4 and gradients 5e-4, the train step's loss rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.parallel.mesh import MeshConfig as JMeshConfig
from karanta_tpu.parallel.mesh import create_mesh as j_create_mesh
from karanta_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from karanta_tpu_torch.parallel.launch import run_ranks
from karanta_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh
from karanta_tpu_torch.parallel.pipeline import pipeline_apply
from tests.torch_ranks import RANK_TIMEOUT_S, jobs_rank

N_MICRO = (1, 2, 4)


@pytest.fixture(scope="module")
def pp_mesh():
    assert len(jax.devices()) == 8
    return j_create_mesh(JMeshConfig(data=2, fsdp=1, model=1, pipe=4))


@pytest.fixture(scope="module")
def pp2_mesh():
    return j_create_mesh(JMeshConfig(data=2, fsdp=1, model=2, pipe=2))


def _toy(n_layers=8, b=8, h=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((n_layers, h, h)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal((n_layers, h)) * 0.1).astype(np.float32),
        "x": rng.standard_normal((b, 4, h)).astype(np.float32),
        "scale": (rng.standard_normal((b, 4, 1)) * 0.1 + 1.0).astype(
            np.float32),
    }


def _j_layer(a, lyr, ext):
    return jnp.tanh(a @ lyr["w"] + lyr["b"]) * ext["scale"]


def _j_toy(mesh, toy, n_micro):
    layers = {"w": toy["w"], "b": toy["b"]}
    return np.asarray(jax.jit(lambda l, x, e: j_pipeline_apply(
        mesh, _j_layer, l, x, e, n_micro))(
            layers, toy["x"], {"scale": toy["scale"]}))


def _tiny4():
    from karanta_tpu.inference.tokenizer import ByteTokenizer
    from karanta_tpu.models.qwen25_vl.config import tiny_config

    cfg = tiny_config(vocab_size=ByteTokenizer().vocab_size)
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_layers=4))


def _decoder_inputs(cfg, b=4, s=32, seed=11):
    rng = np.random.default_rng(seed)
    return {"embeds": (rng.standard_normal((b, s, cfg.text.hidden_size))
                       * 0.05).astype(np.float32),
            "positions": np.tile(np.arange(s, dtype=np.int32), (3, b, 1))}


def _train_batch(cfg, b=4, s=32):
    rng = np.random.default_rng(17)
    ids = rng.integers(12, cfg.text.vocab_size, size=(b, s)).astype(np.int32)
    labels = np.array(ids)
    labels[:, :4] = -100
    return {"token_ids": ids, "labels": labels,
            "positions": np.tile(np.arange(s, dtype=np.int32), (3, b, 1))}


@pytest.fixture(scope="module")
def weights():
    from karanta_tpu.models.qwen25_vl import decoder as jdec
    from karanta_tpu.models.qwen25_vl.model import init_params

    cfg = _tiny4()
    dec_params = jdec.init_decoder_params(cfg.text, jax.random.PRNGKey(1),
                                          jnp.float32)
    params = init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    return cfg, dec_params, params


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory, weights):
    """Every case on the port's ranks: pipe = 2 (the schedule at each
    n_micro with gradients, the decoder, a train step), and data = 2 x
    pipe = 2 (the schedule, an indivisible batch, a train step)."""
    cfg, dec_params, params = weights
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    train = ("train_job", {
        "cfg": "tiny4", "params": np_tree(params),
        "batch": _train_batch(cfg),
        "cases": [dict(optimizer="adamw", lr=1e-3, grad_accum=1,
                       pp_micro=2)]})
    runs = {}
    for label, dims, world, jobs in (
            ("pipe2", {"pipe": 2}, 2, [
                ("pipeline_job", {"inputs": _toy(), "n_micro": N_MICRO}),
                ("pipeline_job", {"inputs": _toy(seed=3), "n_micro": (),
                                  "grad": 2}),
                ("decoder_pipeline_job", {
                    "params": np_tree(dec_params),
                    "inputs": _decoder_inputs(cfg, seed=13)}),
                train]),
            ("data2_pipe2", {"data": 2, "pipe": 2}, 4, [
                ("pipeline_job", {"inputs": _toy(), "n_micro": (2,)}),
                ("pipeline_job", {"inputs": _toy(b=3, seed=9),
                                  "n_micro": (3,)}),
                train])):
        url = f"file://{tmp_path_factory.mktemp(label)}/rdv"
        runs[label] = run_ranks(jobs_rank, world, (dims, jobs), init_url=url,
                                timeout_s=4 * RANK_TIMEOUT_S)
    return runs


def _rows(ranks, job, key, b):
    """The ranks' row blocks of one output reassembled (each block must
    agree wherever two ranks hold the same rows)."""
    out = [None] * b
    for r in ranks:
        rows = range(b)[r[job]["rows"]]
        for i, row in zip(rows, r[job]["outs"][key]):
            if out[i] is not None:
                np.testing.assert_array_equal(row, out[i])
            out[i] = row
    return np.stack(out)


@pytest.mark.parametrize("n_micro", N_MICRO)
def test_matches_jax_schedule(pp_mesh, port_runs, n_micro):
    want = _j_toy(pp_mesh, _toy(), n_micro)
    got = _rows(port_runs["pipe2"], 0, n_micro, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_data_and_pipe_match_jax_schedule(pp2_mesh, port_runs):
    want = _j_toy(pp2_mesh, _toy(), 2)
    got = _rows(port_runs["data2_pipe2"], 0, 2, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gradients_match_jax(pp_mesh, port_runs):
    toy = _toy(seed=3)
    extras = {"scale": toy["scale"]}

    def loss(layers, x):
        return (j_pipeline_apply(pp_mesh, _j_layer, layers, x, extras,
                                 n_micro=2) ** 2).sum()

    g_layers, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        {"w": toy["w"], "b": toy["b"]}, toy["x"])
    for r in port_runs["pipe2"]:
        grads = r[1]["grads"]
        for key in ("w", "b"):
            np.testing.assert_allclose(grads[key], np.asarray(g_layers[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(grads["x"], np.asarray(g_x), rtol=1e-4,
                                   atol=1e-4)


def test_indivisible_batch_falls_back_to_replicated(pp_mesh, port_runs):
    toy = _toy(b=3, seed=9)
    want = _j_toy(pp_mesh, toy, 3)
    ranks = port_runs["data2_pipe2"]
    assert all(r[1]["rows"] == slice(None) for r in ranks)
    np.testing.assert_allclose(_rows(ranks, 1, 3, 3), want, rtol=1e-5,
                               atol=1e-5)


def _fake_mesh(**dims) -> Mesh:
    """A rank's view of a mesh with no process groups (the cases that raise
    before any collective, or run on one rank)."""
    sizes = {a: dims.get(a, 1) for a in AXIS_NAMES}
    return Mesh(rank=0, dims=sizes, coords={a: 0 for a in AXIS_NAMES},
                groups={a: None for a in AXIS_NAMES}, world_group=None,
                cpu_group=None, backend=None, device=torch.device("cpu"))


def _port_toy(toy):
    t = {k: torch.from_numpy(v) for k, v in toy.items()}
    return ({"w": t["w"], "b": t["b"]}, t["x"], {"scale": t["scale"]},
            lambda a, lyr, ext: torch.tanh(a @ lyr["w"] + lyr["b"])
            * ext["scale"])


def test_layers_must_divide_stages(pp_mesh):
    layers, x, extras, fn = _port_toy(_toy(n_layers=6))
    with pytest.raises(ValueError, match="divide"):
        pipeline_apply(_fake_mesh(pipe=4), fn, layers, x, extras, 2)
    jl = {k: jnp.asarray(v.numpy()) for k, v in layers.items()}
    with pytest.raises(ValueError, match="divide"):
        j_pipeline_apply(pp_mesh, _j_layer, jl, x.numpy(),
                         {"scale": extras["scale"].numpy()}, 2)
    layers, x, extras, fn = _port_toy(_toy(b=6))
    with pytest.raises(ValueError, match="n_micro"):
        pipeline_apply(_fake_mesh(pipe=2), fn, layers, x, extras, 4)


def test_pipe_one_falls_through():
    mesh = j_create_mesh(JMeshConfig(data=2, fsdp=2, model=2))
    toy = _toy(seed=5)
    want = _j_toy(mesh, toy, 2)
    layers, x, extras, fn = _port_toy(toy)
    got = pipeline_apply(_fake_mesh(data=2, fsdp=2, model=2), fn, layers, x,
                         extras, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_decoder_matches_jax(pp2_mesh, weights, port_runs):
    from karanta_tpu.models.qwen25_vl import decoder as jdec

    cfg, dec_params, _ = weights
    inputs = _decoder_inputs(cfg, seed=13)
    want = jax.jit(lambda p, e, pos: jdec.pipeline_prefill_forward(
        p, cfg.text, e, pos, pp2_mesh, n_micro=2))(
            dec_params, inputs["embeds"], inputs["positions"])
    for r in port_runs["pipe2"]:
        np.testing.assert_allclose(r[2]["out"], np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_decoder_grads_match_jax(pp2_mesh, weights, port_runs):
    from karanta_tpu.models.qwen25_vl import decoder as jdec

    cfg, dec_params, _ = weights
    inputs = _decoder_inputs(cfg, seed=13)

    def loss(p):
        out = jdec.pipeline_prefill_forward(
            p, cfg.text, inputs["embeds"], inputs["positions"], pp2_mesh,
            n_micro=2)
        return (out ** 2).mean()

    want = _flat(jax.jit(jax.grad(loss))(dec_params))
    for r in port_runs["pipe2"]:
        got = r[2]["grads"]
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=5e-4, atol=5e-4,
                                       err_msg=path)


@pytest.fixture(scope="module")
def jax_step(pp2_mesh, weights):
    """The JAX step's loss under make_train_step(pp_mesh=)."""
    from karanta_tpu.models.qwen25_vl.model import param_axes
    from karanta_tpu.parallel.sharding import DEFAULT_RULES, shard_pytree
    from karanta_tpu.training.optimizer import make_optimizer
    from karanta_tpu.training.train_step import (create_train_state,
                                                 make_train_step)

    cfg, _, params = weights
    batch = {k: jnp.asarray(v) for k, v in _train_batch(cfg).items()}
    with pp2_mesh:
        sharded = shard_pytree(params, param_axes(cfg), pp2_mesh,
                               DEFAULT_RULES)
        optimizer = make_optimizer("adamw", 1e-3)
        state = create_train_state(sharded, optimizer)
        step = jax.jit(make_train_step(cfg, optimizer, pp_mesh=pp2_mesh,
                                       pp_micro=2))
        state, metrics = step(state, batch)
    assert int(state.step) == 1
    return float(metrics["loss"])


@pytest.mark.parametrize("layout", ("pipe2", "data2_pipe2"))
def test_full_train_step_matches_jax(jax_step, port_runs, layout):
    for r in port_runs[layout]:
        case = r[-1]["cases"][0]
        np.testing.assert_allclose(case["loss"], jax_step, rtol=1e-4)


def test_sp_and_pp_mutually_exclusive(pp2_mesh):
    from karanta_tpu.training.train_step import make_loss_fn as j_loss_fn
    from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
    from karanta_tpu_torch.training.train_step import make_loss_fn

    mesh = _fake_mesh(seq=2, pipe=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_loss_fn(tiny_config(), sp_mesh=mesh, pp_mesh=mesh)
    with pytest.raises(ValueError, match="mutually exclusive"):
        j_loss_fn(_tiny4(), sp_mesh=pp2_mesh, pp_mesh=pp2_mesh)

"""LoRA and QLoRA of the PyTorch port at fsdp = 2 and model = 2
(``training/lora.py``: the base as each rank's slices, the factors whole)
against the JAX package's ``make_lora_train_step`` on a JAX mesh of the same
shape, float32 on the CPU.

The JAX side builds its base exactly as ``karanta_tpu/training/train.py``
does: ``shard_pytree(params, param_axes(cfg), mesh)``, then
``init_lora_params`` and, for QLoRA, ``quantize_base_nf4`` over the placed
leaves; b gets 0.01 added so that every factor has a gradient. The weights
and factors are carried across (``convert.from_jax_params``). The port's
ranks are spawned gloo processes (``tests/torch_ranks.py``).

Two configurations: the tiny one, where an NF4 target's slice at fsdp = 2
(hidden 64: 32 rows) or model = 2 (``wo``'s 64 inputs: 32 rows) would cut a
64-row absmax block, so the port keeps such a leaf whole over that axis;
and the tiny one widened to hidden 128, 8 heads and MLP 256, where no slice
cuts a block.

Bounds (tests/test_torch_train_parallel.py's): loss rtol 1e-5, grad norm
rtol 1e-4, factors after an AdamW step rtol/atol 2e-4; both ranks equal.

The trainer's CLI runs LoRA as two processes at fsdp = 2 and as one process
on the same global batch (losses within 1e-5), then resumes the two-process
checkpoint in one process.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.parallel.mesh import MeshConfig as JMeshConfig
from karanta_tpu.parallel.mesh import create_mesh as j_create_mesh
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.parallel.launch import run_ranks
from karanta_tpu_torch.training import data as tdata
from tests.test_torch_train_parallel import _cli
from tests.test_torch_training import PIPELINE, make_dataset
from tests.torch_ranks import RANK_TIMEOUT_S, jobs_rank, wide_config

TOK = ByteTokenizer()
JCFGS = {"tiny": j_tiny_config(vocab_size=TOK.vocab_size)}
JCFGS["wide"] = wide_config(JCFGS["tiny"])
LR = 1e-3
RANK = 4
# (config, mesh axis, qlora): block-cutting matters to the NF4 base only,
# so the wide config runs QLoRA
CASES = [("tiny", "fsdp", False), ("tiny", "fsdp", True),
         ("tiny", "model", False), ("tiny", "model", True),
         ("wide", "fsdp", True), ("wide", "model", True)]


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("corpus"), n=4)


@pytest.fixture(scope="module")
def batch(corpus):
    """The global batch: four rows of the tiny corpus, and its window
    count."""
    vision = tiny_config(vocab_size=TOK.vocab_size).vision
    samples = tdata.LocalDataset(
        str(corpus), pipeline_steps=PIPELINE, tokenizer=TOK,
        vision_cfg=vision, max_length=2048).build(num_workers=1)
    grid, seq = tdata.DataCollator.fit_buckets(samples)
    out = tdata.DataCollator(vision, fixed_seq=seq, fixed_grid=grid)(samples)
    return out, int(out.pop("n_windows"))


def _jax_weights(name):
    """Whole JAX parameters and the factors the JAX trainer makes for them
    (``init_lora_params`` draws from shapes and a key only, so placed
    leaves give the same factors), b + 0.01; as numpy."""
    from karanta_tpu.models.qwen25_vl.model import init_params
    from karanta_tpu.training import lora as jl

    params = init_params(JCFGS[name], jax.random.PRNGKey(4), jnp.float32)
    factors = jl.trainable_lora(jl.init_lora_params(
        params, RANK, jax.random.PRNGKey(5), alpha=16.0))
    factors = {g: {n: {"a": f["a"], "b": f["b"] + 0.01}
                   for n, f in factors[g].items()} for g in factors}
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray,
                                                          factors)


def _jax_step(name, axis, qlora, weights, batch, n_windows):
    """The JAX trainer's LoRA setup on a JAX mesh with `axis` = 2
    (``karanta_tpu/training/train.py:159-207``) and one AdamW step: (loss,
    grad norm, tokens, flat factors after the step)."""
    from karanta_tpu.models.qwen25_vl.model import param_axes
    from karanta_tpu.parallel.sharding import DEFAULT_RULES, shard_pytree
    from karanta_tpu.training import lora as jl
    from karanta_tpu.training.optimizer import make_optimizer
    from karanta_tpu.training.train_step import create_train_state

    cfg = JCFGS[name]
    params, factors = weights
    mesh = j_create_mesh(JMeshConfig(data=1, **{axis: 2}))
    with mesh:
        placed = shard_pytree(jax.tree.map(jnp.asarray, params),
                              param_axes(cfg), mesh, DEFAULT_RULES)
        lora = jl.init_lora_params(placed, RANK, jax.random.PRNGKey(5),
                                   alpha=16.0)
        lora = jl.with_factors(lora, jax.tree.map(jnp.asarray, factors))
        base = jl.quantize_base_nf4(placed) if qlora else placed
        optimizer = make_optimizer("adamw", LR)
        state = create_train_state(jl.trainable_lora(lora), optimizer)
        step = jax.jit(jl.make_lora_train_step(cfg, optimizer,
                                               n_windows=n_windows))
        state, m = step(state, base, lora,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(m["loss"]), float(m["grad_norm"]), int(m["tokens"]),
            _flat(state.params))


@pytest.fixture(scope="module")
def runs(batch, tmp_path_factory):
    """Each case's port ranks (one spawn for each axis, its configurations'
    jobs in turn, on a thread while the JAX steps run here) and its JAX
    step."""
    import threading

    data, n_windows = batch
    weights = {name: _jax_weights(name) for name in JCFGS}
    jobs: dict = {}   # axis -> [(config, [cases])]
    for case in CASES:
        per = jobs.setdefault(case[1], [])
        if not per or per[-1][0] != case[0]:
            per.append((case[0], []))
        per[-1][1].append(case)
    boxes: dict = {}

    def spawn():
        for axis, per in jobs.items():
            specs = [("train_job", {
                "cfg": name, "params": weights[name][0], "batch": data,
                "factors": weights[name][1],
                "cases": [dict(optimizer="adamw", lr=LR, grad_accum=1,
                               lora=RANK, qlora=c[2], merge=True)
                          for c in cases]}) for name, cases in per]
            try:
                boxes[axis] = run_ranks(
                    jobs_rank, 2, ({axis: 2}, specs),
                    timeout_s=4 * RANK_TIMEOUT_S,
                    init_url=f"file://{tmp_path_factory.mktemp(axis)}/rdv")
            except BaseException as exc:  # re-raised below
                boxes[axis] = exc

    thread = threading.Thread(target=spawn)
    thread.start()
    want = {case: _jax_step(*case, weights[case[0]], data, n_windows)
            for case in CASES}
    thread.join()
    out = {}
    for axis, per in jobs.items():
        if isinstance(boxes[axis], BaseException):
            raise boxes[axis]
        for j, (_, cases) in enumerate(per):
            for i, case in enumerate(cases):
                out[case] = ([r[j]["cases"][i] for r in boxes[axis]],
                             want[case])
    out["weights"] = weights
    return out


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{n}-{a}2-{'qlora' if q else 'lora'}"
                              for n, a, q in CASES])
def test_lora_step_matches_jax_mesh(runs, case):
    ranks, (loss, grad_norm, tokens, want) = runs[case]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], grad_norm, rtol=1e-4)
        assert got["tokens"] == tokens
        assert set(got["params"]) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got["params"][path], w, rtol=2e-4,
                                       atol=2e-4, err_msg=path)
    a, b = ranks
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for path in a["params"]:
        np.testing.assert_array_equal(a["params"][path], b["params"][path])


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{n}-{a}2-{'qlora' if q else 'lora'}"
                              for n, a, q in CASES])
def test_merged_slices_equal_the_whole_merge(runs, case):
    """merge_lora over a rank's slices (the trainer's eval_params) gathered
    whole: bit-equal to merge_lora of the whole base (NF4 for QLoRA) with
    the rank's factors."""
    import torch

    from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
    from karanta_tpu_torch.training import lora as tl
    from karanta_tpu_torch.utils.tree import flatten_tree
    from tests.torch_ranks import _train_cfg

    name, _, qlora = case
    params = from_jax_params(runs["weights"][name][0], _train_cfg(name),
                             "cpu", torch.float32)
    if qlora:
        params = tl.quantize_base_nf4(params)
    for got in runs[case][0]:
        factors = {g: {n: {k: torch.from_numpy(got["params"][f"{g}/{n}/{k}"])
                           for k in ("a", "b")}
                       for n in (tl.ATTN_TARGETS if g == "attn"
                                 else tl.MLP_TARGETS)}
                   for g in ("attn", "mlp")}
        want = flatten_tree(tl.merge_lora(params, {
            **factors, "alpha": torch.tensor(16.0), "rank": RANK}))
        assert set(got["merged"]) == {
            f"text/layers/{g}/{n}" for g, names in (
                ("attn", tl.ATTN_TARGETS), ("mlp", tl.MLP_TARGETS))
            for n in names}
        for path, w in got["merged"].items():
            np.testing.assert_array_equal(w, want[path].float().numpy(),
                                          err_msg=path)


@pytest.mark.parametrize("axis", ["fsdp", "model"])
def test_nf4_split_keeps_blocks_whole(axis):
    """The QLoRA base's placement: on the tiny config a slice that would
    cut 64-row blocks stays whole (wq/wk/wv/gate/up's 64 rows at fsdp = 2,
    wo's 64 at model = 2; down's 128 split at model = 2); on the wide config
    every target splits as its matrix does. An NF4 leaf's codes and scales
    split alike."""
    from karanta_tpu_torch.training.lora import lora_base_placement
    from tests.test_torch_context_parallel import _fake_mesh

    tiny = tiny_config(vocab_size=TOK.vocab_size)
    mesh = _fake_mesh(**{axis: 2})
    want = {"fsdp": {"wq": {}, "wk": {}, "wv": {}, "gate": {}, "up": {},
                     "wo": {"fsdp": 2}, "down": {"fsdp": 2}},
            "model": {"wq": {"model": 2}, "wk": {"model": 2},
                      "wv": {"model": 2}, "gate": {"model": 2},
                      "up": {"model": 2}, "wo": {}, "down": {"model": 1}}}
    for cfg, cuts in ((tiny, True), (wide_config(tiny), False)):
        place = lora_base_placement(cfg, mesh, nf4=True)
        plain = lora_base_placement(cfg, mesh)
        for name, dims in want[axis].items():
            path = f"text/layers/{'attn' if name[0] == 'w' else 'mlp'}/{name}"
            got = place.dims(path + "/nf4_q")
            assert got == place.dims(path + "/absmax")
            assert got == (dims if cuts else plain.dims(path)), name
        assert plain.dims("text/layers/attn/wq") == (
            {"fsdp": 1} if axis == "fsdp" else {"model": 2})


def test_two_process_lora_matches_one_and_resumes_on_one(corpus, tmp_path):
    """The trainer with use_lora at fsdp = 2 (two processes) gives one
    process's loss on the same global batch; its rank-0 checkpoint (whole
    factors and optimizer state) resumes in one process."""
    import threading

    files = [tmp_path / f"metrics_{pid}.json" for pid in range(3)]
    lora = ("--use_lora", "true", "--lora_rank", "4",
            "--per_device_train_batch_size", "2", "--mesh_data", "1")
    run = tmp_path / "run"
    # the one-process run beside the two-process one
    box = {}
    thread = threading.Thread(target=lambda: box.update(one=_cli(
        corpus, tmp_path / "one", files[2:], 1, lora)))
    thread.start()
    two = _cli(corpus, run, files, 2, lora + ("--mesh_fsdp", "2"),
               url=f"file://{tmp_path}/rdv")
    thread.join()
    assert two[0]["step"] == two[1]["step"] == 3
    assert two[0]["loss"] == two[1]["loss"]
    assert os.path.exists(run / "step_3" / "COMPLETED")
    one = box["one"]
    assert two[0]["loss"] == pytest.approx(one[0]["loss"], rel=1e-5)
    assert two[0]["grad_norm"] == pytest.approx(one[0]["grad_norm"],
                                                rel=1e-4)
    resumed = _cli(corpus, run, files, 1,
                   lora + ("--resume_from_checkpoint", "auto",
                           "--max_steps", "4"))
    assert resumed[0]["step"] == 4 and np.isfinite(resumed[0]["loss"])
    assert os.path.exists(run / "step_4" / "COMPLETED")


def test_wide_config_is_the_jax_one():
    """The wide configuration is the same widening on both sides."""
    wide = wide_config(tiny_config(vocab_size=TOK.vocab_size))
    jwide = JCFGS["wide"]
    for part in ("text", "vision"):
        assert dataclasses.asdict(getattr(wide, part)) == \
            dataclasses.asdict(getattr(jwide, part))

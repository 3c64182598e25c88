"""Parallel training of the PyTorch port (``training/train_step.py``'s
``ParallelPlan``, ``training/train.py`` over several processes) against the
JAX package's ``make_train_step`` on the same mesh shapes, float32 on the
CPU, with the JAX weights carried across (``convert.from_jax_params``).

The port's ranks are spawned gloo processes (``tests/torch_ranks.py``), two
at a time: data = 2 with gradient accumulation 2 over rows of unequal
token counts (each global microbatch's loss is its token sum over its own
token count, so a rank must hold a share of every microbatch), fsdp = 2
under AdamW and Muon, model = 2, and seq = 2 with an image whose tokens
straddle the chunk boundary; LoRA at data = 2 and seq = 2 (at fsdp = 2 and
model = 2: tests/test_torch_lora_parallel.py). The global batch
is four rows of the tiny corpus, and every rank is given all of it.

Bounds: loss rtol 1e-5, grad norm rtol 1e-4, parameters after an AdamW
step rtol/atol 2e-4, except the key biases, whose exact gradient is zero (a
shift of every key leaves the softmax unchanged): their Adam updates are
rounding noise scaled to the learning rate and are held within 3 learning
rates, as in tests/test_torch_training.py. Muon: against the port's own
one-rank step rtol/atol 2e-4; against JAX each leaf's change within 5%
normwise (XLA sums the Newton-Schulz products in another order:
tests/test_torch_optimizer.py).

The CLI twin of tests/test_multiprocess_train.py runs the trainer as two
processes at data = 2, one at data = 1 on the same global batch, and a
resume of the two-process checkpoint at fsdp = 2.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.parallel.mesh import MeshConfig as JMeshConfig
from karanta_tpu.parallel.mesh import create_mesh as j_create_mesh
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.parallel.launch import run_ranks
from karanta_tpu_torch.parallel.mesh import create_mesh
from karanta_tpu_torch.training import data as tdata
from tests.test_torch_training import PIPELINE, make_dataset
from tests.torch_ranks import RANK_TIMEOUT_S, jobs_rank, train_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = ByteTokenizer()
JCFG4 = j_tiny_config(vocab_size=TOK.vocab_size)
JCFG4 = dataclasses.replace(JCFG4, text=dataclasses.replace(JCFG4.text,
                                                            num_layers=4))
LR = 1e-3
ADAMW = dict(optimizer="adamw", lr=LR, grad_accum=1)
MUON = dict(optimizer="muon", lr=LR, grad_accum=1)
# (label, mesh, port cases): the JAX step of each case runs on a JAX mesh
# of the same shape
MESHES = {
    "data2": ({"data": 2}, [dict(ADAMW, grad_accum=2)]),
    "fsdp2": ({"fsdp": 2}, [ADAMW, MUON]),
    "model2": ({"model": 2}, [ADAMW]),
    "seq2": ({"seq": 2}, [dict(ADAMW, sp=True)]),
}


def _straddle(sample: dict, at: int) -> dict:
    """The sample with filler text before it and as many prompt tokens
    taken out after its image, so that its image tokens straddle position
    `at` (same length; the positions after each edit shifted to stay
    consecutive)."""
    plan = sample["plan"]
    n_img = (plan.grid_h // 2) * (plan.grid_w // 2)
    start = int(sample["image_start"])
    k = at - start - n_img // 2
    cut = start + n_img + 8
    ids, labels, pos = (sample[key] for key in ("input_ids", "labels",
                                                "positions"))
    assert (labels[:cut + k] == -100).all()
    filler = np.full((k,), ord("x") + 3, ids.dtype)
    out = dict(sample)
    out["input_ids"] = np.concatenate([filler, ids[:cut], ids[cut + k:]])
    out["labels"] = np.concatenate([np.full((k,), -100, labels.dtype),
                                    labels[:cut], labels[cut + k:]])
    out["positions"] = np.concatenate(
        [np.tile(np.arange(k, dtype=pos.dtype), (3, 1)), pos[:, :cut] + k,
         pos[:, cut + k:]], axis=1)
    out["image_start"] = start + k
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("corpus"), n=4)


@pytest.fixture(scope="module")
def setup(corpus):
    """JAX tiny-4 weights and the global batch: four rows of unequal token
    counts, each image straddling the middle of the sequence."""
    from karanta_tpu.models.qwen25_vl.model import init_params

    vision = tiny_config(vocab_size=TOK.vocab_size).vision
    samples = tdata.LocalDataset(
        str(corpus), pipeline_steps=PIPELINE, tokenizer=TOK,
        vision_cfg=vision, max_length=2048).build(num_workers=1)
    grid, seq = tdata.DataCollator.fit_buckets(samples)
    samples = [_straddle(s, seq // 2) for s in samples]
    batch = tdata.DataCollator(vision, fixed_seq=seq,
                               fixed_grid=grid)(samples)
    n_windows = int(batch.pop("n_windows"))
    counts = (batch["labels"] != -100).sum(1)
    assert len(set(counts.tolist())) == 4, counts
    img = batch["image_positions"][:, 0]
    assert ((img < seq // 2) & (img + 6 > seq // 2)).all()
    params = init_params(JCFG4, jax.random.PRNGKey(4), jnp.float32)
    return params, batch, n_windows


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_step(params, batch, n_windows, dims, case):
    """The JAX step of one case on a JAX mesh of the port's shape: (loss,
    grad norm, tokens, flat parameters after the step)."""
    from karanta_tpu.models.qwen25_vl.model import param_axes
    from karanta_tpu.parallel.sharding import DEFAULT_RULES, shard_pytree
    from karanta_tpu.training.optimizer import make_optimizer
    from karanta_tpu.training.train_step import (create_train_state,
                                                 make_train_step)

    mesh = j_create_mesh(JMeshConfig(**{"data": 1, **dims}))
    with mesh:
        sharded = shard_pytree(params, param_axes(JCFG4), mesh,
                               DEFAULT_RULES)
        optimizer = make_optimizer(case["optimizer"], case["lr"])
        state = create_train_state(sharded, optimizer)
        step = jax.jit(make_train_step(
            JCFG4, optimizer, grad_accum=case["grad_accum"],
            n_windows=n_windows,
            sp_mesh=mesh if case.get("sp") else None))
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(m["loss"]), float(m["grad_norm"]), int(m["tokens"]),
            _flat(state.params))


def _spawn_all(runs: dict, tmp_path_factory) -> dict:
    """run_ranks of each {label: (dims, jobs)} in turn, on a thread of
    their own while the caller goes on (two ranks at a time beside the
    caller's work); returns {label: result box}."""
    import threading

    boxes = {label: {} for label in runs}

    def run():
        for label, (dims, jobs) in runs.items():
            try:
                boxes[label]["ranks"] = run_ranks(
                    jobs_rank, 2, (dims, jobs),
                    timeout_s=4 * RANK_TIMEOUT_S,
                    init_url=f"file://{tmp_path_factory.mktemp(label)}/rdv")
            except BaseException as exc:  # re-raised by _join
                boxes[label]["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    for box in boxes.values():
        box["thread"] = thread
    return boxes


@contextlib.contextmanager
def _threads(n: int):
    """torch's intra-op threads in this process set to n for the block."""
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _join(box: dict) -> list:
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    return box["ranks"]


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Every mesh's port ranks (one spawn a mesh, all at once), the port's
    one-rank steps and the JAX steps."""
    params, batch, n_windows = setup
    spec = {"cfg": "tiny4", "params": _np_tree(params), "batch": batch}
    boxes = _spawn_all({label: (dims, [("train_job",
                                        {**spec, "cases": cases})])
                        for label, (dims, cases) in MESHES.items()},
                       tmp_path_factory)
    out = {}
    one = create_mesh(device="cpu")
    with _threads(2):  # beside two rank processes and other test workers
        for label, (dims, cases) in MESHES.items():
            out[label] = {
                "one": train_job(one, {**spec, "cases": [
                    {k: v for k, v in c.items() if k != "sp"}
                    for c in cases]})["cases"],
                "jax": [_jax_step(params, batch, n_windows, dims, c)
                        for c in cases]}
    for label in MESHES:
        out[label]["ranks"] = [r[0]["cases"] for r in _join(boxes[label])]
    return out


CASES = [(label, i) for label, (_, cases) in MESHES.items()
         for i in range(len(cases))]


def _case_id(case):
    label, i = case
    return f"{label}-{MESHES[label][1][i]['optimizer']}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_step_matches_jax(runs, case):
    label, i = case
    loss, grad_norm, tokens, want = runs[label]["jax"][i]
    muon = MESHES[label][1][i]["optimizer"] == "muon"
    for rank in runs[label]["ranks"]:
        got = rank[i]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], grad_norm, rtol=1e-4)
        assert got["tokens"] == tokens
        assert set(got["params"]) == set(want)
        if muon:  # test_muon_change_within_jax_bound
            continue
        for path, w in want.items():
            have = got["params"][path]
            if path.endswith("attn/bk"):
                assert np.abs(have - w).max() <= 3 * LR, path
            else:
                np.testing.assert_allclose(have, w, rtol=2e-4, atol=2e-4,
                                           err_msg=path)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_step_matches_one_rank(runs, case):
    """Both ranks equal each other and the port's one-rank step (Muon's
    whole-matrix update included)."""
    label, i = case
    one = runs[label]["one"][i]
    for rank in runs[label]["ranks"]:
        got = rank[i]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"],
                                   rtol=1e-4)
        for path, w in one["params"].items():
            if path.endswith("attn/bk"):
                assert np.abs(got["params"][path] - w).max() <= 3 * LR
            else:
                np.testing.assert_allclose(got["params"][path], w, rtol=2e-4,
                                           atol=2e-4, err_msg=path)
    a, b = (r[i] for r in runs[label]["ranks"])
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]


def test_muon_change_within_jax_bound(setup, runs):
    """fsdp = 2 under Muon against JAX: each Muon-labelled leaf's change
    within 5% normwise of JAX's (the Adam-labelled leaves within 2e-4)."""
    from karanta_tpu_torch.training.optimizer import default_label_fn

    params, _, _ = setup
    p0 = _flat(params)
    i = [c["optimizer"] for c in MESHES["fsdp2"][1]].index("muon")
    _, _, _, want = runs["fsdp2"]["jax"][i]
    for rank in runs["fsdp2"]["ranks"]:
        got = rank[i]["params"]
        for path, w in want.items():
            if path.endswith("attn/bk"):
                continue
            if default_label_fn(path, torch.from_numpy(got[path])) == "muon":
                dj, dt = w - p0[path], got[path] - p0[path]
                assert np.linalg.norm(dt - dj) <= \
                    5e-2 * np.linalg.norm(dj), path
            else:
                np.testing.assert_allclose(got[path], w, rtol=2e-4,
                                           atol=2e-4, err_msg=path)


def test_microbatch_grouping_needs_every_microbatch(setup, runs):
    """The data = 2 x grad-accum 2 loss is the JAX mean over the two global
    microbatches of their own token-weighted losses; averaging each rank's
    contiguous block instead gives another number on these rows."""
    _, batch, _ = setup
    counts = (batch["labels"] != -100).sum(1)
    assert counts[0] + counts[1] != counts[2] + counts[3]
    loss = runs["data2"]["jax"][0][0]
    for rank in runs["data2"]["ranks"]:
        np.testing.assert_allclose(rank[0]["loss"], loss, rtol=1e-5)


@pytest.fixture(scope="module")
def lora_runs(setup, tmp_path_factory):
    params, batch, _ = setup
    spec = {"cfg": "tiny4", "params": _np_tree(params), "batch": batch}
    case = dict(ADAMW, lora=4, grads=True)
    boxes = _spawn_all({label: (dims, [("train_job", {**spec, "cases": [
        dict(case, sp=(label == "seq2"))]})])
        for label, dims in (("data2", {"data": 2}), ("seq2", {"seq": 2}))},
        tmp_path_factory)
    with _threads(2):
        one = train_job(create_mesh(device="cpu"), {**spec,
                                                    "cases": [case]})
    return one["cases"][0], {label: _join(box)
                             for label, box in boxes.items()}


@pytest.mark.parametrize("label", ("data2", "seq2"))
def test_lora_step_matches_one_rank(lora_runs, label):
    one, out = lora_runs
    for r in out[label]:
        got = r[0]["cases"][0]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"],
                                   rtol=1e-4)
        for path, w in one["grads"].items():
            np.testing.assert_allclose(got["grads"][path], w, rtol=2e-4,
                                       atol=1e-6, err_msg=path)
        for path, w in one["params"].items():
            np.testing.assert_allclose(got["params"][path], w, rtol=2e-4,
                                       atol=2e-4, err_msg=path)


# ---------------------------------------------------------------------------
# the trainer's CLI over processes
# ---------------------------------------------------------------------------

TRAIN_SCRIPT = """
import json, sys
from karanta_tpu_torch.training.train import main
metrics = main(json.loads(sys.argv[1]))
with open(sys.argv[2], "w") as f:
    json.dump(metrics, f)
"""
CLI_TIMEOUT_S = 240


def _cli(root, out_dir, metric_files, world, extra=(), url=None):
    """Run the trainer as `world` processes (one when world is 1); returns
    each process's metrics. Fails on a nonzero exit or a hang."""
    procs = []
    for pid in range(world):
        argv = ["--dataset_root", str(root), "--output_dir", str(out_dir),
                "--model_name_or_path", "tiny", "--device", "cpu",
                "--gradient_accumulation_steps", "1",
                "--logging_steps", "1", "--checkpointing_steps", "2",
                "--eval_steps", "0", "--learning_rate", "0.001",
                "--dtype", "float32", *extra]
        if "--max_steps" not in extra:
            argv += ["--max_steps", "3"]
        if world > 1:
            argv += ["--coordinator_address", url, "--num_processes",
                     str(world), "--process_id", str(pid)]
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TRAIN_SCRIPT, json.dumps(argv),
             str(metric_files[pid])], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outputs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-3000:]
    return [json.load(open(m)) for m in metric_files[:world]]


def test_two_process_training_matches_one_and_resumes(corpus, tmp_path):
    files = [tmp_path / f"metrics_{pid}.json" for pid in range(2)]
    run = tmp_path / "run"
    two = _cli(corpus, run, files, 2,
               ("--mesh_data", "2", "--per_device_train_batch_size", "1"),
               url=f"file://{tmp_path}/rdv")
    # identical final loss on both processes (the loss is the global one)
    assert two[0]["step"] == two[1]["step"] == 3
    assert np.isfinite(two[0]["loss"])
    assert two[0]["loss"] == pytest.approx(two[1]["loss"], rel=1e-6)
    # one checkpoint a save, written by rank 0, marked COMPLETED
    assert os.path.exists(run / "step_3" / "COMPLETED")
    assert os.path.exists(run / "step_3" / "metadata.json")
    assert sorted(os.listdir(run)) == ["step_2", "step_3"]
    # one process on the same global batch (2 rows a step)
    one = _cli(corpus, tmp_path / "one", files, 1,
               ("--mesh_data", "1", "--per_device_train_batch_size", "2"))
    assert two[0]["loss"] == pytest.approx(one[0]["loss"], rel=1e-5)
    assert two[0]["grad_norm"] == pytest.approx(one[0]["grad_norm"],
                                                rel=1e-4)
    # the data = 2 checkpoint restores at fsdp = 2 and trains on
    resumed = _cli(corpus, run, files, 2,
                   ("--mesh_data", "1", "--mesh_fsdp", "2",
                    "--per_device_train_batch_size", "2",
                    "--resume_from_checkpoint", "auto", "--max_steps", "4"),
                   url=f"file://{tmp_path}/rdv2")
    assert resumed[0]["step"] == resumed[1]["step"] == 4
    assert resumed[0]["loss"] == pytest.approx(resumed[1]["loss"], rel=1e-6)
    assert os.path.exists(run / "step_4" / "COMPLETED")

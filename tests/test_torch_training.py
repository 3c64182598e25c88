"""The port's training path (karanta_tpu_torch.training) against the JAX
package's on the tiny config, float32 on the CPU.

Parameters come from the JAX package's init_params through from_jax_params;
the data from the same PDFs through both packages' pipelines. Tolerances:
losses rtol 1e-5; gradient leaves atol 2e-6 + rtol 1e-3 (float32 sums in
another order over the layers); parameters after 3 optimizer steps atol
1e-6 (each step moves them by about the learning rate, so a wrong update
shows); the collator's arrays equal.
"""

import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.layout import mrope_positions
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu.training import data as jdata
from karanta_tpu.training import optimizer as jopt
from karanta_tpu.training import train_step as jts
from karanta_tpu_torch import kernels
from karanta_tpu_torch.inference.engine import Engine, EngineConfig, GenRequest
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.training import checkpoint as ckpt
from karanta_tpu_torch.training import data as tdata
from karanta_tpu_torch.training import optimizer as topt
from karanta_tpu_torch.training import train_step as tts
from karanta_tpu_torch.training.train import to_device_batch
from karanta_tpu_torch.utils.tree import flatten_tree

TOK = ByteTokenizer()
JCFG = j_tiny_config(vocab_size=TOK.vocab_size)
CFG = tiny_config(vocab_size=TOK.vocab_size)
# four decoder layers for the optimizer-step parity: XLA's CPU product for
# matrices of fewer than 4 rows rounds differently from its own batched
# product (see test_torch_optimizer.py), and the stacked (L, n) leaves are
# orthogonalized by Muon
JCFG4 = dataclasses.replace(JCFG, text=dataclasses.replace(JCFG.text,
                                                           num_layers=4))
CFG4 = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text,
                                                         num_layers=4))
PIPELINE = [
    {"name": "PDF2ImageStep", "target_longest_image_dim": 128},
    {"name": "FetchPageData"},
    {"name": "StaticLengthDocumentAnchoring", "target_anchor_text_len": 1000},
    {"name": "FinetuningPrompt"},
    {"name": "JSONOutputFormat"},
    {"name": "InstructUserMessages"},
    {"name": "Tokenizer"},
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(jparams, cfg=CFG):
    return from_jax_params(_np(jparams), cfg, "cpu", torch.float32)


def tdata_to_torch(batch):
    return to_device_batch(batch, "cpu")


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_grads(got: dict, want_tree, atol=2e-6, rtol=1e-3):
    want = _flat_jax(want_tree)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=path)


def make_dataset(root, n=3):
    """Scanned JPEG PDFs and ground-truth JSON, texts of different lengths
    (so a batch of two carries a pad mask)."""
    from PIL import Image

    from karanta_tpu.pdf.primitives import convert_image_to_pdf_bytes

    (root / "pdfs").mkdir(parents=True)
    (root / "json").mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        img = Image.fromarray(rng.integers(150, 255, (80, 64, 3),
                                           dtype=np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        (root / "pdfs" / f"doc{i}.pdf").write_bytes(
            convert_image_to_pdf_bytes(buf.getvalue()))
        page = {"primary_language": "en", "is_rotation_valid": True,
                "rotation_correction": 0, "is_table": False,
                "is_diagram": False,
                "natural_text": f"ground truth text {i} " * (i + 1)}
        (root / "json" / f"doc{i}.json").write_text(
            json.dumps({"result": {"text": json.dumps([page])}}))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def batches(corpus):
    """(JAX samples, port samples, JAX collated batch, port collated batch);
    the batches over docs 0 and 2."""
    jds = jdata.LocalDataset(str(corpus), pipeline_steps=PIPELINE,
                             tokenizer=JByteTokenizer(),
                             vision_cfg=JCFG.vision, max_length=2048)
    tds = tdata.LocalDataset(str(corpus), pipeline_steps=PIPELINE,
                             tokenizer=TOK, vision_cfg=CFG.vision,
                             max_length=2048)
    js, ts = jds.build(num_workers=1), tds.build(num_workers=1)
    jb = jdata.DataCollator(JCFG.vision)([js[0], js[2]])
    tb = tdata.DataCollator(CFG.vision)([ts[0], ts[2]])
    return js, ts, jb, tb


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)


def test_dataset_and_collator_match_jax(batches):
    js, ts, jb, tb = batches
    assert len(js) == len(ts) == 3
    for a, b in zip(js, ts):
        assert dataclasses.astuple(a["plan"]) == dataclasses.astuple(b["plan"])
        for key in ("input_ids", "labels", "positions", "image_u8"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert set(jb) == set(tb)
    for key, value in jb.items():
        if key == "pixel_values":  # normalised in another float32 order
            np.testing.assert_allclose(tb[key], np.asarray(value), atol=1e-6,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(np.asarray(value),
                                          np.asarray(tb[key]), err_msg=key)
    assert tb["attn_mask"].min() == 0.0  # the batch carries a pad mask
    assert (tb["labels"] != -100).sum(1).min() > 50  # responses are kept
    assert tdata.SEQ_BUCKETS == jdata.SEQ_BUCKETS
    assert set(tdata.str2PipelineStep) == set(jdata.str2PipelineStep)
    assert tdata.DataCollator.fit_buckets(ts) == \
        jdata.DataCollator.fit_buckets(js)


def test_forward_train_loss_and_grads_match_jax(batches, jparams):
    """Vision and decoder, a batch of two with a pad mask: the loss and every
    gradient leaf, wq/wk/wv included (they reach the loss only through the
    attention kernels' autograd functions)."""
    _, _, jb, tb = batches
    n_windows = int(jb["n_windows"])
    jbatch = {k: jnp.asarray(v) for k, v in jb.items() if k != "n_windows"}
    (jloss, jtok), jgrads = jax.value_and_grad(
        jts.make_loss_fn(JCFG, n_windows=n_windows), has_aux=True)(
            jparams, jbatch)
    loss, tokens, grads = tts.value_and_grad(
        tts.make_loss_fn(CFG), _port_params(jparams),
        tdata_to_torch(tb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(tokens) == int(jtok)
    _check_grads(grads, jgrads)
    for group, names in (("visual/blocks/attn", "wq wk wv"),
                         ("text/layers/attn", "wq wk wv")):
        for name in names.split():
            assert float(grads[f"{group}/{name}"].abs().max()) > 0, name


def test_chunked_cross_entropy_matches_materialized_logits(jparams):
    from karanta_tpu_torch.models.qwen25_vl.model import forward_train

    params = _port_params(jparams)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, CFG.text.vocab_size, (2, 16)))
    pos = torch.arange(16)[None, None].expand(3, 2, 16)
    labels = torch.where(torch.arange(16)[None] < 4, -100, ids)
    logits = forward_train(params, CFG, ids, pos)
    ref, ref_n = tts.cross_entropy_loss(logits[:, :-1], labels[:, 1:])
    jref, _ = jts.cross_entropy_loss(jnp.asarray(logits[:, :-1].detach()),
                                     jnp.asarray(labels[:, 1:]))
    np.testing.assert_allclose(float(ref), float(jref), rtol=1e-6)
    batch = {"token_ids": ids, "positions": pos, "labels": labels}
    loss, n = tts.make_loss_fn(CFG)(params, batch)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    assert int(n) == int(ref_n)
    hidden = forward_train(params, CFG, ids, pos, return_hidden=True)
    shifted = torch.cat([labels[:, 1:], torch.full((2, 1), -100)], 1)
    for chunk in (4, 5):
        lc, nc = tts.chunked_cross_entropy(params["text"], CFG.text, hidden,
                                           shifted, chunk=chunk)
        np.testing.assert_allclose(float(lc), float(ref), rtol=1e-5)
        assert int(nc) == int(ref_n)


def test_remat_matches_no_remat(batches, jparams):
    """Checkpointing per decoder layer and per vision block changes memory,
    not numerics: the same loss and gradients to float32 rounding."""
    _, _, _, tb = batches
    batch = tdata_to_torch(tb)
    out = {}
    for remat in (False, True):
        out[remat] = tts.value_and_grad(tts.make_loss_fn(CFG, remat=remat),
                                        _port_params(jparams), batch)
    assert float(out[True][0]) == pytest.approx(float(out[False][0]),
                                                rel=1e-6)
    for path, g in out[False][2].items():
        torch.testing.assert_close(out[True][2][path], g, atol=1e-7,
                                   rtol=1e-5, msg=path)


def _text_batch(rows, seq=16, seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, size=(rows, seq)).astype(np.int32)
    pos = np.stack([mrope_positions(r, [], JCFG.image_token_id)
                    for r in ids], axis=1)
    return {"token_ids": ids, "positions": pos, "labels": ids}


def test_grad_accum_matches_full_batch(jparams):
    """Two microbatches of two rows and one batch of four, every row with
    the same token count: the same mean loss and gradients."""
    params = _port_params(jparams)
    batch = tdata_to_torch(_text_batch(4))
    loss_fn = tts.make_loss_fn(CFG)
    full = tts.accumulate_grads(
        lambda mb: tts.value_and_grad(loss_fn, params, mb), params, batch, 1)
    accum = tts.accumulate_grads(
        lambda mb: tts.value_and_grad(loss_fn, params, mb), params, batch, 2)
    np.testing.assert_allclose(float(accum[1]), float(full[1]), rtol=1e-6)
    assert int(accum[2]) == int(full[2])
    for path, g in full[0].items():
        torch.testing.assert_close(accum[0][path], g, atol=1e-7, rtol=1e-4,
                                   msg=path)


@pytest.fixture(scope="module")
def three_steps():
    """Three make_train_step steps of each optimizer in both packages, from
    the same parameters, over the same text batches (grad-accum 2, the
    cosine schedule with warmup, clipping at 1.0)."""
    jp0 = j_init_params(JCFG4, jax.random.PRNGKey(1), jnp.float32)
    out = {}
    for name in ("adamw", "muon"):
        jo = jopt.make_optimizer(name, jopt.make_lr_schedule(
            "cosine", 3e-3, 1, 3), weight_decay=0.01, max_grad_norm=1.0)
        to = topt.make_optimizer(name, topt.make_lr_schedule(
            "cosine", 3e-3, 1, 3), weight_decay=0.01, max_grad_norm=1.0)
        jstate = jts.create_train_state(jp0, jo)
        jstep = jax.jit(jts.make_train_step(JCFG4, jo, grad_accum=2))
        tstate = tts.create_train_state(_port_params(jp0, CFG4), to)
        tstep = tts.make_train_step(CFG4, to, grad_accum=2)
        metrics = []
        for i in range(3):
            batch = _text_batch(4, seed=10 + i)
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            tstate, tm = tstep(tstate, tdata_to_torch(batch))
            metrics.append((jm, tm))
        out[name] = (jstate, tstate, metrics)
    out["p0"] = jp0
    return out


@pytest.mark.parametrize("name", ["adamw", "muon"])
def test_three_train_steps_match_jax(three_steps, name):
    """Losses, token counts and gradient norms of each step, then every
    parameter after 3 steps. AdamW: within 1e-6. Muon: each leaf's change
    within 5% normwise of JAX's, since its bf16 Newton-Schulz turns the
    float32 rounding of the gradients into bf16 rounding flips (the port's
    Muon on equal gradients matches JAX's: test_torch_optimizer.py). The
    key biases' exact gradient is zero (a shift of every key leaves the
    softmax unchanged), so their updates are rounding noise scaled to the
    learning rate: held within 3 learning rates."""
    jstate, tstate, metrics = three_steps[name]
    for jm, tm in metrics:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert int(tm["tokens"]) == int(jm["tokens"])
    assert int(tstate.step) == int(jstate.step) == 3
    got = flatten_tree(tstate.params)
    p0 = _flat_jax(three_steps["p0"])
    for path, want in _flat_jax(jstate.params).items():
        have = got[path].numpy()
        if path.endswith("attn/bk"):
            assert np.abs(have - want).max() <= 3 * 3e-3, path
        elif name == "adamw":
            np.testing.assert_allclose(have, want, atol=1e-6, rtol=0,
                                       err_msg=path)
        else:
            dj, dt = want - p0[path], have - p0[path]
            assert np.linalg.norm(dt - dj) <= 5e-2 * np.linalg.norm(dj), path


def test_native_checkpoint_serves_the_trained_params(three_steps, tmp_path):
    """A checkpoint written by the port's trainer, served by the port's
    server CLI (--native-checkpoint over the run dir), greedy-decodes the
    text of an engine built from the same parameters in memory."""
    from karanta_tpu_torch.inference import server as S
    from karanta_tpu_torch.models.qwen25_vl.model import init_params

    cfg = tiny_config(vocab_size=TOK.vocab_size)
    params = init_params(cfg, 5, torch.float32, device="cpu")
    opt = topt.make_optimizer("adamw", 1e-3)
    state = tts.create_train_state(params, opt)
    step = tts.make_train_step(cfg, opt)
    state, _ = step(state, tdata_to_torch(_text_batch(2)))
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    ckpt.save_checkpoint(str(tmp_path), 2, state, keep_last=1)
    assert [s for s, _ in ckpt.checkpoint_dirs(str(tmp_path))] == [2]
    engine, name = S.build_engine_from_args(S.make_arg_parser().parse_args(
        ["--preset", "tiny", "--device", "cpu", "--max-batch-size", "1",
         "--max-model-len", "256", "--native-checkpoint", str(tmp_path)]))
    assert name == "native-step_2"
    msgs = [{"role": "user", "content": "hello there"}]
    served = engine.generate([GenRequest(messages=msgs, max_tokens=12)])
    ref = Engine(state.params, cfg, ByteTokenizer(), engine.ecfg,
                 device="cpu")
    want = ref.generate([GenRequest(messages=msgs, max_tokens=12)])
    assert served[0].token_ids == want[0].token_ids
    assert served[0].text == want[0].text
    with pytest.raises(SystemExit, match="tokenizer-path"):
        S.build_engine_from_args(S.make_arg_parser().parse_args(
            ["--preset", "qwen2.5-vl-3b", "--device", "cpu",
             "--native-checkpoint", str(tmp_path)]))


def test_checkpoint_round_trip(tmp_path):
    params = {"a": {"w": torch.randn(3, 4)}, "b": torch.arange(5)}
    opt = topt.make_optimizer("muon", 1e-3)
    state = tts.create_train_state({"a": {"w": torch.randn(4, 4)},
                                    "embed": torch.randn(6, 4)}, opt)
    path = ckpt.save_checkpoint(str(tmp_path), 7, state, {"note": "x"})
    assert os.path.exists(os.path.join(path, ckpt.COMPLETED))
    restored, meta = ckpt.restore_checkpoint(path, state)
    assert meta == {"step": 7, "note": "x"}
    for key, leaf in flatten_tree(ckpt._as_tree(state)).items():
        assert torch.equal(flatten_tree(ckpt._as_tree(restored))[key], leaf)
    got, _ = ckpt.restore_params(path, device="cpu")
    assert torch.equal(got["a"]["w"], state.params["a"]["w"])
    ckpt.save_checkpoint(str(tmp_path), 8, {"params": params}, keep_last=0)
    # a step dir without its marker is not a resume point
    os.remove(os.path.join(tmp_path, "step_8", ckpt.COMPLETED))
    assert ckpt.get_last_checkpoint(str(tmp_path)) == path
    assert ckpt.get_last_checkpoint(str(tmp_path), incomplete=True) \
        .endswith("step_8")


def test_train_cli_trains_saves_and_resumes(corpus, tmp_path):
    from karanta_tpu_torch.training.train import main

    out = tmp_path / "run"
    argv = ["--dataset_root", str(corpus), "--output_dir", str(out),
            "--model_name_or_path", "tiny", "--mesh_data", "1",
            "--max_steps", "3", "--gradient_accumulation_steps", "1",
            "--per_device_train_batch_size", "2", "--logging_steps", "1",
            "--checkpointing_steps", "2", "--eval_steps", "0",
            "--learning_rate", "0.001", "--dtype", "float32",
            "--device", "cpu", "--gradient_checkpointing", "true"]
    kernels.reset_launches()
    metrics = main(argv)
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    assert os.path.exists(out / "step_3" / "COMPLETED")
    assert sum(kernels.LAUNCHES.values()) == 0  # the CPU runs no kernel
    argv2 = list(argv)
    argv2[argv2.index("--max_steps") + 1] = "4"
    metrics2 = main(argv2 + ["--resume_from_checkpoint", "auto"])
    assert metrics2["step"] == 4
    # one process asking for a mesh wider than its world: MeshConfig.resolve
    # refuses it, as the JAX package's does
    with pytest.raises(ValueError, match="does not cover"):
        main(argv + ["--mesh_fsdp", "2"])


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_trainer_sets_the_precision_switches_on_the_card(monkeypatch,
                                                         device):
    """main() turns TF32 and cuBLAS's reduced-precision reductions off
    before it builds anything when its device is a card (as the engine
    does), and leaves them alone on the CPU. The device check is
    monkeypatched, and the run stops at the mesh."""
    import karanta_tpu_torch.device as tdevice
    import karanta_tpu_torch.parallel.mesh as tmesh
    from karanta_tpu_torch.training.train import main

    calls = []

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        calls.append("mesh")
        raise Stop

    monkeypatch.setattr(tdevice, "resolve_device",
                        lambda d=None: torch.device(device))
    monkeypatch.setattr(tdevice, "no_tf32", lambda: calls.append("tf32"))
    monkeypatch.setattr(tdevice, "float32_reductions",
                        lambda: calls.append("reductions"))
    monkeypatch.setattr(tmesh, "create_mesh", stop)
    with pytest.raises(Stop):
        main(["--model_name_or_path", "tiny"])
    assert calls == (["tf32", "reductions", "mesh"] if device == "cuda"
                     else ["mesh"])


def test_epoch_sampler_matches_jax():
    from karanta_tpu.training.train import EpochSampler as JSampler
    from karanta_tpu_torch.training.train import EpochSampler

    a, b = EpochSampler(7, 13), JSampler(7, 13)
    assert [a.index(p) for p in (17, 3, 22, 0, 12, 13, 40)] == \
        [b.index(p) for p in (17, 3, 22, 0, 12, 13, 40)]


def test_config_parser_matches_jax():
    from karanta_tpu.config import ConfigParser as JParser
    from karanta_tpu.training.train import (DatasetArguments as JD,
                                            ExperimentArguments as JE,
                                            ModelArguments as JM)
    from karanta_tpu_torch.config import ConfigParser
    from karanta_tpu_torch.training.train import (DatasetArguments,
                                                  ExperimentArguments,
                                                  ModelArguments)

    argv = ["configs/training/ocr/karanta_qwen25_3b.yaml", "--max_steps",
            "3", "--use_qlora", "true", "--lora_rank", "8"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv[0] = os.path.join(repo, argv[0])
    got = ConfigParser([ExperimentArguments, ModelArguments,
                        DatasetArguments]).parse(argv)
    want = JParser([JE, JM, JD]).parse(argv)
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        gd.pop("device", None)
        assert gd == wd


def test_remat_relaunches_the_attention_kernels(batches, jparams,
                                                monkeypatch):
    """Counting the kernel wrappers' calls (the plain versions run here):
    without remat the forward calls #1 for every window layer of each image
    and #2 for every full vision layer and decoder layer; with remat the
    backward's recompute calls each once more. The backward itself calls
    neither."""
    from karanta_tpu_torch.ops import attention as A

    calls = {"window": 0, "flash": 0}
    flash, window = A.flash_attention, A.window_attention_kernel_call

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(A, "flash_attention", counted("flash", flash))
    monkeypatch.setattr(A, "window_attention_kernel_call",
                        counted("window", window))
    _, _, _, tb = batches
    rows = tb["token_ids"].shape[0]
    n_full = len(CFG.vision.fullatt_block_indexes)
    forward = {"window": (CFG.vision.depth - n_full) * rows,
               "flash": n_full * rows + CFG.text.num_layers}
    for remat, times in ((False, 1), (True, 2)):
        calls.update(window=0, flash=0)
        tts.value_and_grad(tts.make_loss_fn(CFG, remat=remat),
                           _port_params(jparams), tdata_to_torch(tb))
        assert calls == {k: v * times for k, v in forward.items()}, remat


def test_profile_step_writes_a_trace_and_a_summary(tmp_path):
    """--is_profile's step: the result passes through, a Chrome trace and a
    summary with the operator table are written."""
    from karanta_tpu_torch.utils.profiling import profile_step

    out = profile_step(lambda a, b: a @ b, (torch.ones(4, 4),
                                            torch.ones(4, 4)), 7,
                       str(tmp_path))
    assert torch.equal(out, torch.full((4, 4), 4.0))
    assert (tmp_path / "profile_step_7" / "trace.json").stat().st_size > 0
    summary = (tmp_path / "profile_step_7.txt").read_text()
    assert '"step": 7' in summary and "aten::mm" in summary

"""The port's document classifiers (karanta_tpu_torch.models.classifier,
inference/image_classifier.py, training/classifier_train.py) against the
JAX package's on the CPU, at the tiny presets in float32.

Weights come from the JAX initialisers and are carried across with
``convert.from_jax_params`` (the JAX PRNG cannot be reproduced in torch);
the JAX side runs as tests/test_classifier.py runs it (its attention on the
CPU is ``mha_reference``). Tolerances: logits within 1e-5 (absolute and
relative); one training step's loss within 1e-5 relative and every gradient
leaf within 1e-5 of the leaf's largest gradient plus 2e-6 of the tree's
largest (float32 sums in another order: small leaves such as ConvNeXt's GRN
bias read 1e-4 of their own size, under 1e-6 of the tree's); the parameters
after 3 AdamW steps within 1e-6 (each step moves them by about the learning
rate, 1e-3, so a wrong update shows); loaded images and training batches
equal. The attention key biases are the exception there, as in
test_torch_training.py: their exact gradient is zero (a shift of every key
leaves the softmax unchanged), so both packages' gradients are rounding
noise, which Adam scales to the learning rate: an early Adam step moves a
leaf by at most its learning rate, so the two are held within twice the
steps' summed rates (0 + 1 + 0.5 learning rates: 3 learning rates).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from karanta_tpu.inference import image_classifier as jic
from karanta_tpu.models.classifier import convnets as jconv
from karanta_tpu.models.classifier import segformer as jseg
from karanta_tpu.models.classifier import vit as jvit
from karanta_tpu.training import classifier_train as jtrain
from karanta_tpu.training.optimizer import make_lr_schedule as j_schedule
from karanta_tpu_torch.inference import image_classifier as tic
from karanta_tpu_torch.models.classifier.convert import from_jax_params, get_arch
from karanta_tpu_torch.training import classifier_train as ttrain
from karanta_tpu_torch.training.optimizer import make_adamw, make_lr_schedule
from karanta_tpu_torch.training.train_step import value_and_grad
from karanta_tpu_torch.utils.tree import flatten_tree

# arch -> (JAX tiny config, JAX init, JAX forward, image size)
JAX_ARCHS = {
    "vit": (jvit.tiny_vit, jvit.init_vit_params, jvit.vit_forward, 32),
    "segformer": (jseg.tiny_segformer, jseg.init_segformer_params,
                  jseg.segformer_forward, 64),
    "convnextv2": (jconv.tiny_convnextv2, jconv.init_convnextv2_params,
                   jconv.convnextv2_forward, 64),
    "resnet": (jconv.tiny_resnet, jconv.init_resnet_params,
               jconv.resnet_forward, 64),
}
ARCHS = list(JAX_ARCHS)
LR = 1e-3


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_init(arch: str, seed: int):
    jcfg = JAX_ARCHS[arch][0]()
    return jcfg, JAX_ARCHS[arch][1](jcfg, jax.random.PRNGKey(seed))


def _jax_case(arch: str, seed: int = 0):
    """(JAX cfg, JAX params, numpy params, images, labels); the ResNet's
    batch-norm statistics are drawn away from 0/1 so that they matter."""
    size = JAX_ARCHS[arch][3]
    jcfg, jparams = _jax_init(arch, seed)
    rng = np.random.default_rng(seed + 1)
    if arch == "resnet":
        def stats(path, x):
            name = getattr(path[-1], "key", None)
            if name == "mean":
                return jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype)
            if name == "var":
                return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
            return x
        jparams = jax.tree_util.tree_map_with_path(stats, jparams)
    images = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    labels = np.array([0, 1], np.int32)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams), images, labels


def _port(arch: str, np_params):
    cfg = get_arch(arch).tiny()
    return cfg, from_jax_params(np_params, arch, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_tree(arch):
    """Same keys, shapes and constant leaves as the JAX init."""
    spec = get_arch(arch)
    port = {k: v.numpy() for k, v in flatten_tree(
        spec.init(spec.tiny(), 3, device="cpu")).items()}
    want = _jflat(_jax_init(arch, 0)[1])
    assert {k: v.shape for k, v in port.items()} == \
        {k: v.shape for k, v in want.items()}
    for key, value in want.items():
        if np.all(value == value.flat[0]):  # zeros and ones
            np.testing.assert_array_equal(port[key], value, err_msg=key)
        else:
            assert port[key].std() > 0, key


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(arch):
    jcfg, jparams, np_params, images, _ = _jax_case(arch)
    want = np.asarray(jax.jit(JAX_ARCHS[arch][2], static_argnums=1)(
        jparams, jcfg, jnp.asarray(images)))
    cfg, params = _port(arch, np_params)
    got = get_arch(arch).forward(params, cfg, torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_train_step(jfwd, jcfg, optimizer):
    """The JAX trainer's train_step (classifier_train.py:219-231)."""

    @jax.jit
    def step(params, opt_state, images, label_ids):
        def loss_fn(p):
            logits = jfwd(p, jcfg, images)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, label_ids).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return step


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_and_adamw_match_jax(arch):
    """One step's loss and every gradient leaf (the ResNet's batch-norm
    mean/var included) against jax.value_and_grad, then the parameters
    after 3 AdamW steps at the trainer's schedule (cosine, 1 warmup step,
    weight decay 0.01 on every leaf) against optax.adamw."""
    jcfg, jparams, np_params, images, labels = _jax_case(arch)
    jopt = optax.adamw(j_schedule("cosine", LR, 1, 3), weight_decay=0.01)
    jstep = _jax_train_step(JAX_ARCHS[arch][2], jcfg, jopt)
    jstate = jopt.init(jparams)

    cfg, params = _port(arch, np_params)
    topt = make_adamw(make_lr_schedule("cosine", LR, 1, 3), 0.01,
                      decay_all_leaves=True)
    tstate = topt.init(params)
    loss_fn = ttrain.classifier_loss(get_arch(arch).forward, cfg)
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    loss, _, grads = value_and_grad(loss_fn, params, x, y)
    tstep = ttrain.make_train_step(get_arch(arch).forward, cfg, topt)

    for i in range(3):
        jparams, jstate, jloss, jgrads = jstep(
            jparams, jstate, jnp.asarray(images), jnp.asarray(labels))
        if i == 0:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            want = _jflat(jgrads)
            assert set(want) == set(grads)
            top = max(float(np.abs(g).max()) for g in want.values())
            for key, g in want.items():
                err = float(np.abs(grads[key].numpy() - g).max())
                limit = 1e-5 * float(np.abs(g).max()) + 2e-6 * top
                assert err <= limit, (key, err, limit)
        params, tstate, tloss, _ = tstep(params, tstate, x, y)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = _jflat(jparams)
    for key, p in flatten_tree(params).items():
        if key.endswith("bk"):
            assert np.abs(p.numpy() - want[key]).max() <= 3 * LR, key
        else:
            np.testing.assert_allclose(p.numpy(), want[key], atol=1e-6,
                                       rtol=0, err_msg=key)


def _hf_model(arch: str):
    """Tiny random-init HF classifiers, built as tests/test_classifier.py
    builds them."""
    import transformers as tf

    torch.manual_seed(0)
    labels = dict(num_labels=3, id2label={0: "a", 1: "b", 2: "c"},
                  label2id={"a": 0, "b": 1, "c": 2})
    if arch == "vit":
        return tf.ViTForImageClassification(tf.ViTConfig(
            image_size=32, patch_size=8, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, **labels)).eval()
    if arch == "segformer":
        return tf.SegformerForImageClassification(tf.SegformerConfig(
            num_encoder_blocks=2, hidden_sizes=[8, 16], depths=[1, 1],
            num_attention_heads=[1, 2], sr_ratios=[4, 1], patch_sizes=[7, 3],
            strides=[4, 2], mlp_ratios=[2, 2], **labels)).eval()
    if arch == "convnextv2":
        return tf.ConvNextV2ForImageClassification(tf.ConvNextV2Config(
            num_stages=2, hidden_sizes=[8, 16], depths=[1, 1],
            **labels)).eval()
    return tf.ResNetForImageClassification(tf.ResNetConfig(
        embedding_size=8, hidden_sizes=[8, 16], depths=[1, 1],
        layer_type="bottleneck", **labels)).eval()


@pytest.mark.parametrize("arch", ARCHS)
def test_from_checkpoint_matches_jax(arch, tmp_path):
    """An HF directory (safetensors) through both packages' from_checkpoint:
    the same arch, labels and config, and the same logits on uint8 pages."""
    _hf_model(arch).save_pretrained(tmp_path / "ckpt", safe_serialization=True)
    jclf = jic.LayoutClassifier.from_checkpoint(str(tmp_path / "ckpt"))
    tclf = tic.LayoutClassifier.from_checkpoint(str(tmp_path / "ckpt"),
                                                device="cpu")
    assert tclf.arch == jclf.arch == arch
    assert tclf.cfg.labels == jclf.cfg.labels == ("a", "b", "c")
    assert tclf.cfg == type(tclf.cfg)(**vars(jclf.cfg))
    size = 32 if arch == "vit" else 64
    batch = np.random.default_rng(2).integers(0, 256, (2, size, size, 3),
                                              dtype=np.uint8)
    want = np.asarray(jclf._forward(jclf.params, images=batch))
    np.testing.assert_allclose(tclf.logits(batch).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def _sample_image(h=64, w=48, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)


def _image_input(kind, tmp_path):
    from PIL import Image

    img = _sample_image()
    if kind == "path":
        path = tmp_path / "s.png"
        Image.fromarray(img).save(path)
        return str(path)
    return {"pil": lambda: Image.fromarray(img),
            "hwc": lambda: img,
            "chw": lambda: np.moveaxis(img, -1, 0),
            "gray": lambda: img[..., 0],
            "gray1": lambda: img[..., :1],
            "float": lambda: img.astype(np.float32) / 255.0,
            "tensor": lambda: torch.tensor(img).permute(2, 0, 1)}[kind]()


@pytest.mark.parametrize("kind", ["path", "pil", "hwc", "chw", "gray",
                                  "gray1", "float", "tensor"])
def test_load_image_matches_jax(kind, tmp_path):
    image = _image_input(kind, tmp_path)
    got, want = tic.load_image(image), jic.load_image(image)
    assert got.mode == want.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_load_image_rejects_urls_and_unknown_types():
    for bad, exc in (("https://example.org/a.png", ValueError),
                     (object(), TypeError)):
        with pytest.raises(exc):
            tic.load_image(bad)


@pytest.fixture(scope="module")
def tiny_vit_pair():
    jcfg, jparams, np_params, _, _ = _jax_case("vit")
    cfg, params = _port("vit", np_params)
    return (jic.LayoutClassifier(jparams, jcfg, arch="vit"),
            tic.LayoutClassifier(params, cfg, arch="vit", device="cpu"))


def test_predict_and_predict_batch_match_jax(tiny_vit_pair):
    jclf, tclf = tiny_vit_pair
    images = [_sample_image(seed=i) for i in range(3)] + [_sample_image(
        32, 32, seed=5)]
    for image in images:
        got, want = tclf.predict(image), jclf.predict(image)
        assert got["label"] == want["label"]
        assert abs(got["score"] - want["score"]) <= 1e-6
    got, want = tclf.predict_batch(images), jclf.predict_batch(images)
    assert [g["label"] for g in got] == [w["label"] for w in want]
    np.testing.assert_allclose([g["score"] for g in got],
                               [w["score"] for w in want], atol=1e-6)


def test_predict_layout_singleton_reads_the_checkpoint_path(tmp_path,
                                                            monkeypatch):
    """KARANTA_CLASSIFIER_PATH names an HF directory: both packages'
    predict_layout load it once and agree."""
    _hf_model("vit").save_pretrained(tmp_path / "ckpt", safe_serialization=True)
    monkeypatch.setenv("KARANTA_CLASSIFIER_PATH", str(tmp_path / "ckpt"))
    monkeypatch.setattr(tic, "_classifiers", {})
    monkeypatch.setattr(jic, "_classifier", None)
    image = _sample_image()
    got = tic.predict_layout(image, device="cpu")
    want = jic.predict_layout(image)
    assert got["label"] == want["label"] and got["label"] in ("a", "b", "c")
    assert abs(got["score"] - want["score"]) <= 1e-6
    first = tic._get_classifier("cpu")
    tic.predict_layout(image, device="cpu")
    assert tic._get_classifier("cpu") is first


def _imagefolder(root, size: int, per_label: int, seed: int):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for label, base in (("no_segment", 30), ("segment", 220)):
        d = root / label
        d.mkdir(parents=True)
        for i in range(per_label):
            arr = np.full((size, size, 3), base, np.uint8)
            arr += rng.integers(0, 20, arr.shape, dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("arch", ["vit", "segformer-tiny"])
def test_load_batch_matches_jax(arch, tmp_path):
    """The same seed gives the same augmented batch, bit for bit, and the
    same imagefolder and mixed-dataset listings."""
    root = _imagefolder(tmp_path / "data", 40, 3, seed=4)
    assert ttrain.load_imagefolder(root) == jtrain.load_imagefolder(root)
    mix = [f"{root}:0.5", f"{root}:2"]
    assert ttrain.prepare_mixed_datasets(mix) == \
        jtrain.prepare_mixed_datasets(mix)
    paths = ttrain.load_imagefolder(root)[0]
    for rng_seed in (None, 3):
        got = ttrain._load_batch(paths, 32, None if rng_seed is None else
                                 np.random.default_rng(rng_seed), arch=arch)
        want = jtrain._load_batch(paths, 32, None if rng_seed is None else
                                  np.random.default_rng(rng_seed), arch=arch)
        np.testing.assert_array_equal(got, want)


TINY_ARGS = {
    "vit": ["--arch", "vit", "--image_size", "32", "--patch_size", "8",
            "--hidden_size", "32", "--num_layers", "2", "--num_heads", "2",
            "--intermediate_size", "64"],
    "segformer-tiny": ["--arch", "segformer-tiny", "--image_size", "64"],
    "convnextv2-tiny": ["--arch", "convnextv2-tiny", "--image_size", "64"],
    "resnet-tiny": ["--arch", "resnet-tiny", "--image_size", "64"],
}


@pytest.mark.parametrize("arch", list(TINY_ARGS))
def test_trainer_runs_checkpoints_and_resumes(arch, tmp_path, monkeypatch):
    """main() on the CPU: 3 steps with a checkpoint every 2, the final one
    read back bit-equal, held-out accuracy; then `auto` resumes from step 3
    and runs the 2 steps left of 5."""
    from karanta_tpu_torch.training import checkpoint as ckpt

    root = _imagefolder(tmp_path / "data", 64, 5, seed=2)
    out = str(tmp_path / "run")
    base = ["--dataset_dir", root, "--output_dir", out, "--device", "cpu",
            "--batch_size", "4", "--learning_rate", "0.002",
            "--warmup_steps", "1", "--checkpointing_steps", "2",
            "--logging_steps", "1"] + TINY_ARGS[arch]
    steps, last = [], {}
    make = ttrain.make_train_step

    def counting(*args):
        step = make(*args)

        def wrapped(params, opt_state, images, label_ids):
            steps.append(int(opt_state["count"]))
            out_ = step(params, opt_state, images, label_ids)
            last["state"] = {"params": out_[0], "opt_state": out_[1]}
            return out_
        return wrapped

    monkeypatch.setattr(ttrain, "make_train_step", counting)
    metrics = ttrain.main(base + ["--max_steps", "3"])
    assert metrics["step"] == 3 and np.isfinite(metrics["loss"])
    assert 0.0 <= metrics["eval_accuracy"] <= 1.0
    assert steps == [0, 1, 2]
    assert [s for s, _ in ckpt.checkpoint_dirs(out)] == [2, 3]
    restored, meta = ckpt.restore_checkpoint(
        ckpt.get_last_checkpoint(out), last["state"])
    assert meta == {"step": 3, "labels": ["no_segment", "segment"]}
    for key, value in flatten_tree(last["state"]).items():
        assert torch.equal(flatten_tree(restored)[key], value), key

    metrics = ttrain.main(base + ["--max_steps", "5",
                                  "--resume_from_checkpoint", "auto"])
    assert steps == [0, 1, 2, 3, 4] and metrics["step"] == 5


@pytest.mark.parametrize("entry", ["random", "init", "predict_layout",
                                   "trainer"])
def test_entry_points_refuse_to_run_without_a_card(entry, tmp_path,
                                                   monkeypatch):
    """With no device given, every entry point asks for the card, and
    raises when there is none (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    monkeypatch.setattr(tic, "_classifiers", {})
    monkeypatch.delenv("KARANTA_CLASSIFIER_PATH", raising=False)
    calls = {
        "random": lambda: tic.LayoutClassifier.random(arch="segformer"),
        "init": lambda: get_arch("resnet").init(get_arch("resnet").tiny()),
        "predict_layout": lambda: tic.predict_layout(_sample_image()),
        "trainer": lambda: ttrain.main([
            "--dataset_dir", _imagefolder(tmp_path / "d", 32, 2, seed=0),
            "--output_dir", str(tmp_path / "run"), "--max_steps", "1"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert not os.path.exists(tmp_path / "run")

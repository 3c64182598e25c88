"""The port's LoRA, QLoRA and NF4 against the JAX package's on the CPU.

The JAX package's parameters and LoRA factors are carried across (its PRNG
cannot be reproduced), so both packages start from the same numbers.
float32 unless a case says bf16. NF4 bytes and scales bit-equal; logits and
gradients at the JAX tests' tolerances or tighter, as each case states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import forward_train as j_forward
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu.ops import quantization as jq
from karanta_tpu.training import lora as jl
from karanta_tpu.training import optimizer as jopt
from karanta_tpu.training import train_step as jts
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.models.qwen25_vl.model import forward_train
from karanta_tpu_torch.ops import quantization as tq
from karanta_tpu_torch.training import lora as tl
from karanta_tpu_torch.training import optimizer as topt
from karanta_tpu_torch.training import train_step as tts
from karanta_tpu_torch.utils.tree import flatten_tree, tree_map

TOK = ByteTokenizer()
JCFG = j_tiny_config(vocab_size=TOK.vocab_size)
CFG = tiny_config(vocab_size=TOK.vocab_size)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _lora_from_jax(jlora):
    """The JAX package's LoRA tree (factors, alpha, rank) as the port's."""
    factors = tree_map(lambda a, _: torch.from_numpy(np.array(a)),
                       jax.tree.map(np.asarray, jl.trainable_lora(jlora)))
    return {**factors, "alpha": torch.tensor(float(jlora["alpha"])),
            "rank": int(jlora["rank"])}


@pytest.fixture(scope="module")
def setup():
    """Params and non-trivial factors (b != 0 on every target) from JAX."""
    jp = j_init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    jlora = jl.init_lora_params(jp, rank=4, key=jax.random.PRNGKey(1),
                                alpha=8.0)
    factors = jax.tree.map(
        lambda f: f + 0.02 * jax.random.normal(jax.random.PRNGKey(3),
                                               f.shape, f.dtype),
        jl.trainable_lora(jlora))
    jlora = jl.with_factors(jlora, factors)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), CFG, "cpu",
                         torch.float32)
    return jp, jlora, tp, _lora_from_jax(jlora)


def _batch(rows=2, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.text.vocab_size, (rows, seq)).astype(np.int32)
    pos = np.broadcast_to(np.arange(seq)[None, None],
                          (3, rows, seq)).astype(np.int32)
    labels = np.where(np.arange(seq)[None, :] < 4, -100, ids).astype(np.int32)
    return {"token_ids": ids, "positions": pos, "labels": labels}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("shape", [(3, 128, 40), (64, 8), (2, 192, 24)])
@pytest.mark.parametrize("bf16", [False, True])
def test_nf4_bytes_match_jax(shape, bf16):
    w = np.random.default_rng(len(shape)).normal(size=shape) \
        .astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16 if bf16 else jnp.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16 if bf16 else torch.float32)
    want, got = jq.nf4_quantize(jw), tq.nf4_quantize(tw)
    assert got["nf4_q"].dtype == torch.uint8
    np.testing.assert_array_equal(got["nf4_q"].numpy(),
                                  np.asarray(want["nf4_q"]))
    np.testing.assert_array_equal(got["absmax"].numpy(),
                                  np.asarray(want["absmax"]))
    np.testing.assert_array_equal(
        tq.nf4_dequantize(got, torch.float32).numpy(),
        np.asarray(jq.nf4_dequantize(want, jnp.float32)))
    assert tq.is_nf4(got) and not tq.is_nf4(tw)
    np.testing.assert_array_equal(np.asarray(tq.NF4_CODE, np.float32),
                                  jq.NF4_CODE)


def test_merge_and_zero_init_match_jax(setup):
    jp, jlora, tp, tlora = setup
    want = _flat(jl.merge_lora(jp, jlora))
    got = flatten_tree(tl.merge_lora(tp, tlora))
    for path in ("text/layers/attn/wq", "text/layers/mlp/down"):
        np.testing.assert_allclose(got[path].numpy(), want[path], atol=1e-6,
                                   rtol=0, err_msg=path)
    fresh = tl.init_lora_params(tp, 4, torch.Generator().manual_seed(0))
    assert fresh["attn"]["wq"]["a"].shape == (CFG.text.num_layers,
                                              CFG.text.hidden_size, 4)
    merged = tl.merge_lora(tp, fresh)  # b = 0: the base, to the bit
    assert torch.equal(merged["text"]["layers"]["attn"]["wq"],
                       tp["text"]["layers"]["attn"]["wq"])


def test_inline_forward_matches_merged_and_jax(setup):
    """wrap_lora's inline matmul: the merged forward (JAX test's 2e-4) and
    JAX's own inline forward (1e-5)."""
    jp, jlora, tp, tlora = setup
    b = _batch()
    ids, pos = torch.from_numpy(b["token_ids"]), torch.from_numpy(
        b["positions"])
    inline = forward_train(tl.wrap_lora(tp, tlora), CFG, ids, pos)
    merged = forward_train(tl.merge_lora(tp, tlora), CFG, ids, pos)
    torch.testing.assert_close(inline, merged, rtol=2e-4, atol=2e-4)
    want = j_forward(jl.wrap_lora(jp, jlora), JCFG,
                     jnp.asarray(b["token_ids"]), jnp.asarray(b["positions"]))
    np.testing.assert_allclose(inline.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_qlora_forward_matches_merged_and_jax(setup):
    """bf16 with an NF4 base: inline against merged at the JAX test's 0.05,
    against JAX's inline forward within 2 bf16 steps of the logit scale."""
    jp, jlora, _, tlora = setup
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tpb = from_jax_params(jax.tree.map(np.asarray, jp), CFG, "cpu",
                          torch.bfloat16)
    jbase, tbase = jl.quantize_base_nf4(jpb), tl.quantize_base_nf4(tpb)
    np.testing.assert_array_equal(
        tbase["text"]["layers"]["mlp"]["up"]["nf4_q"].numpy(),
        np.asarray(jbase["text"]["layers"]["mlp"]["up"]["nf4_q"]))
    b = _batch()
    ids, pos = torch.from_numpy(b["token_ids"]), torch.from_numpy(
        b["positions"])
    inline = forward_train(tl.wrap_lora(tbase, tlora), CFG, ids, pos).float()
    merged = forward_train(tl.merge_lora(tbase, tlora), CFG, ids,
                           pos).float()
    torch.testing.assert_close(inline, merged, rtol=0.05, atol=0.05)
    want = np.asarray(j_forward(jl.wrap_lora(jbase, jlora), JCFG,
                                jnp.asarray(b["token_ids"]),
                                jnp.asarray(b["positions"])), np.float32)
    scale = np.abs(want).max()
    assert np.abs(inline.numpy() - want).max() <= 2 * 2 ** -7 * scale


def test_lora_grads_and_steps_match_jax(setup):
    """The factors' loss and gradients against JAX's (atol 1e-6 + rtol
    1e-3), then two AdamW steps of make_lora_train_step: factors within
    1e-6. The base stays as it was."""
    jp, jlora, tp, tlora = setup
    b = _batch(4, seed=1)
    jloss_fn = jts.make_loss_fn(JCFG)
    (jloss, _), jg = jax.value_and_grad(
        lambda f: jloss_fn(jl.wrap_lora(jp, jl.with_factors(jlora, f)),
                           {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True)(jl.trainable_lora(jlora))
    loss_fn = tts.make_loss_fn(CFG)
    loss, _, grads = tts.value_and_grad(
        lambda f, mb: loss_fn(tl.wrap_lora(tp, tl.with_factors(tlora, f)),
                              mb), tl.trainable_lora(tlora), _torch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for path, want in _flat(jg).items():
        np.testing.assert_allclose(grads[path].numpy(), want, atol=1e-6,
                                   rtol=1e-3, err_msg=path)

    base_before = {k: v.clone() for k, v in flatten_tree(tp).items()}
    jo = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", 1e-3,
                                                            0, 2))
    to = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", 1e-3,
                                                            0, 2))
    jstate = jts.create_train_state(jl.trainable_lora(jlora), jo)
    tstate = tts.create_train_state(
        tree_map(lambda a, _: a.clone(), tl.trainable_lora(tlora)), to)
    jstep = jax.jit(jl.make_lora_train_step(JCFG, jo, grad_accum=2))
    tstep = tl.make_lora_train_step(CFG, to, grad_accum=2)
    for i in range(2):
        bi = _batch(4, seed=5 + i)
        jstate, jm = jstep(jstate, jp, jlora,
                           {k: jnp.asarray(v) for k, v in bi.items()})
        tstate, tm = tstep(tstate, tp, tlora, _torch(bi))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    got = flatten_tree(tstate.params)
    for path, want in _flat(jstate.params).items():
        np.testing.assert_allclose(got[path].numpy(), want, atol=1e-6,
                                   rtol=0, err_msg=path)
    for path, leaf in flatten_tree(tp).items():
        assert torch.equal(leaf, base_before[path]), path


def test_lora_grad_accum_and_remat(setup):
    """grad-accum 2 against the full batch (equal token counts per row),
    and remat against none: the same loss and factor gradients."""
    _, _, tp, tlora = setup
    b = _torch({**_batch(4, seed=2), "labels": _batch(4, seed=2)[
        "token_ids"]})
    factors = tl.trainable_lora(tlora)

    def grads(accum, remat):
        loss_fn = tts.make_loss_fn(CFG, remat=remat)
        lora_loss = lambda f, mb: loss_fn(  # noqa: E731
            tl.wrap_lora(tp, tl.with_factors(tlora, f)), mb)
        return tts.accumulate_grads(
            lambda mb: tts.value_and_grad(lora_loss, factors, mb), factors,
            b, accum)

    base = grads(1, False)
    for other in (grads(2, False), grads(1, True)):
        np.testing.assert_allclose(float(other[1]), float(base[1]),
                                   rtol=1e-6)
        for path, g in base[0].items():
            torch.testing.assert_close(other[0][path], g, atol=1e-7,
                                       rtol=1e-4, msg=path)


@pytest.mark.parametrize("flag", ["--use_lora", "--use_qlora"])
def test_train_cli_with_lora(flag, tmp_path):
    from tests.test_torch_training import make_dataset

    from karanta_tpu_torch.training.checkpoint import restore_params
    from karanta_tpu_torch.training.train import main

    root = make_dataset(tmp_path / "data", n=2)
    out = tmp_path / "run"
    metrics = main([
        "--dataset_root", str(root), "--output_dir", str(out),
        "--model_name_or_path", "tiny", "--max_steps", "2",
        "--gradient_accumulation_steps", "1",
        "--per_device_train_batch_size", "1", "--logging_steps", "1",
        "--checkpointing_steps", "0", "--eval_steps", "0",
        "--learning_rate", "0.01", "--dtype", "bfloat16" if "q" in flag
        else "float32", "--device", "cpu", flag, "true", "--lora_rank", "4",
        "--warmup_steps", "0", "--eval_fraction", "0"])
    assert np.isfinite(metrics["loss"]) and metrics["step"] == 2
    factors, meta = restore_params(str(out / "step_2"), device="cpu")
    assert meta["step"] == 2
    assert set(factors) == {"attn", "mlp"}
    assert float(factors["attn"]["wq"]["b"].abs().max()) > 0

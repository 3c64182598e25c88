"""HF weight loading and export in the port against the JAX package.

1. The JAX package's ``save_hf_checkpoint`` writes a tiny random checkpoint
   (as tests/test_export.py does); the port's ``load_hf_checkpoint`` equals
   ``from_jax_params`` of the JAX load, unquantized and int8.
2. The port's ``save_hf_checkpoint`` round-trips through the JAX loader and
   through its own.
3. Both servers, built by their CLIs with ``--model-path`` over a
   checkpoint beside a locally trained BPE tokenizer, give the same greedy
   text.

Tolerance: every loaded tensor bit-equal (float32, int8 and the float32
scales); texts equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.models.qwen25_vl import exporting as jexp
from karanta_tpu.models.qwen25_vl import loading as jload
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu_torch.models.qwen25_vl import exporting, loading
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params

JCFG = j_tiny_config()
CFG = tiny_config()


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def assert_trees_bit_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), "/".join(path)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    params = j_init_params(JCFG, jax.random.PRNGKey(1), dtype=jnp.float32)
    out = str(tmp_path_factory.mktemp("jax_ckpt"))
    jexp.save_hf_checkpoint(params, JCFG, out)
    return out, params


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_load_equals_the_jax_load(jax_checkpoint, quantize):
    path, _ = jax_checkpoint
    want = jload.load_hf_checkpoint(path, JCFG, jnp.float32,
                                    quantize=quantize)
    want = from_jax_params(jax.tree.map(np.asarray, want), CFG,
                           device="cpu", dtype=torch.float32)
    got = loading.load_hf_checkpoint(path, CFG, torch.float32,
                                     quantize=quantize, device="cpu")
    assert_trees_bit_equal(got, want)
    if quantize:
        wq = got["text"]["layers"]["mlp"]["gate"]["int8_q"]
        assert wq.dtype == torch.int8 and wq.transpose(-1, -2).is_contiguous()


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        loading.load_hf_checkpoint(str(tmp_path), CFG, torch.float32,
                                   device="cpu")


def test_export_round_trips_through_both_loaders(jax_checkpoint, tmp_path):
    """Port params (the JAX init carried across) -> the port's checkpoint:
    the JAX loader gives back the JAX params, the port's loader the port's;
    the HF state dict equals the JAX exporter's; the config is the same."""
    _, jparams = jax_checkpoint
    params = from_jax_params(jax.tree.map(np.asarray, jparams), CFG,
                             device="cpu", dtype=torch.float32)
    out = exporting.save_hf_checkpoint(params, CFG, str(tmp_path / "port"))
    back = jload.load_hf_checkpoint(out, JCFG, jnp.float32)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(pa))
    assert_trees_bit_equal(loading.load_hf_checkpoint(
        out, CFG, torch.float32, device="cpu"), params)
    state, want = exporting.to_hf_state_dict(params, CFG), \
        jexp.to_hf_state_dict(jparams, JCFG)
    assert state.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(state[k].numpy(), want[k], err_msg=k)
    with open(f"{out}/config.json") as f:
        assert json.load(f) == jexp.hf_config_dict(JCFG)


# ---------------------------------------------------------------------------
# --model-path serving
# ---------------------------------------------------------------------------

def _bpe_dir(out: str) -> str:
    """A byte-level BPE tokenizer trained locally and saved as an HF dir
    (tests/test_bpe_tokenizer.py's recipe)."""
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)
    from transformers import PreTrainedTokenizerFast

    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>",
                "<|vision_start|>", "<|vision_end|>", "<|image_pad|>"]
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=800, special_tokens=specials,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False)
    corpus = ["the quick brown fox jumps over the lazy dog " * 50,
              "pages per second per chip " * 50]
    tok.train_from_iterator(corpus, trainer)
    PreTrainedTokenizerFast(
        tokenizer_object=tok, eos_token="<|im_end|>",
        pad_token="<|endoftext|>",
        additional_special_tokens=specials[3:]).save_pretrained(out)
    return out


def test_model_path_servers_give_the_same_text(jax_checkpoint):
    """Both CLIs serve the JAX-written checkpoint with its BPE tokenizer
    (--model-path, --preset tiny, int8 weights on transfer, the product
    defaults otherwise): the same greedy text as each other, and the port
    engine's weights are the loaded ones."""
    from tests.test_torch_server import _completions, _running

    from karanta_tpu.inference import server as JS
    from karanta_tpu_torch.inference import server as S

    path, _ = jax_checkpoint
    _bpe_dir(path)
    argv = ["--model-path", path, "--preset", "tiny", "--max-batch-size",
            "2", "--max-model-len", "256", "--quantize", "int8"]
    jeng, jname = JS.build_engine_from_args(JS.make_arg_parser().parse_args(
        argv))
    eng, name = S.build_engine_from_args(S.make_arg_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert name == jname == path
    assert eng.ecfg.quantize is None and eng.tok.vocab_size <= 1024
    assert eng.params["text"]["layers"]["attn"]["wq"]["int8_q"].dtype == \
        torch.int8
    body = {"model": "m", "max_tokens": 12, "temperature": 0.0,
            "messages": [{"role": "user",
                          "content": "the quick brown fox jumps"}]}
    with _running(JS.InferenceServer(jeng)) as jport, \
            _running(S.InferenceServer(eng)) as port:
        [want] = _completions(jport, [body])
        [got] = _completions(port, [body])
    assert got["choices"][0]["message"] == want["choices"][0]["message"]
    assert got["usage"] == want["usage"]

"""Teacher forcing in the port's engine against the JAX engine's, on the
cases of tests/test_teacher_force.py.

Both engines run the tiny config on the same weights (the JAX init carried
across by ``from_jax_params``), float32, on the CPU. Tolerance: tokens and
texts equal, acceptance counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.inference.engine import Engine as JEngine
from karanta_tpu.inference.engine import EngineConfig as JEngineConfig
from karanta_tpu.inference.engine import GenRequest as JGenRequest
from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu_torch.inference.engine import Engine, EngineConfig, GenRequest
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params

FORCED = ("the quick brown fox jumps over the lazy dog while the quick "
          "brown fox jumps over the lazy dog again")
BASE = dict(max_batch_size=2, max_seq_len=256, decode_chunk=6,
            prefill_buckets=(128,), teacher_force=True)


@pytest.fixture(scope="module")
def setup():
    jtok = JByteTokenizer()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tok = ByteTokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    return dict(jtok=jtok, jcfg=jcfg, jparams=jparams, tok=tok, cfg=cfg,
                params=params)


def engines(w, **over):
    """(JAX engine, port engine) with the same configuration."""
    kw = dict(BASE, **over)
    return (JEngine(w["jparams"], w["jcfg"], w["jtok"],
                    JEngineConfig(dtype=jnp.float32, **kw)),
            Engine(w["params"], w["cfg"], w["tok"],
                   EngineConfig(dtype=torch.float32, **kw), device="cpu"))


def reqs(content, forced=None, rid="r", max_tokens=160):
    kw = dict(messages=[{"role": "user", "content": content}],
              max_tokens=max_tokens, temperature=0.0, request_id=rid,
              forced_output=forced)
    return JGenRequest(**kw), GenRequest(**kw)


def both(jeng, eng, pair):
    [want] = jeng.generate([pair[0]])
    [got] = eng.generate([pair[1]])
    assert got.token_ids == want.token_ids
    assert got.text == want.text
    assert got.finish_reason == want.finish_reason
    assert got.completion_tokens == want.completion_tokens
    return got


def test_forced_output_exact(setup):
    """The completion is byte for byte the forced stream, EOS-finished."""
    res = both(*engines(setup), reqs("hello page", FORCED))
    assert res.text == FORCED
    assert res.finish_reason == "stop"
    assert res.completion_tokens == len(FORCED.encode()) + 1


def test_unforced_request_unaffected(setup):
    """Without forced_output the teacher-forcing engine gives the plain
    engine's greedy tokens, in both packages."""
    res = both(*engines(setup), reqs("some page text"))
    _, plain = engines(setup, teacher_force=False)
    [b] = plain.generate([reqs("some page text")[1]])
    assert res.token_ids == b.token_ids


def test_budget_truncation(setup):
    """A forced stream longer than max_tokens is cut to the budget."""
    res = both(*engines(setup), reqs("p", FORCED, max_tokens=10))
    assert res.text == FORCED[:9]
    assert res.completion_tokens == 10


def test_slot_reuse_clears_forcing(setup):
    """An unforced request in a slot a forced one used must not inherit the
    stale forced row."""
    jeng, eng = engines(setup, max_batch_size=1)
    first = both(jeng, eng, reqs("some page text", FORCED))
    assert first.text == FORCED
    again = both(jeng, eng, reqs("some page text"))
    _, plain = engines(setup, teacher_force=False, max_batch_size=1)
    [b] = plain.generate([reqs("some page text")[1]])
    assert again.token_ids == b.token_ids


def test_spec_forced_exact_and_accepts(setup):
    """Speculation + forcing: the emission is the forced text, acceptance
    beats 1.3 tokens a pass on an anchored prompt, and the verify passes
    and tokens equal the JAX engine's."""
    jeng, eng = engines(setup, speculative_ngram=3, max_seq_len=512,
                        prefill_buckets=(256,))
    prompt = "RAW TEXT START\n" + FORCED + "\nRAW TEXT END"
    res = both(jeng, eng, reqs(prompt, FORCED, rid="spec"))
    assert res.text == FORCED
    assert res.finish_reason == "stop"
    assert eng.spec_passes > 0
    assert eng.spec_tokens / eng.spec_passes > 1.3
    assert (eng.spec_passes, eng.spec_tokens) == (jeng.spec_passes,
                                                  jeng.spec_tokens)


def test_guided_plus_forced_rejected(setup):
    """Forced tokens bypass the automaton: prepare() refuses the pair, with
    the JAX engine's message."""
    jeng, eng = engines(setup)
    jreq, req = reqs("x", FORCED)
    jreq.guided_regex = req.guided_regex = r"[a-z ]+"
    with pytest.raises(ValueError, match="guided") as want:
        jeng.prepare(jreq)
    with pytest.raises(ValueError, match="guided") as got:
        eng.prepare(req)
    assert str(got.value) == str(want.value)


def test_prepare_ignores_forced_when_off(setup):
    """Engines without the hook never honour the field; with it, both
    encode the same stream."""
    jeng, eng = engines(setup, teacher_force=False)
    assert eng.prepare(reqs("x", FORCED)[1]).forced_tokens is None
    jeng, eng = engines(setup)
    jreq, req = reqs("x", FORCED, max_tokens=40)
    np.testing.assert_array_equal(eng.prepare(req).forced_tokens,
                                  jeng.prepare(jreq).forced_tokens)


def test_forced_page_text_matches_jax():
    from karanta_tpu.bench.pipeline_bench import forced_page_text as j_fpt
    from karanta_tpu_torch.bench.pipeline_bench import forced_page_text

    for seed in (0, 3, 11):
        for rate in (0.0, 0.05, 0.3):
            assert forced_page_text(seed, rate, n_lines=6) == \
                j_fpt(seed, rate, n_lines=6)


def test_forced_pipeline_bench_finishes_every_page(tmp_path, capsys,
                                                   monkeypatch):
    """The port's pipeline bench with --teacher-force on the tiny config:
    every page finishes on its first attempt, none falls back, and each
    PDF's Dolma text is its forced transcript cut to the token budget (the
    byte tokenizer: one token a byte, the last of the budget is EOS)."""
    import glob
    import json
    import os

    from karanta_tpu_torch.bench import pipeline_bench
    from tests.test_torch_pipeline import _bench_args

    monkeypatch.setenv("KARANTA_RENDER_PROCS", "0")
    budget = 48
    args = _bench_args(pipeline_bench, tmp_path / "w", device="cpu",
                       teacher_force=True, page_lines=3)
    args.decode_tokens = budget
    result = pipeline_bench.run(args)
    capsys.readouterr()
    detail = result["detail"]
    assert detail["teacher_force"] is True
    assert detail["force_error_rate"] == 0.05
    assert detail["finished_on_attempt_0"] == args.pages
    assert detail["fallback_pages"] == 0
    docs = []
    for path in glob.glob(os.path.join(args.workspace, "results", "*.jsonl")):
        with open(path) as f:
            docs += [json.loads(line) for line in f]
    assert len(docs) == args.pages
    for doc in docs:
        seed = int(os.path.basename(doc["metadata"]["Source-File"])[5:9])
        forced = pipeline_bench.forced_page_text(seed, 0.05, n_lines=3)
        assert doc["text"] == forced.encode()[:budget - 1].decode().strip()

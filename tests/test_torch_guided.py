"""Guided decoding in the port against the JAX package: the copied
``guided.py`` (regex compiler, token automaton, speculation-safe states)
on tests/test_guided.py's cases, and the port's engine (its state arena,
the per-step mask and the guided first token) against the JAX engine.

Tolerance: tables bit-equal; greedy tokens and texts equal; sampled
completions match their regex.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.inference import guided as jg
from karanta_tpu.inference.engine import Engine as JEngine
from karanta_tpu.inference.engine import EngineConfig as JEngineConfig
from karanta_tpu.inference.engine import GenRequest as JGenRequest
from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu_torch.inference import guided as g
from karanta_tpu_torch.inference.engine import (Engine, EngineConfig,
                                                GenRequest, GuidedRegexBusy)
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.pipeline.runner import GUIDED_REGEX

ENGINE_KW = dict(max_batch_size=2, max_seq_len=128, decode_chunk=4,
                 prefill_buckets=(64, 128), image_token_buckets=(16,))
P1 = r"(?:yes|no): [0-9]{1,3}"
P2 = r"[a-f]{2}-[0-9]{2}"


# ---------------------------------------------------------------------------
# guided.py: the copy against the JAX module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern,accept,reject", [
    (r"ab+c?", ["ab", "abbb", "abc"], ["a", "ac", "abcc"]),
    (r"[a-c]{2}", ["ab", "cc"], ["a", "abc", "dd"]),
    (r"(?:foo|bar)x*", ["foo", "barxx"], ["baz", "xfoo"]),
    (r"a\nb", ["a\nb"], ["anb", "a b"]),
    (r"[^0-9]+", ["abc"], ["a1"]),
    (r"x{2,3}", ["xx", "xxx"], ["x", "xxxx"]),
    (r"a.c", ["abc", "azc"], ["a\nc", "ac"]),
])
def test_regex_compiler_matches_jax(pattern, accept, reject):
    dfa, want = g.compile_regex(pattern), jg.compile_regex(pattern)
    np.testing.assert_array_equal(dfa.table, want.table)
    np.testing.assert_array_equal(dfa.accepting, want.accepting)
    for s in accept:
        assert g.match_full(dfa, s.encode()), (pattern, s)
    for s in reject:
        assert not g.match_full(dfa, s.encode()), (pattern, s)


def test_pipeline_guided_regex():
    dfa = g.compile_regex(GUIDED_REGEX)
    good = (b"---\nprimary_language: en\nis_rotation_valid: True\n"
            b"rotation_correction: 90\nis_table: false\n"
            b"is_diagram: False\n---\nbody text\nmore")
    assert g.match_full(dfa, good)
    assert not g.match_full(dfa, good.replace(b": en", b": english"))
    assert not g.match_full(dfa, b"primary_language: en")
    np.testing.assert_array_equal(dfa.table,
                                  jg.compile_regex(GUIDED_REGEX).table)


@pytest.mark.parametrize("pattern", [r"ab+", r"id: [0-9]{3}\n[\s\S]+",
                                     r"[0-9]+", r"ab*", GUIDED_REGEX])
def test_token_automaton_and_free_states_match_jax(pattern):
    """Token bytes, the automaton's tables and the speculation-safe states
    equal the JAX module's; the masks walk as tests/test_guided.py says."""
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    tb = g.token_bytes_from_tokenizer(tok, tok.vocab_size)
    assert tb == jg.token_bytes_from_tokenizer(jtok, jtok.vocab_size)
    auto = g.build_token_automaton(pattern, tb, tok.eos_token_id)
    want = jg.build_token_automaton(pattern, tb, jtok.eos_token_id)
    np.testing.assert_array_equal(auto.allowed, want.allowed)
    np.testing.assert_array_equal(auto.next_state, want.next_state)
    assert auto.start == want.start
    ignore = np.array([len(t) == 0 for t in tb], bool)
    ignore[tok.eos_token_id] = False
    free = g.closed_free_states(auto.allowed, auto.next_state, ignore)
    np.testing.assert_array_equal(free, jg.closed_free_states(
        want.allowed, want.next_state, ignore))
    assert free[0] and auto.allowed[g.TokenAutomaton.FREE].all()
    if pattern == r"ab+":
        a, b, c = (ord(ch) + tok.OFFSET for ch in "abc")
        state = auto.start
        assert auto.allowed[state, a] and not auto.allowed[state, b]
        assert not auto.allowed[state, tok.eos_token_id]
        state = auto.next_state[auto.next_state[state, a], b]
        assert auto.allowed[state, tok.eos_token_id]
        assert auto.allowed[state, b] and not auto.allowed[state, c]
    if pattern.startswith("id"):
        state = auto.start
        assert not free[state]
        for ch in b"id: 123\nX":
            state = auto.next_state[state, ch + tok.OFFSET]
        assert free[state] and free[auto.next_state[state]].all()
    if pattern == r"[0-9]+":
        assert not free[1:].any()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jtok = JByteTokenizer()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tok = ByteTokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    return dict(jtok=jtok, jcfg=jcfg, jparams=jparams, tok=tok, cfg=cfg,
                params=params)


def _engines(w, **over):
    kw = dict(ENGINE_KW, **over)
    return (JEngine(w["jparams"], w["jcfg"], w["jtok"],
                    JEngineConfig(dtype=jnp.float32, **kw)),
            Engine(w["params"], w["cfg"], w["tok"],
                   EngineConfig(dtype=torch.float32, **kw), device="cpu"))


def _pair(content, regex, max_tokens=24, temperature=0.0, rid=""):
    kw = dict(messages=[{"role": "user", "content": content}],
              max_tokens=max_tokens, temperature=temperature,
              guided_regex=regex, request_id=rid)
    return JGenRequest(**kw), GenRequest(**kw)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_guided_greedy_tokens_match_jax(tiny, kv):
    """Two regexes and an unguided request in one engine (two slots, so two
    waves): greedy tokens equal the JAX engine's, and every guided
    completion matches its regex."""
    jeng, eng = _engines(tiny, kv_quantize=kv)
    pairs = [_pair("classify", P1, rid="a"), _pair("code", P2, rid="b"),
             _pair("hello", None, max_tokens=6, rid="c")]
    want = jeng.generate([p[0] for p in pairs])
    got = eng.generate([p[1] for p in pairs])
    for w, r in zip(want, got):
        assert r.token_ids == w.token_ids
        assert r.text == w.text and r.finish_reason == w.finish_reason
    assert g.match_full(g.compile_regex(P1), got[0].text.encode())
    assert g.match_full(g.compile_regex(P2), got[1].text.encode())
    assert set(eng._arena) == {P1, P2}


def test_two_regexes_live_in_one_wave(tiny):
    """Sampled requests with different regexes decode side by side: both
    automatons are resident, a decode chunk runs with both live, and both
    completions match their constraints."""
    _, eng = _engines(tiny)
    reqs = [_pair("classify", P1, temperature=1.0)[1],
            _pair("code", P2, temperature=1.0)[1]]
    live = []
    orig = eng.decode_chunk_async

    def spy(*a, **k):
        live.append({r for r, free in zip(eng._slot_regex, eng.slot_free)
                     if r is not None and not free})
        return orig(*a, **k)

    eng.decode_chunk_async = spy
    r1, r2 = eng.generate(reqs)
    assert g.match_full(g.compile_regex(P1), r1.text.encode()), r1.text
    assert g.match_full(g.compile_regex(P2), r2.text.encode()), r2.text
    assert {P1, P2} in live, live


def test_guided_slot_speculates_in_its_free_tail(tiny):
    """A guided slot speculates once its DFA is in the closed free set:
    tokens, verify passes and tokens a pass equal the JAX engine's."""
    regex = r"id: [0-9]{3}\n[\s\S]+"
    jeng, eng = _engines(tiny, speculative_ngram=3, max_seq_len=256,
                         prefill_buckets=(128, 256), decode_chunk=8)
    jreq, req = _pair("abcabcabcabcabcabc", regex, max_tokens=40)
    [want] = jeng.generate([jreq])
    [got] = eng.generate([req])
    assert got.token_ids == want.token_ids
    assert g.match_full(g.compile_regex(regex), got.text.encode())
    assert eng.spec_passes > 0
    assert (eng.spec_passes, eng.spec_tokens) == (jeng.spec_passes,
                                                  jeng.spec_tokens)


def test_arena_buckets_and_capacity(tiny):
    """Regexes of one bucket share the tables' shape; a full arena with live
    slots defers (GuidedRegexBusy) and resets once they drain; a regex
    larger than the arena is refused for good."""
    _, eng = _engines(tiny, max_seq_len=64, prefill_buckets=(64,))
    start1 = eng._ensure_automaton(r"[0-9]{4}")
    shape = tuple(eng._allowed.shape)
    assert shape[0] in (64, 256, 1024, 4096)
    start2 = eng._ensure_automaton(P2)
    assert tuple(eng._allowed.shape) == shape and min(start1, start2) >= 1
    e1, e2 = eng._arena.values()
    assert e1["offset"] + e1["n"] <= e2["offset"]
    assert eng._ensure_automaton(r"[0-9]{4}") == start1

    _, eng = _engines(tiny, max_seq_len=64, prefill_buckets=(64,))
    p1 = r"[0-9]{6}"
    eng.ARENA_MAX_ROWS = eng._compile_automaton_locked(p1).allowed.shape[0]
    assert eng._ensure_automaton(p1) >= 1
    eng.slot_free[0] = False
    eng._slot_guided[0] = True
    eng._slot_regex[0] = p1
    assert not eng.guided_available(r"[a-f]{2}")
    with pytest.raises(GuidedRegexBusy):
        eng._ensure_automaton(r"[a-f]{2}")
    eng.free_slot(0)
    assert eng.guided_available(r"[a-f]{2}")
    assert eng._ensure_automaton(r"[a-f]{2}") >= 1
    assert set(eng._arena) == {r"[a-f]{2}"}
    eng.ARENA_MAX_ROWS = 4
    with pytest.raises(ValueError):
        eng._ensure_automaton(r"[0-9]{64}")

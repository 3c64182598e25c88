"""Regex-guided decoding (copy of ``karanta_tpu/inference/guided.py``; numpy
only, no device code).

Covers the reference's `guided_regex` request field (karanta/pipeline.py:
304-307 passes a YAML-front-matter regex to vLLM's guided decoding). The
regex compiles to a byte-level DFA, then to two dense tables over the
vocabulary, which the engine keeps on the device —

    allowed[state, token]     can `token` be emitted from `state`?
    next_state[state, token]  DFA state after emitting `token`

so the constraint runs inside the decode chunk: mask logits, sample, gather
the next state. No per-step host round trip (vLLM's FSM runs on the CPU
between steps; this one rides along with the chunked decode).

State 0 is the FREE state (everything allowed, self-loop) used by unguided
slots sharing the batch; EOS is allowed exactly in accepting states (the
output must match the full regex) and in FREE.

Supported syntax: literals, escapes (\\n \\r \\t \\d \\w \\s \\S \\D \\W and
escaped metachars), '.', char classes [a-z0-9_] (incl. negation and ranges),
groups (...) / (?:...), alternation |, quantifiers * + ? {m} {m,} {m,n}.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

DEAD = -1  # pre-table dead marker; becomes an absorbing dead state row


# ---------------------------------------------------------------------------
# regex -> NFA (Thompson construction over byte alphabet)
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.transitions: list[dict] = []   # state -> {byte: set(states)}
        self.epsilon: list[set] = []        # state -> set(states)

    def new_state(self) -> int:
        self.transitions.append({})
        self.epsilon.append(set())
        return len(self.transitions) - 1

    def add(self, src: int, byte: Optional[int], dst: int):
        if byte is None:
            self.epsilon[src].add(dst)
        else:
            self.transitions[src].setdefault(byte, set()).add(dst)


_CLASS_ESCAPES = {
    "d": set(range(0x30, 0x3A)),
    "w": set(range(0x30, 0x3A)) | set(range(0x41, 0x5B))
         | set(range(0x61, 0x7B)) | {0x5F},
    "s": {0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B},
}
_CHAR_ESCAPES = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "v": 0x0B,
                 "0": 0x00, "a": 0x07, "b": 0x08}
ALL_BYTES = set(range(256))


class _Parser:
    """Recursive-descent regex parser building byte sets + structure."""

    def __init__(self, pattern: str):
        self.data = pattern.encode("utf-8")
        self.pos = 0

    def peek(self) -> Optional[int]:
        return self.data[self.pos] if self.pos < len(self.data) else None

    def take(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    # grammar: alt := concat ('|' concat)* ; concat := repeat* ;
    # repeat := atom ('*'|'+'|'?'|'{m,n}')* ; atom := group | class | char

    def parse(self):
        node = self.parse_alt()
        if self.pos != len(self.data):
            raise ValueError(f"unexpected {chr(self.data[self.pos])!r} "
                             f"at {self.pos}")
        return node

    def parse_alt(self):
        branches = [self.parse_concat()]
        while self.peek() == 0x7C:  # |
            self.take()
            branches.append(self.parse_concat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def parse_concat(self):
        items = []
        while True:
            b = self.peek()
            if b is None or b in (0x7C, 0x29):  # | )
                break
            items.append(self.parse_repeat())
        if not items:
            return ("empty",)
        return ("cat", items) if len(items) > 1 else items[0]

    def parse_repeat(self):
        node = self.parse_atom()
        while True:
            b = self.peek()
            if b == 0x2A:      # *
                self.take()
                node = ("star", node)
            elif b == 0x2B:    # +
                self.take()
                node = ("cat", [node, ("star", node)])
            elif b == 0x3F:    # ?
                self.take()
                node = ("opt", node)
            elif b == 0x7B:    # {
                save = self.pos
                self.take()
                spec = bytearray()
                while self.peek() is not None and self.peek() != 0x7D:
                    spec.append(self.take())
                if self.peek() != 0x7D:
                    self.pos = save
                    break
                self.take()
                text = spec.decode()
                if "," in text:
                    lo_s, hi_s = text.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s else None
                else:
                    lo = hi = int(text)
                parts = [node] * lo
                if hi is None:
                    parts.append(("star", node))
                else:
                    parts.extend([("opt", node)] * (hi - lo))
                node = ("cat", parts) if parts else ("empty",)
            else:
                break
        return node

    def parse_atom(self):
        b = self.take()
        if b == 0x28:  # (
            if self.data[self.pos:self.pos + 2] == b"?:":
                self.pos += 2
            elif self.peek() == 0x3F:
                raise ValueError("only (?:...) groups are supported")
            node = self.parse_alt()
            if self.peek() != 0x29:
                raise ValueError("unbalanced group")
            self.take()
            return node
        if b == 0x5B:  # [
            return ("set", self.parse_class())
        if b == 0x2E:  # .
            return ("set", ALL_BYTES - {0x0A})
        if b == 0x5C:  # backslash
            return ("set", self.parse_escape())
        if b in (0x5E, 0x24):  # ^ $ anchors: full-match semantics -> no-op
            return ("empty",)
        return ("set", {b})

    def parse_escape(self) -> set:
        e = chr(self.take())
        if e in _CLASS_ESCAPES:
            return set(_CLASS_ESCAPES[e])
        if e.upper() == e and e.lower() in _CLASS_ESCAPES:
            return ALL_BYTES - _CLASS_ESCAPES[e.lower()]
        if e in _CHAR_ESCAPES:
            return {_CHAR_ESCAPES[e]}
        return {ord(e)}

    def parse_class(self) -> set:
        negate = False
        if self.peek() == 0x5E:  # ^
            self.take()
            negate = True
        chars: set = set()
        first = True
        while True:
            b = self.peek()
            if b is None:
                raise ValueError("unterminated class")
            if b == 0x5D and not first:  # ]
                self.take()
                break
            first = False
            self.take()
            if b == 0x5C:
                sub = self.parse_escape()
                chars |= sub
                continue
            # range?
            if (self.peek() == 0x2D
                    and self.pos + 1 < len(self.data)
                    and self.data[self.pos + 1] != 0x5D):
                self.take()  # -
                hi = self.take()
                if hi == 0x5C:
                    hi = next(iter(self.parse_escape()))
                chars |= set(range(b, hi + 1))
            else:
                chars.add(b)
        return (ALL_BYTES - chars) if negate else chars


def _build_nfa(node, nfa: _NFA, src: int, dst: int) -> None:
    kind = node[0]
    if kind == "empty":
        nfa.add(src, None, dst)
    elif kind == "set":
        for byte in node[1]:
            nfa.add(src, byte, dst)
    elif kind == "cat":
        prev = src
        for item in node[1][:-1]:
            mid = nfa.new_state()
            _build_nfa(item, nfa, prev, mid)
            prev = mid
        _build_nfa(node[1][-1], nfa, prev, dst)
    elif kind == "alt":
        for branch in node[1]:
            _build_nfa(branch, nfa, src, dst)
    elif kind == "opt":
        nfa.add(src, None, dst)
        _build_nfa(node[1], nfa, src, dst)
    elif kind == "star":
        hub = nfa.new_state()
        nfa.add(src, None, hub)
        nfa.add(hub, None, dst)
        inner_end = nfa.new_state()
        _build_nfa(node[1], nfa, hub, inner_end)
        nfa.add(inner_end, None, hub)
    else:
        raise ValueError(f"unknown node {kind}")


# ---------------------------------------------------------------------------
# NFA -> DFA (subset construction) -> dense byte table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ByteDFA:
    table: np.ndarray      # (n_states, 256) int32, dead row absorbing
    accepting: np.ndarray  # (n_states,) bool
    start: int
    dead: int


def compile_regex(pattern: str, max_states: int = 4096) -> ByteDFA:
    nfa = _NFA()
    src, dst = nfa.new_state(), nfa.new_state()
    _build_nfa(_Parser(pattern).parse(), nfa, src, dst)

    def closure(states: frozenset) -> frozenset:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.epsilon[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start = closure(frozenset([src]))
    index: dict[frozenset, int] = {start: 0}
    rows: list[np.ndarray] = []
    order = [start]
    i = 0
    while i < len(order):
        current = order[i]
        row = np.full((256,), DEAD, np.int64)
        # group bytes by target set
        targets: dict[int, set] = {}
        for s in current:
            for byte, dsts in nfa.transitions[s].items():
                targets.setdefault(byte, set()).update(dsts)
        for byte, dsts in targets.items():
            nxt = closure(frozenset(dsts))
            if nxt not in index:
                if len(index) >= max_states:
                    raise ValueError("regex DFA too large")
                index[nxt] = len(order)
                order.append(nxt)
            row[byte] = index[nxt]
        rows.append(row)
        i += 1

    n = len(order)
    dead = n
    table = np.full((n + 1, 256), dead, np.int32)
    for state, row in enumerate(rows):
        valid = row != DEAD
        table[state, valid] = row[valid]
    accepting = np.array([dst in s for s in order] + [False])
    return ByteDFA(table=table, accepting=accepting, start=0, dead=dead)


def match_full(dfa: ByteDFA, text: bytes) -> bool:
    state = dfa.start
    for byte in text:
        state = int(dfa.table[state, byte])
        if state == dfa.dead:
            return False
    return bool(dfa.accepting[state])


# ---------------------------------------------------------------------------
# DFA -> token-level automaton arrays
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TokenAutomaton:
    """Device-ready guided-decoding tables.

    Row 0 is FREE (unguided: all tokens allowed, self-loop, EOS allowed);
    regex states are offset by 1. allowed (S, V) bool; next_state (S, V) i32.
    """

    allowed: np.ndarray
    next_state: np.ndarray
    start: int  # state id to assign a newly-admitted guided slot

    FREE = 0


def build_token_automaton(pattern: str, token_bytes: list[bytes],
                          eos_token_id: int) -> TokenAutomaton:
    dfa = compile_regex(pattern)
    n_dfa = dfa.table.shape[0]
    vocab = len(token_bytes)

    max_len = max((len(t) for t in token_bytes), default=1)
    tok_arr = np.zeros((vocab, max_len), np.int32)
    tok_len = np.zeros((vocab,), np.int32)
    for i, tb in enumerate(token_bytes):
        tok_len[i] = len(tb)
        if tb:
            tok_arr[i, :len(tb)] = np.frombuffer(tb, np.uint8)

    # vectorized token walk: states (n_dfa, vocab)
    states = np.tile(np.arange(n_dfa, dtype=np.int32)[:, None], (1, vocab))
    for pos in range(max_len):
        active = tok_len > pos
        byte_col = tok_arr[:, pos]
        stepped = dfa.table[states, byte_col[None, :]]
        states = np.where(active[None, :], stepped, states)

    allowed = states != dfa.dead
    # zero-length tokens stay in place but are never useful; forbid them
    allowed &= tok_len[None, :] > 0

    # EOS: allowed exactly in accepting states, transitions to dead-free self
    if 0 <= eos_token_id < vocab:
        allowed[:, eos_token_id] = dfa.accepting
        states[:, eos_token_id] = np.arange(n_dfa)

    # assemble with the FREE row at index 0
    full_allowed = np.ones((n_dfa + 1, vocab), bool)
    full_next = np.zeros((n_dfa + 1, vocab), np.int32)  # FREE self-loops to 0
    full_allowed[1:] = allowed
    full_next[1:] = states + 1
    # dead dfa row (last) would allow nothing: guarantee progress by allowing
    # EOS there so a desynced slot can terminate
    if 0 <= eos_token_id < vocab:
        dead_row = 1 + dfa.dead
        full_allowed[dead_row, :] = False
        full_allowed[dead_row, eos_token_id] = True
    return TokenAutomaton(allowed=full_allowed, next_state=full_next,
                          start=1 + dfa.start)


def closed_free_states(allowed: np.ndarray, next_state: np.ndarray,
                       ignore: np.ndarray | None = None) -> np.ndarray:
    """Boolean mask of token-automaton states where guided decoding is a
    no-op forever: every token is allowed (hence EOS — allowed only in
    accepting states), and every transition stays inside the set, so no
    future step can reintroduce a constraint.

    The pipeline's metadata regex (reference pipeline.py:304-307) ends in
    ``(?:---|---\\n[\\s\\S]+)`` — once a slot enters the free-text tail it
    lands here, and the engine can hand it to the speculative decode path
    (which skips per-token mask gathers) without changing output semantics.
    Greatest fixed point of free(s) = allowed[s].all() ∧ ∀v free(next[s,v]).

    ignore (V,) bool exempts tokens from the allowed-everywhere check:
    callers pass the zero-length tokens (vocab holes / byte-less specials,
    which build_token_automaton force-forbids). They contribute no bytes
    and self-loop in the DFA, so emitting one during speculation leaves the
    regex match intact — but EOS must NOT be exempted even when byte-less
    (emitting it early would truncate the match), which the engine enforces
    when building the mask.

    Documented tradeoff: a speculating guided slot may therefore emit a
    byte-less special token the per-step guided path would force-forbid, so
    raw token-id streams (and logprobs) can diverge between speculative and
    plain guided decoding even though the decoded TEXT and the regex match
    are identical. Exact token-stream parity would require post-masking the
    verify logits with allowed[state] for free states — not worth a gather
    per verified token for a cosmetic invariant; logprob-requesting slots
    already take the per-step path (engine._spec_ok).
    """
    ok = allowed if ignore is None else (allowed | ignore[None, :])
    free = ok.all(axis=1)
    while True:
        nxt = free & free[next_state].all(axis=1)
        if np.array_equal(nxt, free):
            return nxt
        free = nxt


def _gpt2_byte_decoder() -> dict[str, int]:
    """Inverse of the GPT-2/Qwen ByteLevel bytes->unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def token_bytes_from_tokenizer(tok, vocab_size: int) -> list[bytes]:
    """Per-token byte strings for mask building.

    HF byte-level BPE tokenizers (Qwen's) represent raw bytes as mapped
    unicode chars in the token string; decoding single ids mangles
    multi-byte UTF-8, so tokens are recovered through the ByteLevel inverse
    map. Falls back to per-id decode for simple tokenizers (the byte-level
    test tokenizer)."""
    inner = getattr(tok, "_tok", None)
    if inner is not None and hasattr(inner, "convert_ids_to_tokens"):
        byte_decoder = _gpt2_byte_decoder()
        out = []
        for i in range(vocab_size):
            token = inner.convert_ids_to_tokens(i)
            if token is None:
                out.append(b"")
                continue
            if all(c in byte_decoder for c in token):
                out.append(bytes(byte_decoder[c] for c in token))
            else:
                # special/added token: its literal text
                out.append(token.encode("utf-8"))
        return out
    return [tok.decode([i]).encode("utf-8") for i in range(vocab_size)]

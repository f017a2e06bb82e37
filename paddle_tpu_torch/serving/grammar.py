"""Constrained decoding: token-mask automata tables and a per-slot state
lane advanced inside the step.

Port of ``paddle_tpu/serving/grammar.py`` (its own copy, numpy and torch
only).  A :class:`GrammarTable` stacks every registered grammar's DFA
into two tensors on the engine's device:

- ``trans [G, S_max, V] int32``: the next automaton state per (grammar,
  state, token);
- ``mask  [G, S_max, V] bool``: token legality per (grammar, state);

row 0 is the **unconstrained** grammar (mask all True, trans all 0), so
unconstrained slots go through the same gathers.  The sampler keeps two
more ``[slots] int32`` lanes (the grammar id and the automaton state) and
applies ``where(mask[g, s], logits, -1e30)`` before sampling: ``-1e30``
is exactly 0 probability under the f32 softmax and loses every argmax and
Gumbel comparison, so an illegal token is never drawn, greedy or sampled.
For grammar 0 the all-True row makes the ``where`` a bitwise identity: a
sampler with a table serves unconstrained slots as one without.

The state advances by one gather (``trans[g, s, tok]``) inside the step,
right after sampling: no host read, so the step stays one CUDA graph.
The host keeps the numpy ``trans`` too (:attr:`GrammarTable.trans_host`),
from which a step retry rebuilds a slot's state by walking its emitted
tokens (:meth:`GrammarTable.walk`).

:class:`JsonArrayGrammar` is a bounded-counter DFA over single-character
tokens (token id == character code) accepting the JSON arrays of at most
``max_elems`` non-negative integers of at most ``max_digits`` digits (no
leading zeros).  It is total: every non-terminal state has a legal
continuation, and the longest accepted stream is ``max_tokens`` tokens,
so a decode budget past that always ends in the accepting state, where
only EOS is legal.  At a larger vocabulary (Llama's 32000) it is the
same automaton over token ids; it says nothing of a tokenizer's text.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["JsonArrayGrammar", "GrammarTable"]

_NEG_INF = -1e30


class JsonArrayGrammar:
    """Bounded JSON-array-of-integers DFA over character-level tokens.

    Accepts exactly ``[]`` and ``[n, n, ...]`` with 1..``max_elems``
    elements, each a non-negative integer of 1..``max_digits`` digits
    with no leading zeros, then requires EOS.  Token id == ASCII code
    (``[`` = 91, ``]`` = 93, ``,`` = 44, ``0``-``9`` = 48..57).

    States (``n_states = 2 + max_elems * (max_digits + 1)``): 0 ``START``
    (only ``[``), 1 ``DONE`` (accepting; only ``eos_token_id``, a self
    loop), ``ELEM_OPEN(e)`` (element ``e``'s first digit; ``]`` too iff
    ``e == 0``) and ``IN_NUM(e, d)`` (``d`` digits read; more digits while
    ``d < max_digits``, ``,`` while another element fits, ``]`` always;
    a first digit ``0`` jumps to ``IN_NUM(e, max_digits)``)."""

    def __init__(self, eos_token_id: int, *, max_elems: int = 3,
                 max_digits: int = 2):
        if max_elems < 1 or max_digits < 1:
            raise ValueError("JsonArrayGrammar needs max_elems >= 1 and "
                             "max_digits >= 1")
        self.eos_token_id = int(eos_token_id)
        self.max_elems = int(max_elems)
        self.max_digits = int(max_digits)
        self.n_states = 2 + self.max_elems * (self.max_digits + 1)
        #: longest accepted token stream, EOS included
        self.max_tokens = 2 + self.max_elems * (self.max_digits + 1)

    _START, _DONE = 0, 1

    def _elem_open(self, e: int) -> int:
        return 2 + e * (self.max_digits + 1)

    def _in_num(self, e: int, d: int) -> int:
        return 2 + e * (self.max_digits + 1) + d

    def build(self, vocab_size: int):
        """``(trans [S, V] int32, mask [S, V] bool)`` as numpy arrays."""
        V = int(vocab_size)
        need = max(93, self.eos_token_id)        # ']' is the largest char
        if V <= need:
            raise ValueError(
                f"JsonArrayGrammar needs vocab_size > {need} (character-"
                f"level token ids + eos {self.eos_token_id}), got {V}")
        LBRACK, RBRACK, COMMA = 91, 93, 44
        digits = list(range(48, 58))
        S = self.n_states
        trans = np.zeros((S, V), dtype=np.int32)
        mask = np.zeros((S, V), dtype=bool)

        def edge(s: int, tok: int, nxt: int) -> None:
            mask[s, tok] = True
            trans[s, tok] = nxt

        edge(self._START, LBRACK, self._elem_open(0))
        edge(self._DONE, self.eos_token_id, self._DONE)
        for e in range(self.max_elems):
            opn = self._elem_open(e)
            if e == 0:
                edge(opn, RBRACK, self._DONE)
            edge(opn, digits[0], self._in_num(e, self.max_digits))
            for dg in digits[1:]:
                edge(opn, dg, self._in_num(e, 1))
            for d in range(1, self.max_digits + 1):
                s = self._in_num(e, d)
                edge(s, RBRACK, self._DONE)
                if e + 1 < self.max_elems:
                    edge(s, COMMA, self._elem_open(e + 1))
                if d < self.max_digits:
                    for dg in digits:
                        edge(s, dg, self._in_num(e, d + 1))
        return trans, mask

    def accepts(self, token_ids: Sequence[int], vocab_size: int) -> bool:
        """Host oracle: every step of the walk over ``token_ids`` (EOS
        included if emitted) is legal and the walk ends in ``DONE``."""
        trans, mask = self.build(vocab_size)
        s = self._START
        for t in token_ids:
            t = int(t)
            if t >= vocab_size or not mask[s, t]:
                return False
            s = int(trans[s, t])
        return s == self._DONE


class GrammarTable:
    """Every registered grammar's DFA, stacked, on ``device``.

    ``specs`` maps a grammar's name (what ``SamplingParams.grammar``
    carries) to its spec (:class:`JsonArrayGrammar`).  Ids are 1..G in
    sorted name order; 0 is the unconstrained grammar.  States past a
    grammar's ``n_states`` pad with the unconstrained row: unreachable,
    but never an all ``-1e30`` row if indexed."""

    def __init__(self, vocab_size: int, specs: Dict[str, object], *,
                 device="cuda"):
        if not specs:
            raise ValueError("GrammarTable needs at least one grammar "
                             "spec (or pass grammars=None to the engine)")
        self.vocab_size = int(vocab_size)
        self.names = {name: gid for gid, name
                      in enumerate(sorted(specs), start=1)}
        self.specs = dict(specs)
        self.max_states = max(int(s.n_states) for s in specs.values())
        G = len(specs) + 1
        trans = np.zeros((G, self.max_states, self.vocab_size),
                         dtype=np.int32)
        mask = np.ones((G, self.max_states, self.vocab_size), dtype=bool)
        for name, gid in self.names.items():
            t, m = specs[name].build(self.vocab_size)
            trans[gid, :t.shape[0]] = t
            mask[gid, :m.shape[0]] = m
        #: the host's copy, walked by a step retry (:meth:`walk`)
        self.trans_host = trans
        self.device = torch.device(device)
        self.trans = torch.from_numpy(trans).to(self.device)
        self.mask = torch.from_numpy(mask).to(self.device)

    # -- host side ---------------------------------------------------------

    def gid_of(self, name: Optional[str]) -> int:
        """A request's grammar id: 0 (unconstrained) for None."""
        if name is None:
            return 0
        try:
            return self.names[name]
        except KeyError:
            raise KeyError(
                f"unknown grammar {name!r}; registered: "
                f"{sorted(self.names)}") from None

    def spec_of(self, name: str):
        self.gid_of(name)                 # the KeyError with the listing
        return self.specs[name]

    def walk(self, gid: int, tokens: Sequence[int]) -> int:
        """The automaton state after ``tokens`` from state 0, on the
        host's ``trans``: what the state lane holds once a slot has
        emitted ``tokens``."""
        s = 0
        for t in tokens:
            s = int(self.trans_host[gid, s, int(t)])
        return s

    # -- inside the step programs ------------------------------------------

    def mask_rows(self, logits: torch.Tensor, gids: torch.Tensor,
                  states: torch.Tensor) -> torch.Tensor:
        """``where(mask[g, s], logits, -1e30)`` for ``[N, V]`` logits and
        ``[N]`` lanes.  Grammar-0 rows come through bitwise (the select
        copies the logits' values)."""
        legal = self.mask[gids.long(), states.long()]
        return torch.where(legal, logits, logits.new_full((), _NEG_INF))

    def advance(self, gids: torch.Tensor, states: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
        """Next state per row, ``trans[g, s, tok]``: one gather, int32."""
        return self.trans[gids.long(), states.long(), tokens.long()]

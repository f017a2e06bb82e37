"""Token sampling for the serving engine: on-device lanes + host oracle.

Port of ``paddle_tpu/serving/sampling.py``.  Per-slot temperature, top-k
and top-p live in ``[slots]`` device tensors and the sampled tokens in a
device token lane that feeds the next decode step.  ``jax.random`` key
lanes become two more device lanes, a seed and a draw counter per slot:
the Gumbel noise of a draw is a counter-based hash of (seed, counter,
vocabulary index) in plain integer ops, so a step holds no host state and
one captured CUDA graph serves greedy and sampling slots alike.  A slot's
stream depends only on its own seed and its own draws.  The two
frameworks give different numbers from one seed, so only the laws (and
the same-seed replay within the port) carry over.

Constrained decoding (``DeviceSampler(grammar=)``, a
:class:`~.grammar.GrammarTable`): two more ``[slots] int32`` lanes hold
each slot's grammar id and automaton state.  Logits are masked before
:func:`device_sample` (so greedy argmaxes the masked row and a draw
comes from the masked law) and the state advances right after, inside
the step.  Grammar 0 masks nothing, bitwise.

:func:`sample` is the host reference (float32 numpy) the device path is
held against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = ["SamplingParams", "sample", "masked_logits", "uniform_noise",
           "gumbel_noise", "device_sample", "DeviceSampler",
           "ACCEPT_SEED_SALT", "RESAMPLE_SEED_SALT"]

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF

#: XORed into a slot's seed for the speculative acceptance uniforms and
#: for the resample noise of a round (:meth:`DeviceSampler.accept_speculative`):
#: two streams independent of each other and of the plain decode noise at
#: the slot's own seed.  The salts sit in the seed's high 32 bits, which a
#: small request seed leaves at zero.
ACCEPT_SEED_SALT = 0x41CCE97A << 32
RESAMPLE_SEED_SALT = 0x2E5A4D1F << 32


@dataclass
class SamplingParams:
    """Per-request decoding strategy: ``temperature == 0`` is greedy
    argmax; ``top_k > 0`` keeps the k most probable tokens; ``top_p < 1``
    keeps the smallest nucleus reaching ``top_p`` (after top-k, on the
    tempered law); ``seed`` fixes the request's random stream.

    Tenancy: ``adapter`` names a LoRA adapter loaded in the engine's
    :class:`~.adapters.AdapterPool` (None: the base model); ``grammar``
    names a grammar of its :class:`~.grammar.GrammarTable` (None:
    unconstrained).  Both are per-slot lane values, never part of a step
    program, and both are journaled with the admission."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    adapter: Optional[str] = None
    grammar: Optional[str] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        for f in ("adapter", "grammar"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, str):
                raise ValueError(f"{f} must be a name (str) or None, "
                                 f"got {type(v).__name__}")


def _host_masked_logits(logits: np.ndarray,
                        params: SamplingParams) -> np.ndarray:
    z = logits / np.float32(params.temperature)
    if params.top_k:
        k = min(params.top_k, z.shape[0])
        kth = np.partition(z, -k)[-k]
        z = np.where(z >= kth, z, np.float32(_NEG_INF))
    if params.top_p < 1.0:
        p = np.exp(z - z.max(), dtype=np.float32)
        p /= p.sum(dtype=np.float32)
        order = np.argsort(-p, kind="stable")
        csum = np.cumsum(p[order], dtype=np.float32)
        keep = (csum - p[order]) < np.float32(params.top_p)
        threshold = p[order][keep.sum() - 1]
        z = np.where(p >= threshold, z, np.float32(_NEG_INF))
    return z


def sample(logits: np.ndarray, params: SamplingParams,
           rng: Optional[np.random.RandomState] = None) -> int:
    """Host reference: the next token from a ``[vocab]`` logits row,
    float32 math."""
    logits = np.asarray(logits, dtype=np.float32).reshape(-1)
    if params.temperature == 0.0:
        return int(np.argmax(logits))
    z = _host_masked_logits(logits, params)
    p = np.exp(z - z.max(), dtype=np.float32).astype(np.float64)
    p /= p.sum()
    return int((rng or np.random).choice(p.shape[0], p=p))


def masked_logits(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Tempered + top-k/top-p-masked logits ``[N, V]``, per row (port of
    ``_device_masked_logits``).  One descending sort serves both masks;
    the nucleus cut is carried back as a z-space threshold; rows with
    ``top_p >= 1`` skip the nucleus mask."""
    V = logits.shape[-1]
    neg = logits.new_full((), _NEG_INF)
    z = logits / temps[:, None]
    k = torch.where(top_ks > 0, top_ks.clamp(1, V),
                    torch.full_like(top_ks, V)).long()
    z_desc = torch.sort(z, dim=-1, descending=True).values
    kth = z_desc.gather(1, (k - 1)[:, None])
    z = torch.where(z >= kth, z, neg)
    z_desc = torch.where(z_desc >= kth, z_desc, neg)
    p_desc = torch.softmax(z_desc, dim=-1)
    csum = torch.cumsum(p_desc, dim=-1)
    keep_n = ((csum - p_desc) < top_ps[:, None]).sum(dim=-1)
    z_thr = z_desc.gather(1, (keep_n - 1)[:, None])
    return torch.where((z >= z_thr) | (top_ps[:, None] >= 1.0), z, neg)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for 32-bit lanes ``x`` held in int64: ``c`` is
    split in 16-bit halves, so that no product passes 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective avalanche hash of 32-bit lanes held in int64 (the
    ``lowbias32`` mixer: xor-shift, multiply, xor-shift, multiply,
    xor-shift)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_noise(seeds: torch.Tensor, counters: torch.Tensor,
                  n: int) -> torch.Tensor:
    """``[N, n]`` f32 uniforms, a counter-based hash of (``seeds[i]``,
    ``counters[i]``, column index): ``seeds`` and ``counters`` are
    ``[N]`` int64.  Every lane is a 32-bit value kept in int64 and masked
    after each step, so no op relies on signed overflow; the uniform
    takes the hash's top 23 bits into the open interval (0, 1):
    ``(h + 0.5) / 2**23``, from 2**-24 to 1 - 2**-24."""
    lo = seeds & _MASK32
    hi = (seeds >> 32) & _MASK32
    key = _mix32(_mix32(_mix32(lo ^ 0x9E3779B9) ^ hi)
                 ^ (counters & _MASK32))
    idx = _mix32(torch.arange(n, device=seeds.device) + 0x85EBCA6B)
    h = _mix32(key[:, None] ^ idx[None, :])
    return ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``[N, vocab]`` f32 standard Gumbel noise from the uniforms of
    :func:`uniform_noise` at (``seeds[n]``, ``counters[n]``)."""
    return -torch.log(-torch.log(uniform_noise(seeds, counters, vocab)))


def device_sample(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor,
                  seeds: torch.Tensor, counters: torch.Tensor
                  ) -> torch.Tensor:
    """One token per row of ``[N, V]`` f32 logits, on the logits' device.

    Rows with ``temps <= 0`` take the argmax of the raw logits.  The others
    draw from the masked law by Gumbel-max, the noise from
    :func:`gumbel_noise` at their row's seed and counter (every row
    computes it; a greedy row ignores it).  Returns ``[N]`` int32."""
    logits = logits.float()
    greedy = temps <= 0.0
    z = masked_logits(logits, torch.where(greedy, torch.ones_like(temps),
                                          temps), top_ks, top_ps)
    drawn = torch.argmax(z + gumbel_noise(seeds, counters, z.shape[-1]),
                         dim=-1)
    return torch.where(greedy, torch.argmax(logits, dim=-1),
                       drawn).to(torch.int32)


def _seed_lane(seed: int) -> int:
    """A request seed as the int64 lane value: its low 64 bits, signed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s - (1 << 64) if s >= 1 << 63 else s


class DeviceSampler:
    """Per-slot sampling state on the device, updated in place.

    Lanes: temperature, top-k, top-p, the last sampled token per slot (the
    next decode step's input ids), and each slot's seed and draw counter
    (int64).  :meth:`stage_slot` writes a request's parameters and seed
    into its slot and zeroes its counter, so a seed replays its stream; a
    draw advances the counter of the slot(s) that drew, inside the step.
    The step methods take the slot as data (a ``[1]`` device index) and
    make no host read, so they can be captured into a CUDA graph."""

    def __init__(self, num_slots: int, *, device="cuda", grammar=None):
        self.num_slots = int(num_slots)
        self.device = torch.device(device)
        #: a :class:`~.grammar.GrammarTable` or None (no grammar lanes)
        self.grammar = grammar
        n, dev = self.num_slots, self.device
        self.temps = torch.zeros(n, dtype=torch.float32, device=dev)
        self.top_ks = torch.zeros(n, dtype=torch.int32, device=dev)
        self.top_ps = torch.ones(n, dtype=torch.float32, device=dev)
        self.tokens = torch.zeros(n, dtype=torch.int32, device=dev)
        self.seeds = torch.zeros(n, dtype=torch.int64, device=dev)
        self.counters = torch.zeros(n, dtype=torch.int64, device=dev)
        self.grammar_ids = torch.zeros(n, dtype=torch.int32, device=dev)
        self.grammar_states = torch.zeros(n, dtype=torch.int32, device=dev)

    def stage_slot(self, slot: int, params: SamplingParams,
                   seed: int) -> None:
        self.seeds[slot] = _seed_lane(seed)
        self.counters[slot] = 0
        self.temps[slot] = float(params.temperature)
        self.top_ks[slot] = int(params.top_k)
        self.top_ps[slot] = float(params.top_p)
        if self.grammar is not None:
            # the grammar id and the start state: staged the same at a
            # resume or a recovery, so the replay walks the same path
            self.grammar_ids[slot] = self.grammar.gid_of(params.grammar)
            self.grammar_states[slot] = 0

    def reset(self) -> None:
        """Forget all slots (warmup scribbles over slot 0)."""
        for lane in (self.temps, self.top_ks, self.tokens, self.seeds,
                     self.counters, self.grammar_ids, self.grammar_states):
            lane.zero_()
        self.top_ps.fill_(1.0)

    def sample_slot(self, slot: torch.Tensor,
                    logits_row: torch.Tensor) -> torch.Tensor:
        """Prefill side: sample one slot's first token from its ``[1, V]``
        logits, write it into the token lane and advance the slot's
        counter.  ``slot`` is a ``[1]`` int64 device index.  Returns a
        ``[1]`` int32 device tensor."""
        lanes = [t.index_select(0, slot) for t in (
            self.temps, self.top_ks, self.top_ps, self.seeds,
            self.counters)]
        g = self.grammar
        if g is not None:
            # mask before the draw (greedy argmaxes the masked row too)
            gid = self.grammar_ids.index_select(0, slot)
            gst = self.grammar_states.index_select(0, slot)
            logits_row = g.mask_rows(logits_row, gid, gst)
        tok = device_sample(logits_row, *lanes)
        self.tokens.index_copy_(0, slot, tok)
        self.counters.index_copy_(0, slot, lanes[-1] + 1)
        if g is not None:
            self.grammar_states.index_copy_(0, slot,
                                            g.advance(gid, gst, tok))
        return tok

    def sample_all(self, logits: torch.Tensor,
                   drew: torch.Tensor) -> torch.Tensor:
        """Decode side: sample every slot from ``[slots, V]`` logits,
        rewrite the token lane (idle slots sample tokens nobody reads) and
        advance the counters of the slots in the ``[slots]`` int mask
        ``drew``.  Returns the ``[slots]`` int32 tokens."""
        g = self.grammar
        if g is not None:
            logits = g.mask_rows(logits, self.grammar_ids,
                                 self.grammar_states)
        toks = device_sample(logits, self.temps, self.top_ks, self.top_ps,
                             self.seeds, self.counters)
        self.tokens.copy_(toks)
        self.counters += drew
        if g is not None:
            # every slot's state moves, as in the JAX sampler: an idle
            # slot's is staged anew at its next admission
            self.grammar_states.copy_(g.advance(self.grammar_ids,
                                                self.grammar_states, toks))
        return toks

    def masked_probs(self, logits: torch.Tensor) -> torch.Tensor:
        """The laws a slot draws from, over a ``[S, W, V]`` verify window:
        each slot's temperature, top-k and top-p applied at every window
        position (:func:`masked_logits`, a greedy slot at temperature 1),
        then the softmax.  Port of ``DeviceSampler._masked_probs``; the
        grammar mask is applied upstream, to the logits of both models
        (:meth:`accept_speculative`)."""
        S, W, V = logits.shape
        temps = torch.where(self.temps <= 0.0, torch.ones_like(self.temps),
                            self.temps)
        z = masked_logits(logits.reshape(S * W, V).float(),
                          temps.repeat_interleave(W),
                          self.top_ks.repeat_interleave(W),
                          self.top_ps.repeat_interleave(W))
        return torch.softmax(z, dim=-1).reshape(S, W, V)

    def accept_speculative(self, target_logits: torch.Tensor,
                           draft_logits: torch.Tensor,
                           draft_tokens: torch.Tensor, cap: torch.Tensor,
                           active: torch.Tensor, draft_sampler
                           ) -> "tuple[torch.Tensor, torch.Tensor]":
        """Rejection-sampling acceptance of one speculative round, on the
        device with no host read (it runs inside the verify program).

        ``target_logits``/``draft_logits`` ``[S, W, V]`` score the window
        (position ``i`` scores the token after input ``i``, W = k + 1);
        ``draft_tokens`` ``[S, k]`` are the round's proposals, ``cap``
        ``[S]`` int32 the most tokens a slot may emit this round (its
        token budget and cache room), ``active`` ``[S]`` int32 the running
        slots.  Returns ``(emitted [S, W] int32, m [S] int32)``:
        ``emitted[:m]`` is the round's stream, ``1 <= m <= max(cap, 1)``.

        A greedy slot accepts a proposal iff it is the target argmax and
        emits the argmax on rejection, so every token it emits is the
        target argmax at its position: speculative greedy output is the
        plain engine's.  A sampling slot accepts proposal ``i`` with
        probability ``min(1, p_t/p_d)`` and on rejection draws from the
        normalised residual ``max(p_t - p_d, 0)``; past the last proposal
        it draws the bonus from ``p_t`` (the draft's mass there is zeroed,
        so one formula covers both); a residual with no mass (identical
        laws) falls back to ``p_t``.  Every emitted position is marginally
        the target law, and truncating the stream to ``cap`` keeps that.

        Where the randomness comes from.  A slot's counter ``c`` is the
        number of tokens it has emitted (the plain engine's rule, which
        ``Engine._restore_lanes`` rebuilds), and window position ``i``
        decides emitted token ``c + i``.  Its acceptance uniform and its
        resample Gumbel noise are drawn at counter ``c + i`` under the
        seeds ``seed ^ ACCEPT_SEED_SALT`` and ``seed ^ RESAMPLE_SEED_SALT``;
        the draft drew proposal ``i`` at its own counter ``c + i`` under
        ``seed ^ DRAFT_SEED_SALT``.  The tokens emitted this round are
        decided by the draws at positions ``0 .. m-1`` alone (position
        ``m-1`` is the first rejection or the bonus; the acceptance
        uniforms past it only move ``n_acc`` past the cap or the first
        rejection, which no emitted token reads).  The counter then
        advances by ``m`` in both samplers, so the next round starts at
        ``c + m`` and never reuses a draw that decided an emitted token:
        the draws it does reuse (positions ``m ..`` of this round) decided
        nothing that was emitted, so given everything emitted they are
        still fresh.  A seeded round replays the same from the same lanes.

        With a grammar table, both models' logits are masked at every
        window position by the state the draft held when it drew that
        position's proposal: the round-start state folded through the
        proposals.  Both laws then live on the same legal support, so the
        acceptance argument holds as it stands; the states folded through
        the emitted tokens (the first ``m``) go into both samplers' state
        lanes.

        Writes the pending token (``emitted[m-1]``) into both samplers'
        token lanes and the advanced counter into both counter lanes."""
        S, W, V = target_logits.shape
        k = W - 1
        dev = target_logits.device
        greedy = self.temps <= 0.0
        tl = target_logits.float()
        dl = draft_logits.float()
        gt = self.grammar
        if gt is not None:
            gids, st = self.grammar_ids, self.grammar_states
            g_start, legal = st, []
            for j in range(W):
                legal.append(gt.mask[gids.long(), st.long()])
                if j < k:
                    st = gt.advance(gids, st, draft_tokens[:, j])
            legal = torch.stack(legal, dim=1)                 # [S, W, V]
            neg = tl.new_full((), _NEG_INF)
            tl = torch.where(legal, tl, neg)
            dl = torch.where(legal, dl, neg)
        pt = self.masked_probs(tl)
        pd = draft_sampler.masked_probs(dl)
        # no proposal at position k: zero draft mass makes the residual
        # there the target law itself (the bonus draw)
        pd = torch.cat([pd[:, :k], torch.zeros_like(pd[:, k:])], dim=1)
        g = torch.argmax(tl, dim=-1).to(torch.int32)            # [S, W]
        dt = draft_tokens.long()[..., None]
        pt_d = pt[:, :k].gather(2, dt)[..., 0]
        pd_d = pd[:, :k].gather(2, dt)[..., 0]
        counters = self.counters[:, None] + torch.arange(W, device=dev)
        u = uniform_noise((self.seeds ^ ACCEPT_SEED_SALT)
                          .repeat_interleave(k),
                          counters[:, :k].reshape(-1), 1).reshape(S, k)
        ratio = pt_d / pd_d.clamp_min(1e-30)
        accept = torch.where(greedy[:, None],
                             draft_tokens.to(torch.int32) == g[:, :k],
                             u < ratio.clamp_max(1.0))
        n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
        res = (pt - pd).clamp_min(0.0)
        res = torch.where(res.sum(dim=-1, keepdim=True) <= 0.0, pt, res)
        noise = gumbel_noise((self.seeds ^ RESAMPLE_SEED_SALT)
                             .repeat_interleave(W),
                             counters.reshape(-1), V).reshape(S, W, V)
        # log(0) is -inf: a token outside the residual's support never wins
        rep = torch.argmax(torch.log(res) + noise, dim=-1).to(torch.int32)
        rep = torch.where(greedy[:, None], g, rep)
        d_pad = torch.cat([draft_tokens.to(torch.int32),
                           torch.zeros_like(draft_tokens[:, :1],
                                            dtype=torch.int32)], dim=1)
        idx = torch.arange(W, device=dev)[None, :]
        emitted = torch.where(idx < n_acc[:, None], d_pad, rep)
        m = torch.minimum(n_acc.to(torch.int32) + 1,
                          cap.to(torch.int32).clamp_min(1))
        pend = emitted.gather(1, (m - 1).long()[:, None])[:, 0]
        self.tokens.copy_(pend)
        draft_sampler.tokens.copy_(pend)
        self.counters += m * active
        draft_sampler.counters.copy_(self.counters)
        if gt is not None:
            st = g_start
            for j in range(W):
                st = torch.where(j < m, gt.advance(gids, st, emitted[:, j]),
                                 st)
            self.grammar_states.copy_(st)
            draft_sampler.grammar_states.copy_(st)
        return emitted, m

"""The port's dropout generator: counter-based random bits on the device.

Port of ``paddle_tpu/core/rng.py`` (``Generator``, ``seed``).  The JAX
package keeps a PRNG key as program state and splits it per random op;
here each device has a :class:`Generator` whose state is an ``int64[2]``
tensor on that device, ``[seed, offset]``.  A draw (:meth:`Generator.draw`)
returns a snapshot of the state, and adds one to the offset on the device.
Both are device ops: a step captured into a CUDA graph snapshots and
advances the offset at every replay, so every replay draws fresh bits, and
no draw reads a device value on the host.

The bits are Philox-4x32-10 (Salmon et al., SC'11, the Random123
constants) of a 128-bit counter under a 64-bit key.  For a snapshot
``[seed, offset]`` the key is ``(seed_lo, seed_hi ^ offset_hi)`` and the
counter's last word is ``offset_lo``; its first three words carry the
coordinates of the element, so a bit depends only on (seed, offset,
element), never on how a kernel tiles the work:

- :func:`dropout_keep` (a hidden dropout of ``n`` elements): element ``i``
  is word ``i % 4`` of the counter ``(i // 4 lo, i // 4 hi, 0, offset_lo)``;
- :func:`attention_dropout_factor` (attention probabilities of row ``r``,
  column ``c`` of head row ``bh = b * H + h``): word
  ``((r >> 3) & 1) * 2 + (c & 1)`` of the counter
  ``(c >> 1, (r >> 4) * 8 + (r & 7), bh, offset_lo)``, so one counter
  covers rows ``r, r + 8`` and columns ``c, c + 1`` as the tensor-core
  attention kernels hold them (``csrc/attention_common.cuh``,
  ``pt::Dropout``, computes the same words).

A rank of a sharded model draws at the coordinates the element has in
the whole tensor (:func:`shard_coordinates`): a hidden dropout's index is
offset by the rank's batch start times the size of one sample, and an
attention head row is ``(batch_start + b) * heads_total + head_start +
h``.  So the union of the ranks' masks is the one-process mask, as a
sharded dropout mask of the JAX package is one logical mask, partitioned
(``fleet/meta_parallel/parallel_layers/random.py:1-11``).  The attention
draw carries its coordinates in its snapshot (``int64[5]``: ``[seed,
offset, batch_start, head_start, heads_total]``), so a backward that
recomputes the factors away from the context draws the same bits.

An element is kept iff its full 32-bit word is ``>= round(p * 2**32)``,
so the keep rate is ``1 - p`` to within ``2**-32``.  Everything here is
plain PyTorch on 32-bit lanes held in int64 (as
``serving/sampling.py``'s hash): the products of Philox's
multiplications are formed from 16-bit halves, so no op relies on signed
overflow.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

__all__ = ["Generator", "default_generator", "seed", "philox4x32_10",
           "keep_threshold", "dropout_keep", "attention_dropout_factor",
           "get_rng_state", "set_rng_state", "shard_coordinates",
           "shard_state", "with_coordinates"]

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57        # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85        # its Weyl key increments
ROUNDS = 10


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for 32-bit lanes ``a``
    held in int64: ``m`` is split in 16-bit halves, so that no product
    passes ``2**48``."""
    t0 = a * (m & 0xFFFF)
    t1 = a * (m >> 16)
    hi = (t1 + (t0 >> 16)) >> 16
    lo = (t0 + ((t1 & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 of the counter ``(c0, c1, c2, c3)`` under the key
    ``(k0, k1)``: int64 tensors (or ints) of 32-bit lanes that broadcast
    together.  Returns the four 32-bit output words as int64 tensors."""
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key_and_offset(snap: torch.Tensor):
    """``(k0, k1, offset_lo)`` of a ``[seed, offset]`` snapshot, as int64
    tensors of one element on its device (no host read)."""
    s, off = snap[0:1], snap[1:2]
    return (s & _MASK32, ((s >> 32) ^ (off >> 32)) & _MASK32,
            off & _MASK32)


def keep_threshold(p: float) -> int:
    """The word threshold of drop rate ``p``: keep iff word >= it."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1], got {p}")
    return int(round(p * 2 ** 32))


#: this rank's place in the whole tensors: ``batch_start`` (the first
#: sample it holds), ``head_start`` and ``heads_total`` (its attention
#: heads among all; None: all of them)
_shard = {"batch_start": 0, "head_start": 0, "heads_total": None}


@contextlib.contextmanager
def shard_coordinates(**coords):
    """Draw inside the block at the given coordinates (``batch_start``,
    ``head_start``, ``heads_total``; the others stay as they are).  Where
    nothing changes, nothing is written (a traced or exported region sees
    no state change)."""
    unknown = set(coords) - set(_shard)
    if unknown:
        raise TypeError(f"shard_coordinates: unknown {sorted(unknown)}")
    new = {k: v for k, v in coords.items()
           if v is not None and _shard[k] != v}
    if not new:
        yield
        return
    old = dict(_shard)
    _shard.update(new)
    try:
        yield
    finally:
        _shard.clear()
        _shard.update(old)


def shard_state() -> dict:
    """The coordinates now in force (to re-enter them later)."""
    return dict(_shard)


def with_coordinates(snap: torch.Tensor, heads: int) -> torch.Tensor:
    """An attention draw with the coordinates now in force for a tensor of
    ``heads`` local heads: ``snap`` itself at the origin, else
    ``[seed, offset, batch_start, head_start, heads_total]``."""
    b0, h0 = _shard["batch_start"], _shard["head_start"]
    total = _shard["heads_total"] or heads
    if not (b0 or h0 or total != heads):
        return snap
    return torch.cat([snap, torch.tensor([b0, h0, total], dtype=torch.int64)
                      .to(snap.device)])


def dropout_keep(snap: torch.Tensor, shape, p: float) -> torch.Tensor:
    """The bool keep mask of ``shape`` for the draw ``snap``
    (``int64[2]``, :meth:`Generator.draw`): element ``i`` of the
    flattened shape is kept iff word ``i % 4`` of Philox at counter
    ``(i // 4, 0, 0, offset)`` is ``>= keep_threshold(p)``; inside
    :func:`shard_coordinates` ``i`` is offset by ``batch_start`` samples
    (dim 0 of ``shape``)."""
    n = 1
    for s in shape:
        n *= int(s)
    base = 0
    if _shard["batch_start"] and len(shape) and int(shape[0]):
        base = _shard["batch_start"] * (n // int(shape[0]))
    k0, k1, off = _key_and_offset(snap)
    first, end = base // 4, (base + n + 3) // 4
    calls = torch.arange(first, end, dtype=torch.int64, device=snap.device)
    words = philox4x32_10(calls & _MASK32, calls >> 32,
                          torch.zeros_like(off), off, k0, k1)
    lead = base - 4 * first
    words = torch.stack(words, dim=-1).reshape(-1)[lead:lead + n]
    return (words >= keep_threshold(p)).reshape(tuple(shape))


def attention_dropout_factor(snap: torch.Tensor, bh: int, rows: int,
                             cols: int, p: float,
                             heads: Optional[int] = None) -> torch.Tensor:
    """``[bh, rows, cols]`` f32 factors of attention dropout: ``1/(1-p)``
    where the probability at (head row, query, key) is kept, 0 where it is
    dropped (the words of the module docstring).  A snapshot with
    coordinates (:func:`with_coordinates`) places head row ``b * heads +
    h`` at its row in the whole tensor."""
    k0, k1, off = _key_and_offset(snap)
    dev = snap.device
    nb, cp = (rows + 15) // 16, (cols + 1) // 2
    heads_idx = torch.arange(bh, dtype=torch.int64, device=dev)
    if snap.numel() > 2:
        b0, h0, total = snap[2], snap[3], snap[4]
        h = heads or bh
        heads_idx = (b0 + heads_idx // h) * total + h0 + heads_idx % h
    heads = heads_idx.view(bh, 1, 1)
    grp = torch.arange(nb * 8, dtype=torch.int64, device=dev).view(1, -1, 1)
    pair = torch.arange(cp, dtype=torch.int64, device=dev).view(1, 1, cp)
    words = philox4x32_10(pair, grp, heads, off, k0, k1)
    # word 2 * half + cbit is (row 16 nb + 8 half + r8, col 2 pair + cbit)
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1) \
        .view(bh, nb, 8, cp, 2, 2).permute(0, 1, 4, 2, 3, 5) \
        .reshape(bh, nb * 16, cp * 2)[:, :rows, :cols]
    keep = w >= keep_threshold(p)
    scale = 1.0 / (1.0 - p) if p < 1.0 else 0.0
    return keep.to(torch.float32) * scale


class Generator:
    """The dropout generator of one device: an ``int64[2]`` state
    ``[seed, offset]`` on it (made here, never inside a graph capture)."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "rng: a device's dropout generator cannot be made inside a "
                "CUDA graph capture; draw from it once before capturing")
        self._state = torch.tensor([int(seed), 0], dtype=torch.int64,
                                   device=self.device)
        #: draws made through this generator (host count; a captured
        #: graph's replays do not add to it)
        self.draws = 0

    def manual_seed(self, seed: int) -> "Generator":
        """Seed ``seed``, offset 0, written in place (a captured graph
        keeps reading the same state)."""
        self._state.copy_(torch.tensor([int(seed), 0], dtype=torch.int64))
        return self

    def get_state(self) -> torch.Tensor:
        return self._state.clone()

    def set_state(self, state) -> None:
        """Load a :meth:`get_state` value in place (a captured graph keeps
        reading the same state tensor)."""
        self._state.copy_(torch.as_tensor(state).to(torch.int64).reshape(2))

    def draw(self) -> torch.Tensor:
        """A snapshot ``[seed, offset]`` for one random op; the offset then
        moves on by one, on the device."""
        snap = self._state.clone()
        self._state[1:].add_(1)
        self.draws += 1
        return snap

    def advance(self, n: int) -> None:
        """Move the offset on by ``n`` draws, on the device."""
        if n:
            self._state[1:].add_(n)
            self.draws += n

    def swap_state(self, state: torch.Tensor) -> torch.Tensor:
        """Draw from ``state`` from now on; returns the state it replaces
        (activation recompute runs a region on a state of its own)."""
        old, self._state = self._state, state
        return old


_generators: Dict[torch.device, Generator] = {}
_seed: Optional[int] = None

#: the CPU generator that parameter initializers draw from
#: (``nn.initializer``) unless given one of their own; :func:`seed` seeds
#: it too
init_generator = torch.Generator().manual_seed(0)


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_generator(device) -> Generator:
    """The generator of ``device``, made at first use with the last
    :func:`seed` (0 if none)."""
    key = _key(device)
    gen = _generators.get(key)
    if gen is None:
        gen = _generators[key] = Generator(key, 0 if _seed is None else _seed)
    return gen


def seed(s: int) -> None:
    """``paddle.seed``: seed every device's dropout generator with ``s``,
    offset 0 (those made later too), and :data:`init_generator`."""
    global _seed
    _seed = int(s)
    init_generator.manual_seed(_seed)
    for gen in _generators.values():
        gen.manual_seed(_seed)


def get_rng_state() -> Dict[str, torch.Tensor]:
    """``paddle.get_rng_state``: every device generator's state, ``{device:
    int64[2] [seed, offset]}`` (copies, on their devices)."""
    return {str(d): g.get_state() for d, g in _generators.items()}


def set_rng_state(state) -> None:
    """Load a :func:`get_rng_state` value in place into each named
    device's generator (one it does not name, made since, is reseeded
    with the last :func:`seed` at offset 0).  A JAX PRNG key (what the JAX package's
    ``get_rng_state`` gives, and its checkpoints hold under ``@rng``) is
    not a Philox ``[seed, offset]`` state: it raises."""
    if not isinstance(state, dict):
        raise ValueError(
            "set_rng_state: expected {device: [seed, offset]} (this "
            "package's get_rng_state), got "
            f"{type(state).__name__}; a JAX PRNG key, as the JAX package's "
            "checkpoints hold under '@rng', cannot seed this package's "
            "Philox generators (resume such a generation with "
            "include_rng=False)")
    for device, s in state.items():
        default_generator(device).set_state(s)
    # a generator made after the state was taken had not drawn then: it
    # goes back to its first state
    for device, gen in _generators.items():
        if str(device) not in state:
            gen.manual_seed(0 if _seed is None else _seed)

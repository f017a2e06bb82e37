"""Named dropout generator states for tensor-parallel regions.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/
random.py`` (``RNGStatesTracker`` :26, ``model_parallel_random_seed``
:69) on the port's Philox generators (:mod:`....rng`).  A state is an
``int64[2]`` ``[seed, offset]`` per device; ``rng_state(name)`` makes the
device generators draw from the named state inside the block (advancing
it) and puts their own state back after.

The port's tensor-parallel dropout needs no rank-local stream: every rank
draws at the coordinates its elements have in the whole tensor
(:func:`....rng.shard_coordinates`), so the union of the ranks' masks is
the one-process mask.  The tracker keeps Paddle's API, and seeds
disjoint named streams.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..... import rng as rng_mod

__all__ = ["MODEL_PARALLEL_RNG", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.seeds_ = set()
        self._seed_of: Dict[str, int] = {}
        #: name -> {device: int64[2] state}
        self.states_: Dict[str, Dict[torch.device, torch.Tensor]] = {}

    def add(self, name: str, seed: int) -> None:
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self._seed_of:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self._seed_of[name] = int(seed)
        self.states_[name] = {}

    def get_states_tracker(self) -> dict:
        return {n: {d: s.clone() for d, s in st.items()}
                for n, st in self.states_.items()}

    def set_states_tracker(self, states: dict) -> None:
        self.states_ = {n: dict(st) for n, st in states.items()}

    def _state(self, name: str, device: torch.device) -> torch.Tensor:
        st = self.states_[name]
        if device not in st:
            st[device] = torch.tensor([self._seed_of[name], 0],
                                      dtype=torch.int64, device=device)
        return st[device]

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        """Draw from state ``name`` inside the block, on every device that
        has a generator (and the card, or the CPU without one)."""
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        rng_mod.default_generator("cuda" if torch.cuda.is_available()
                                  else "cpu")
        swapped = [(g, g.swap_state(self._state(name, key)))
                   for key, g in list(rng_mod._generators.items())]
        try:
            yield
        finally:
            for g, own in swapped:
                g.swap_state(own)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed: int = 100) -> None:
    """Seed the global stream with ``seed`` and the model-parallel one
    with ``seed + 2048 + mp_rank`` (the JAX package's derivation)."""
    from ...topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg else 0
    tracker = get_rng_state_tracker()
    tracker.reset()
    rng_mod.seed(seed)
    tracker.add(MODEL_PARALLEL_RNG, seed + 2048 + mp_rank)

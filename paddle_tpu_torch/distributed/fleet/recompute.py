"""Activation recompute: one region's activations dropped in the forward
and recomputed in the backward.

Port of ``paddle_tpu/distributed/fleet/utils/recompute.py``.  The JAX
package wraps a region in ``jax.checkpoint``; here it is
``torch.utils.checkpoint`` (non-reentrant).  Dropout inside the region
must draw the same masks when the backward runs the region again, and
``preserve_rng_state`` does not cover the port's generator (:mod:`...rng`).
So, as the JAX design draws "one fresh key per region" (``recompute.py:
57-64``), the region's dropout state is drawn outside the checkpoint and
passed in: a device snapshot ``[seed, offset]`` of the generator of the
first tensor argument's device.  The region's draws run on a copy of that
snapshot, made anew each time the region runs, so its forward and its
recomputation take the same offsets; the generator then moves past the
draws the region made.  The offsets equal those of the same forward
without recompute, so recompute on and off draw identical masks.  In the
same way the region runs under the AMP policy (:mod:`...amp.auto_cast`)
and the dropout coordinates (:func:`...rng.shard_coordinates`) it was
entered with, also when the backward recomputes it (outside the
``auto_cast`` block, perhaps on another thread), so the recomputed
activations have the dtypes the forward saved.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ... import rng as rng_mod
from ...amp.auto_cast import _policy, amp_state

__all__ = ["recompute"]


def recompute(function, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, **kwargs):
    """Run ``function(*args, **kwargs)`` as a recompute region and return
    its output.  ``preserve_rng_state`` and ``use_reentrant`` are taken for
    the JAX package's signature, which ignores them too: the dropout state
    is always kept (see the module), and the checkpoint is always the
    non-reentrant one."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors:
        raise ValueError("recompute: the region needs a tensor argument")
    gen = rng_mod.default_generator(tensors[0].device)
    base = gen.get_state()
    policy = amp_state()
    coords = rng_mod.shard_state()
    draws = []

    def region(base_state, *a):
        outer = gen.swap_state(base_state.clone())
        before = gen.draws
        try:
            with _policy(policy), rng_mod.shard_coordinates(**coords):
                out = function(*a, **kwargs)
        finally:
            draws.append(gen.draws - before)
            gen.draws = before
            gen.swap_state(outer)
        return out

    out = torch.utils.checkpoint.checkpoint(
        region, base, *args, use_reentrant=False, preserve_rng_state=False)
    gen.advance(draws[0])
    return out

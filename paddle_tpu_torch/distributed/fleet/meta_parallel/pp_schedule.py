"""The pipeline schedules, as plain lists of actions per stage.

Port of the role of ``paddle_tpu/distributed/fleet/meta_parallel/
pp_schedule.py``.  The JAX package compiles its pipeline into one
``lax.scan`` over stage-stacked parameters, with ``ppermute`` between
ticks and per-tick remat (``pp_schedule.py:1-30``): a TPU design with no
counterpart here.  The port runs Paddle's own design (the reference's
``pipeline_parallel.py:82-147``, which the JAX docstring cites): one
process per stage, a 1F1B schedule (start-up, steady, cool-down), and
activations and gradients moving between pipe neighbours.  This module
says only *what* each stage does in which order; the engine
(:mod:`.pipeline_parallel`) runs it.

An action is ``(kind, micro, chunk)``: ``kind`` is ``"F"`` (the forward
of micro-batch ``micro`` through the stage's local model chunk ``chunk``)
or ``"B"`` (its backward).  With ``num_virtual`` chunks per stage
(interleaved, Megatron's schedule), local chunk ``c`` of stage ``s`` is
global chunk ``c * num_stages + s``; micro-batches go through the global
chunks in order.

:func:`simulate` runs every stage's list against the data dependencies
(a forward needs the previous global chunk's forward of its micro-batch,
a backward the next chunk's backward), with sends that never block, and
returns the order the actions could run in, or raises on a deadlock.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["one_f_one_b", "interleaved", "forward_only", "schedule",
           "simulate"]

Action = Tuple[str, int, int]


def one_f_one_b(num_stages: int, stage: int, num_micro: int
                ) -> List[Action]:
    """1F1B: ``num_stages - stage - 1`` forwards to fill the pipe, then
    one forward and one backward in turn, then the remaining backwards."""
    warmup = min(num_stages - stage - 1, num_micro)
    acts: List[Action] = [("F", m, 0) for m in range(warmup)]
    for i in range(num_micro - warmup):
        acts.append(("F", warmup + i, 0))
        acts.append(("B", i, 0))
    acts += [("B", m, 0) for m in range(num_micro - warmup, num_micro)]
    return acts


def _virtual(k: int, num_stages: int, num_virtual: int,
             backward: bool) -> Tuple[int, int]:
    """``(micro, chunk)`` of a stage's ``k``-th forward (or backward)
    under the interleaved schedule: micro-batches in groups of
    ``num_stages``, each group through every chunk in turn."""
    group = num_stages * num_virtual
    chunk = (k % group) // num_stages
    if backward:
        chunk = num_virtual - 1 - chunk
    return (k // group) * num_stages + k % num_stages, chunk


def interleaved(num_stages: int, stage: int, num_micro: int,
                num_virtual: int) -> List[Action]:
    """Megatron's interleaved 1F1B over ``num_virtual`` chunks a stage
    (``num_micro`` a multiple of ``num_stages``)."""
    if num_micro % num_stages:
        raise ValueError(f"the interleaved schedule needs micro-batches "
                         f"({num_micro}) divisible by stages ({num_stages})")
    total = num_micro * num_virtual
    warmup = min((num_stages - stage - 1) * 2
                 + (num_virtual - 1) * num_stages, total)

    def f(k):
        return ("F",) + _virtual(k, num_stages, num_virtual, False)

    def b(k):
        return ("B",) + _virtual(k, num_stages, num_virtual, True)

    acts: List[Action] = [f(k) for k in range(warmup)]
    for i in range(total - warmup):
        acts.append(f(warmup + i))
        acts.append(b(i))
    acts += [b(k) for k in range(total - warmup, total)]
    return acts


def forward_only(num_stages: int, stage: int, num_micro: int,
                 num_virtual: int = 1) -> List[Action]:
    """Every forward, in the order the training schedule runs them."""
    return [a for a in schedule(num_stages, stage, num_micro, num_virtual)
            if a[0] == "F"]


def schedule(num_stages: int, stage: int, num_micro: int,
             num_virtual: int = 1) -> List[Action]:
    if num_virtual > 1:
        return interleaved(num_stages, stage, num_micro, num_virtual)
    return one_f_one_b(num_stages, stage, num_micro)


def simulate(lists: List[List[Action]], num_virtual: int = 1
             ) -> List[Tuple[int, Action]]:
    """Run each stage's action list in order against the dependencies
    (see the module); returns the ``(stage, action)`` order of one
    execution.  Raises ``RuntimeError`` on a deadlock, ``ValueError``
    when a list misses or repeats an action."""
    P = len(lists)
    last = P * num_virtual - 1
    done: Dict[Tuple[str, int, int], bool] = {}
    pos = [0] * P
    order = []

    def ready(s, act):
        kind, m, c = act
        g = c * P + s
        if kind == "F":
            return g == 0 or done.get(("F", m, g - 1), False)
        if not done.get(("F", m, g), False):
            return False
        return g == last or done.get(("B", m, g + 1), False)

    while any(pos[s] < len(lists[s]) for s in range(P)):
        moved = False
        for s in range(P):
            if pos[s] < len(lists[s]) and ready(s, lists[s][pos[s]]):
                kind, m, c = lists[s][pos[s]]
                key = (kind, m, c * P + s)
                if key in done:
                    raise ValueError(f"stage {s} repeats {lists[s][pos[s]]}")
                done[key] = True
                order.append((s, lists[s][pos[s]]))
                pos[s] += 1
                moved = True
        if not moved:
            raise RuntimeError(
                "pipeline schedule deadlocks at "
                + ", ".join(f"stage {s}: {lists[s][pos[s]]}"
                            for s in range(P) if pos[s] < len(lists[s])))
    n_micro = len({m for (_, m, _) in done})
    if len(done) != 2 * n_micro * (last + 1):
        raise ValueError("a schedule misses actions")
    return order

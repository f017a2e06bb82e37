"""``fleet`` at one process and one card: ``init``,
``distributed_model``, ``distributed_optimizer`` and ``recompute``.

Port of ``paddle_tpu/distributed/fleet/__init__.py`` (:36-140) for the
single-card case ``bench.py`` (:153, :173, :177) runs: the wrappers are the
identity.  A strategy that asks for a model, pipeline, sharding or
sequence degree above 1, or a data degree above 1, raises
``NotImplementedError``: hybrid parallelism is ROADMAP.md A.5.
"""
from __future__ import annotations

from typing import Optional

from ..strategy import DistributedStrategy
from .recompute import recompute

__all__ = ["DistributedStrategy", "distributed_model",
           "distributed_optimizer", "init", "recompute"]


def _check(strategy: Optional[DistributedStrategy]) -> None:
    if strategy is None:
        return
    hc = strategy.hybrid_configs
    over = {n: getattr(hc, n) for n in ("mp_degree", "pp_degree",
                                        "sharding_degree", "sep_degree")
            if getattr(hc, n) > 1}
    if hc.dp_degree > 1:
        over["dp_degree"] = hc.dp_degree
    if over:
        raise NotImplementedError(
            f"fleet: hybrid parallelism {over} is not ported (ROADMAP.md "
            "A.5); the port runs one process on one card")


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None) -> None:
    """Check ``strategy``: every degree 1."""
    _check(strategy)


def distributed_model(model):
    """The model itself (one card)."""
    return model


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """The optimizer itself (one card); ``strategy`` is checked as
    :func:`init` checks it."""
    _check(strategy)
    return optimizer

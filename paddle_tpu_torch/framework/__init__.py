"""``paddle.framework``: ``save`` and ``load`` (:mod:`.io`)."""
from .io import load, save

__all__ = ["load", "save"]

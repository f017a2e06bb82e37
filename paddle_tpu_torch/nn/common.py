"""``Dropout`` under its earlier import path (now :mod:`.layer.common`)."""
from .layer.common import Dropout

__all__ = ["Dropout"]

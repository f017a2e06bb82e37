"""``fleet.utils``: activation recompute and the file-system clients."""
from ..recompute import recompute
from .fs import HDFSClient, LocalFS

__all__ = ["recompute", "LocalFS", "HDFSClient"]

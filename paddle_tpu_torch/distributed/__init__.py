"""paddle_tpu_torch.distributed: the port's slice of
``paddle_tpu.distributed``: fault tolerance for training and serving
(:mod:`.fault_tolerance`), the format-2 checkpoints (:mod:`.checkpoint`), ``fleet`` at one card (:mod:`.fleet`:
``init``, ``distributed_model``, ``distributed_optimizer``,
``recompute``) with its :class:`DistributedStrategy`, and what sharded
serving stands on: process groups and one-axis meshes over
``torch.distributed`` (:mod:`.mesh`, :mod:`.sharding_spec`) and the
tensor-parallel layers (:mod:`.fleet.meta_parallel`)."""
from . import checkpoint, fault_tolerance, fleet
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "checkpoint", "fault_tolerance", "fleet"]

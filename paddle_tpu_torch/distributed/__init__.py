"""paddle_tpu_torch.distributed: the port's slice of
``paddle_tpu.distributed``: the serving engine's fault tolerance
(:mod:`.fault_tolerance`), ``fleet`` at one card (:mod:`.fleet`:
``init``, ``distributed_model``, ``distributed_optimizer``,
``recompute``) with its :class:`DistributedStrategy`, and what sharded
serving stands on: process groups and one-axis meshes over
``torch.distributed`` (:mod:`.mesh`, :mod:`.sharding_spec`) and the
tensor-parallel layers (:mod:`.fleet.meta_parallel`)."""
from . import fault_tolerance, fleet
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "fault_tolerance", "fleet"]

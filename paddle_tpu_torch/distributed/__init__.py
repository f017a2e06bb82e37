"""paddle_tpu_torch.distributed: the port's slice of
``paddle_tpu.distributed``; so far the serving engine's fault tolerance
(:mod:`.fault_tolerance`)."""
from . import fault_tolerance

__all__ = ["fault_tolerance"]

"""The serving engine's fault tolerance: deterministic fault injection
(:class:`ServingFaultPlan`, armed from ``PADDLE_TPU_FT_SERVING_FAULTS``)
and hang detection (:class:`StepWatchdog`).  The training half of the
JAX package's ``distributed.fault_tolerance`` (``ResilientLoop``, the
divergence sentry, the training ``FaultPlan``) is not ported yet."""
from .injection import (
    ENV_SERVING_FAULTS, SERVING_FAULT_POINTS, InjectedFault,
    ReplicaScopedFaultPlan, ServingFaultPlan,
)
from .watchdog import ELASTIC_EXIT_CODE, StepWatchdog, dump_all_stacks

__all__ = ["ServingFaultPlan", "ReplicaScopedFaultPlan", "InjectedFault",
           "SERVING_FAULT_POINTS", "ENV_SERVING_FAULTS", "StepWatchdog",
           "dump_all_stacks", "ELASTIC_EXIT_CODE"]

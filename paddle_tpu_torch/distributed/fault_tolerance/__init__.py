"""Fault tolerance for training and serving.

Port of ``paddle_tpu/distributed/fault_tolerance``: step-granular
auto-resume (:class:`ResilientLoop`) over the CRC-checked generation
checkpoints of :mod:`..checkpoint`, hang detection (:class:`StepWatchdog`),
deterministic chaos injection (:class:`FaultPlan` for training,
:class:`ServingFaultPlan` for the serving engine, :func:`corrupt_shard`),
and the cheap recovery tier: the divergence latch inside the step
(:class:`DivergenceSentry`), host-RAM snapshot rollback
(:class:`MemorySnapshotRing`) and :class:`SentryEscalation` after
``max_rollbacks`` consecutive rollbacks, and the elastic mesh tier
(:class:`MeshWatchdog`: per-host heartbeats through the elastic
coordinator, the wedged-collective deadline, the straggler EMA).
"""
from .injection import (
    ELASTIC_FAULT_POINTS, ENV_SERVING_FAULTS, ENV_TRAIN_FAULTS,
    SERVING_FAULT_POINTS, TRAIN_FAULT_POINTS, FaultPlan, InjectedFault,
    ReplicaScopedFaultPlan, ServingFaultPlan, corrupt_shard,
)
from .memory_checkpoint import MemorySnapshotRing, restore_packed_state
from .mesh_watchdog import MeshWatchdog
from .resilient_loop import ResilientLoop, pack_state, world_descriptor
from .sentry import (
    ANOMALY_GRAD_RATIO, ANOMALY_LOSS_SPIKE, ANOMALY_NONFINITE_GRAD,
    ANOMALY_NONFINITE_LOSS, DivergenceSentry, SentryEscalation, SentryReport,
    global_grad_norm,
)
from .watchdog import ELASTIC_EXIT_CODE, StepWatchdog, dump_all_stacks

__all__ = [
    "ResilientLoop", "StepWatchdog", "MeshWatchdog", "FaultPlan", "ServingFaultPlan",
    "ReplicaScopedFaultPlan", "InjectedFault", "SERVING_FAULT_POINTS",
    "TRAIN_FAULT_POINTS", "ELASTIC_FAULT_POINTS", "ENV_SERVING_FAULTS",
    "ENV_TRAIN_FAULTS", "corrupt_shard", "dump_all_stacks",
    "ELASTIC_EXIT_CODE", "pack_state", "world_descriptor",
    "DivergenceSentry", "SentryEscalation", "SentryReport",
    "MemorySnapshotRing", "restore_packed_state", "global_grad_norm",
    "ANOMALY_NONFINITE_LOSS", "ANOMALY_NONFINITE_GRAD",
    "ANOMALY_LOSS_SPIKE", "ANOMALY_GRAD_RATIO",
]

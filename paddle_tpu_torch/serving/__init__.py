"""Continuous-batching serving of the port: engine, caches, sampling,
the overload regime, the request tracer, the request journal,
speculative decoding, multi-tenant serving (LoRA adapter lanes,
grammar-constrained decoding), the sync sanitizer, tensor-parallel
sharded serving and the fleet of supervised engine replicas (shard groups
among them)."""
from .adapters import AdapterConfig, AdapterPool, make_lora_weights
from .engine import (
    PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL, Engine, EngineStopped,
    QueueFull, Request, ShedReject,
)
from .journal import JournalCorrupt, RequestJournal
from .grammar import GrammarTable, JsonArrayGrammar
from .kv_cache import CacheContext, KVCache
from .metrics import FleetMetrics, ServingMetrics
from .paging import BlockAllocator, PagedCacheContext, PagedKVCache
from .prefix_cache import PrefixCache
from .router import Fleet, FleetRequest
from .sampling import DeviceSampler, SamplingParams
from .sanitize import SyncSanitizer
from .sharding import (
    ServingShard, degrade_step, mesh_shape_key, serving_mesh, viable_ladder,
)
from .spec_decode import SpecConfig, SpecState
from .tracing import (
    NULL_TRACER, FlightRecorder, RequestTracer, validate_trace,
)

__all__ = ["Engine", "Request", "QueueFull", "ShedReject", "EngineStopped",
           "RequestJournal", "JournalCorrupt", "PRIORITY_LOW",
           "PRIORITY_NORMAL", "PRIORITY_HIGH", "CacheContext", "KVCache",
           "BlockAllocator", "PagedCacheContext", "PagedKVCache",
           "PrefixCache", "DeviceSampler", "SamplingParams",
           "ServingMetrics", "SpecConfig", "SpecState", "RequestTracer",
           "NULL_TRACER", "FlightRecorder", "validate_trace",
           "AdapterConfig", "AdapterPool", "make_lora_weights",
           "GrammarTable", "JsonArrayGrammar", "SyncSanitizer", "Fleet",
           "FleetRequest", "FleetMetrics", "ServingShard", "serving_mesh",
           "mesh_shape_key", "viable_ladder", "degrade_step"]

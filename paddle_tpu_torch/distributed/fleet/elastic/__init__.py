"""Elastic training (reference: python/paddle/distributed/fleet/elastic):
the port's copy of ``paddle_tpu/distributed/fleet/elastic``."""
from .manager import (  # noqa: F401
    ELASTIC_EXIT_CODE, ELASTIC_TIMEOUT, ELASTIC_TTL, ElasticLevel,
    ElasticManager, ElasticStatus, FileCoordinator, InMemoryCoordinator,
    LauncherInterface, health_prefix,
)

__all__ = [
    "ElasticManager", "ElasticLevel", "ElasticStatus", "LauncherInterface",
    "InMemoryCoordinator", "FileCoordinator", "ELASTIC_TIMEOUT",
    "ELASTIC_TTL",
    "ELASTIC_EXIT_CODE", "health_prefix",
]

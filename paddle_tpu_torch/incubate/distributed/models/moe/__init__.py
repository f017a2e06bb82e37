"""``paddle.incubate.distributed.models.moe`` (port of
``paddle_tpu/incubate/distributed/models/moe``): :class:`MoELayer` and its
gates."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import MoELayer  # noqa: F401

__all__ = ["MoELayer", "BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]

"""``paddle.incubate.distributed`` (port of
``paddle_tpu/incubate/distributed``): the MoE models."""
from . import models  # noqa: F401

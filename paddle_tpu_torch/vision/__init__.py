"""``paddle.vision`` (port of ``paddle_tpu/vision``): the ResNet family
(:mod:`.models`) and the datasets (:mod:`.datasets`).  The other model
files, ``transforms``, ``vision.ops`` and ``image`` are not ported yet."""
from . import datasets, models
from .models import *  # noqa: F401,F403

__all__ = ["datasets", "models"] + models.__all__

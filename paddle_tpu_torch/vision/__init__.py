"""``paddle.vision`` (port of ``paddle_tpu/vision``): the model zoo
(:mod:`.models`), :mod:`.transforms` (host-side numpy), the datasets
(:mod:`.datasets`), the detection operators (:mod:`.ops`) and the image
backend (:mod:`.image`)."""
from . import datasets, image, models, ops, transforms
from .image import get_image_backend, image_load, set_image_backend
from .models import *  # noqa: F401,F403

__all__ = ["datasets", "image", "models", "ops", "transforms",
           "get_image_backend", "image_load",
           "set_image_backend"] + models.__all__

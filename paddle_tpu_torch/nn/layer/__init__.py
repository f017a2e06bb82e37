"""The layers of ``nn`` (port of ``paddle_tpu/nn/layer``)."""
from . import (  # noqa: F401
    activation, common, container, conv, loss, norm, pooling, transformer,
)

"""``paddle.distribution`` (port of ``paddle_tpu/distribution``):
probability distributions, transforms and the KL registry on torch
tensors, drawing from the port's Philox generators
(:mod:`.distribution`)."""
from . import transform
from .beta import Beta
from .categorical import Categorical
from .dirichlet import Dirichlet
from .distribution import Distribution
from .exponential_family import ExponentialFamily
from .independent import Independent
from .kl import kl_divergence, register_kl
from .multinomial import Multinomial
from .normal import Normal
from .transform import (  # noqa: F401
    AbsTransform, AffineTransform, ChainTransform, ExpTransform,
    IndependentTransform, PowerTransform, ReshapeTransform, SigmoidTransform,
    SoftmaxTransform, StackTransform, StickBreakingTransform, TanhTransform,
    Transform,
)
from .transformed_distribution import TransformedDistribution
from .uniform import Uniform

__all__ = [
    "Beta", "Categorical", "Dirichlet", "Distribution", "ExponentialFamily",
    "Multinomial", "Normal", "Uniform", "kl_divergence", "register_kl",
    "Independent", "TransformedDistribution",
]
__all__.extend(transform.__all__)

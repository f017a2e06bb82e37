"""``paddle.nn`` as ``torch.nn.Module``s: port of ``paddle_tpu/nn``.

Layers (:mod:`.layer`) are ``torch.nn.Module`` subclasses of
:class:`.layer_base.Layer` with Paddle's constructors, parameter names
and shapes (torch's ``[out, in]`` for ``Linear``), so a JAX layer tree's
``state_dict()`` carries into its counterpart through
``models.port_state_dict_from_jax``; :mod:`.functional` holds the
functionals, :mod:`.initializer` the parameter laws, :mod:`.utils` weight
and spectral norm, :mod:`.clip` gradient clipping.  The attention layers
reach the flash kernels through
:func:`.functional.scaled_dot_product_attention`.  Not ported yet: the
RNN layers and cells, ``BeamSearchDecoder`` and ``dynamic_decode``
(``nn/layer/rnn.py``, ``nn/layer/decode.py``; ROADMAP A.5 step 3b).
"""
from . import functional, initializer, utils
from .clip import (
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
)
from .functional.norm import layer_norm, rms_norm
from .layer.activation import (
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, SELU, Sigmoid, Silu, Softmax, Softmax2D, Softplus, Softshrink,
    Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU,
)
from .layer.common import (
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Fold, Identity, Linear, Pad1D,
    Pad2D, Pad3D, PairwiseDistance, PixelShuffle, PixelUnshuffle, Unfold,
    Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D,
)
from .layer.container import LayerDict, LayerList, ParameterList, Sequential
from .layer.conv import (
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose,
)
from .layer.loss import (
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, GaussianNLLLoss, HingeEmbeddingLoss, HSigmoidLoss, KLDivLoss,
    L1Loss, MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss, NLLLoss,
    PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss, TripletMarginLoss,
    TripletMarginWithDistanceLoss,
)
from .layer.norm import (
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm,
)
from .layer.pooling import (
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool1D,
    MaxUnPool2D, MaxUnPool3D,
)
from .layer.transformer import (
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from .layer_base import Layer, Parameter, ParamAttr

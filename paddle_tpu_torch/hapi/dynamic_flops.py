"""``paddle.flops``: forward flops by layer, from forward hooks.

Port of ``paddle_tpu/hapi/dynamic_flops.py``: a multiply-accumulate
counts as one flop; the same per-layer rules over the port's ``nn``
classes (a ``Linear``'s count reads both weight dims, so torch's ``[out,
in]`` counts as Paddle's ``[in, out]``); ``custom_ops`` maps a layer class
to ``fn(layer, input, output) -> flops``.
"""
from __future__ import annotations

import torch

from .summary import _device_of

__all__ = ["flops"]


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _count_linear(layer, x, y):
    return _numel(x.shape) // x.shape[-1] * int(layer.weight.shape[0]) \
        * int(layer.weight.shape[1])


def _count_conv(layer, x, y):
    return _numel(y.shape) * _numel(layer.weight.shape[1:])


def _count_norm(layer, x, y):
    return 2 * _numel(x.shape)


def _count_act(layer, x, y):
    return _numel(x.shape)


def _count_pool(layer, x, y):
    return _numel(y.shape)


def _count_embedding(layer, x, y):
    return 0


def _default_table():
    from .. import nn

    table = {}
    for name, fn in [
        ("Linear", _count_linear),
        ("Conv1D", _count_conv), ("Conv2D", _count_conv),
        ("Conv3D", _count_conv),
        ("Conv1DTranspose", _count_conv), ("Conv2DTranspose", _count_conv),
        ("BatchNorm", _count_norm), ("BatchNorm1D", _count_norm),
        ("BatchNorm2D", _count_norm), ("BatchNorm3D", _count_norm),
        ("LayerNorm", _count_norm), ("GroupNorm", _count_norm),
        ("ReLU", _count_act), ("GELU", _count_act), ("Sigmoid", _count_act),
        ("Tanh", _count_act), ("Softmax", _count_act),
        ("AvgPool1D", _count_pool), ("AvgPool2D", _count_pool),
        ("AvgPool3D", _count_pool), ("MaxPool1D", _count_pool),
        ("MaxPool2D", _count_pool), ("MaxPool3D", _count_pool),
        ("AdaptiveAvgPool2D", _count_pool),
        ("Embedding", _count_embedding),
    ]:
        cls = getattr(nn, name, None)
        if cls is not None:
            table[cls] = fn
    return table


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total forward flops of ``net`` on a float32 zero tensor of
    ``input_size`` (on the network's device, in ``eval()``)."""
    table = _default_table()
    if custom_ops:
        table.update(custom_ops)
    counts = {}

    def make_hook(fn):
        def hook(lyr, inp, out):
            x = inp[0] if isinstance(inp, (tuple, list)) else inp
            y = out[0] if isinstance(out, (tuple, list)) else out
            counts[id(lyr)] = counts.get(id(lyr), 0) + int(fn(lyr, x, y))

        return hook

    handles = [lyr.register_forward_hook(make_hook(table[type(lyr)]))
               for lyr in net.sublayers(include_self=True)
               if type(lyr) in table]
    dev = _device_of(net)
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(tuple(input_size), dtype=torch.float32,
                            device=dev))
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()
    total = sum(counts.values())
    if print_detail:
        for lyr in net.sublayers(include_self=True):
            if id(lyr) in counts:
                print(f"{type(lyr).__name__:24s} {counts[id(lyr)]:>14,d}")
        print(f"{'Total':24s} {total:>14,d}")
    return total

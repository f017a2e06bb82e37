"""``paddle.summary``: a table of the network's layers (type, output
shape, parameters) from forward hooks, and its parameter counts.

Port of ``paddle_tpu/hapi/summary.py``: the same rows, table and counts
(``trainable`` is ``requires_grad``).
"""
from __future__ import annotations

import torch

from ..nn.layer_base import Layer, _torch_dtype

__all__ = ["summary"]


def _device_of(net) -> torch.device:
    """The device of ``net``'s first parameter or buffer (CPU if none)."""
    for t in (*net.parameters(), *net.buffers()):
        return t.device
    return torch.device("cpu")


def summary(net: Layer, input_size=None, dtypes=None, input=None):
    """Print the layer table and return ``{"total_params",
    "trainable_params"}``.  With ``input_size`` (one shape, or a list of
    shapes) and ``dtypes`` (default float32) the network runs once in
    ``eval()`` on zeros on its device; with ``input`` on those tensors;
    with neither only the counts are printed."""
    rows = []

    def _hook(layer, inputs, outputs):
        n_params = sum(p.numel() for p in layer._parameters.values()
                       if p is not None)
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        shape = list(out.shape) if hasattr(out, "shape") else "?"
        rows.append((type(layer).__name__, shape, n_params))

    hooks = [l.register_forward_hook(_hook)
             for l in net.sublayers(include_self=False)]
    if input is None and input_size is not None:
        sizes = input_size if isinstance(input_size, list) and \
            isinstance(input_size[0], (list, tuple)) else [input_size]
        dts = dtypes if isinstance(dtypes, (list, tuple)) else \
            [dtypes or "float32"] * len(sizes)
        dev = _device_of(net)
        input = [torch.zeros(tuple(s), dtype=_torch_dtype(d or "float32"),
                             device=dev) for s, d in zip(sizes, dts)]
    try:
        if input is not None:
            ins = input if isinstance(input, (list, tuple)) else [input]
            was_training = net.training
            net.eval()
            with torch.no_grad():
                net(*ins)
            if was_training:
                net.train()
    finally:
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)

    header = f"{'Layer (type)':<28}{'Output Shape':<24}{'Param #':>10}"
    lines = ["-" * len(header), header, "=" * len(header)]
    for name, shape, n in rows:
        lines.append(f"{name:<28}{str(shape):<24}{n:>10}")
    lines += ["=" * len(header),
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              "-" * len(header)]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}

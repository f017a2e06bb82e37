"""``paddle.batch``: a sample reader wrapped into a mini-batch reader (port
of ``paddle_tpu/batch.py``; ``io.DataLoader`` is the modern path)."""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """A reader of lists of ``batch_size`` samples of ``reader()`` (the
    last one shorter unless ``drop_last``)."""
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer")

    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader

"""``paddle.onnx`` (reference ``python/paddle/onnx/export.py``, a thin
wrapper over the external ``paddle2onnx`` converter).

Port of ``paddle_tpu/onnx/__init__.py``.  The deployment format of this
package is :func:`..jit.save`'s ``torch.export`` program; like the
reference without ``paddle2onnx``, and like the JAX package, ``export``
raises with instructions.
"""

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, **configs):
    try:
        import paddle2onnx  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "paddle.onnx.export requires the external 'paddle2onnx' "
            "converter (the reference has the same runtime dependency). "
            "For deployment use paddle.jit.save, which writes a "
            "torch.export program.") from None
    raise NotImplementedError(
        "paddle2onnx does not read this package's torch.export programs; "
        "export with jit.save and convert with torch.onnx")

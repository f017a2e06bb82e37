"""``paddle.version``: this package's version, and the CUDA and cuDNN of
the torch it runs on (``cuda()`` and ``cudnn()``; "False" without)."""
from __future__ import annotations

import torch

full_version = "0.3.0"
major, minor, patch, rc = "0", "3", "0", "0"
istaged = True
commit = "torch-port"

__all__ = ["cuda", "cudnn", "show"]


def cuda() -> str:
    return torch.version.cuda or "False"


def cudnn() -> str:
    v = torch.backends.cudnn.version() if \
        torch.backends.cudnn.is_available() else None
    return str(v) if v else "False"


def show() -> None:
    for k, v in (("full_version", full_version), ("major", major),
                 ("minor", minor), ("patch", patch), ("rc", rc),
                 ("cuda", cuda()), ("cudnn", cudnn())):
        print(f"{k}: {v}")

"""Serving entry point of the port (``paddle_tpu/inference`` ``create_engine``)."""
from __future__ import annotations

import torch

from .serving import Engine

__all__ = ["create_engine"]


def create_engine(config, *, device="cuda", dtype=torch.float32,
                  seed: int = 0, journal=None, speculation=None,
                  **engine_kwargs) -> Engine:
    """Build a continuous-batching :class:`~.serving.Engine` from a
    ``GPTConfig``/``LlamaConfig``, a registry name (``"gpt:gpt2-345m"``,
    ``"llama:llama2-7b"``) or a model.

    A new model is built on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``) in ``dtype``, with weights drawn from a generator seeded
    with ``seed``; ``journal`` (a :class:`~.serving.RequestJournal`)
    journals every accepted request for ``Engine.recover``;
    ``speculation`` (a :class:`~.serving.SpecConfig`) serves in
    speculative rounds; ``engine_kwargs`` go to :class:`Engine`
    (``kv_layout``, ``block_size``, ``num_slots``, ``adapters``,
    ``grammars``, ...)."""
    return Engine.from_config(config, device=device, dtype=dtype, seed=seed,
                              journal=journal, speculation=speculation,
                              **engine_kwargs)

"""Viterbi decoding (port of ``paddle_tpu/text/viterbi_decode.py``).

A loop over time of torch ops on the potentials' device: the forward
max-product recursion keeps each step's best previous tag, then the
backtrace walks them from the best last tag.  Past a sequence's length its
score is carried unchanged and its back pointers are the identity, so one
pass serves every length of the batch; the path is zero there.  Ties go to
the first tag (``torch.argmax``, as ``jnp.argmax``).
"""
from __future__ import annotations

import torch

from ..nn import Layer

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def _viterbi(pot, trans, lengths, include_bos_eos_tag: bool):
    B, S, N = pot.shape
    dev = pot.device
    lengths = lengths.to(device=dev, dtype=torch.long)
    start_idx, stop_idx = N - 1, N - 2
    transf = trans.to(device=dev, dtype=torch.float32)
    alpha = pot[:, 0].to(torch.float32)
    if include_bos_eos_tag:
        alpha = alpha + transf[start_idx][None, :]
    ident = torch.arange(N, device=dev)[None, :].expand(B, N)
    bps = []
    for t in range(1, S):
        scores = alpha[:, :, None] + transf[None]            # [B, prev, next]
        best_prev = torch.argmax(scores, dim=1)               # [B, N]
        best = torch.amax(scores, dim=1) + pot[:, t].to(torch.float32)
        active = (t < lengths)[:, None]
        alpha = torch.where(active, best, alpha)
        bps.append(torch.where(active, best_prev, ident))
    if include_bos_eos_tag:
        alpha = alpha + transf[:, stop_idx][None, :]
    scores = torch.amax(alpha, dim=1).to(pot.dtype)
    tag = torch.argmax(alpha, dim=1)                          # [B]
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                     # [B, S]
    mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    return scores, torch.where(mask, path, torch.zeros_like(path))


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag: bool = True, name=None):
    """The highest-scoring tag sequence of emissions ``potentials [B, S,
    N]`` under ``transition_params [N, N]`` (with ``include_bos_eos_tag``
    the last two tags are the stop and start tags): ``(scores [B],
    paths [B, max(lengths)])``, the paths int64 and zero past each
    length.  Outside a CUDA graph capture the paths are cut to the
    longest length (one host read); inside one they keep all ``S``."""
    with torch.no_grad():
        scores, path = _viterbi(potentials, transition_params, lengths,
                                include_bos_eos_tag)
    lengths = torch.as_tensor(lengths)
    if not (lengths.is_cuda and torch.cuda.is_current_stream_capturing()):
        max_len = int(lengths.max()) if lengths.numel() else 0
        path = path[:, :max_len]
    return scores, path


class ViterbiDecoder(Layer):
    """The layer of :func:`viterbi_decode` over fixed ``transitions``."""

    def __init__(self, transitions, include_bos_eos_tag: bool = True,
                 name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)

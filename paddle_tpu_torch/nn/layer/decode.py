"""Sequence decoding: ``Decoder``, ``BeamSearchDecoder`` and
``dynamic_decode``.

Port of ``paddle_tpu/nn/layer/decode.py``.  ``dynamic_decode`` runs the
decoder's ``step`` eagerly until every beam is finished or
``max_step_num`` steps have run, pulling the step's ``finished`` to the
host once a step (the reference's contract); the beam bookkeeping is
torch ops on the cell's device and the backtrace is
``nn.functional.gather_tree``.

The K best of a step's ``[B, K·V]`` scores are chosen as
``jax.lax.top_k`` chooses them, the lower flat index first among equal
scores: a stable descending ``torch.sort`` and its first K, on every
device (``torch.topk`` promises no order among ties, and after
``initialize`` the K−1 beams seeded at −1e9 tie exactly in f32).  Token
ids, parents and lengths are int64 (the JAX package's int32).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..functional.extras import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


class Decoder:
    """The decode contract: ``initialize(inits) -> (inputs, states,
    finished)``; ``step(time, inputs, states, **kwargs) -> (outputs,
    states, next_inputs, finished)``; optional ``finalize``."""

    @property
    def tracks_own_finished(self):
        return False

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError


def _map_states(states, fn):
    if isinstance(states, (list, tuple)):
        return type(states)(_map_states(s, fn) for s in states)
    return fn(states)


class BeamSearchDecoder(Decoder):
    """Beam search over a cell ``cell(inputs, states, **kwargs) -> (out,
    states)``; ``embedding_fn`` maps token ids to the next step's inputs,
    ``output_fn`` the cell's output to vocabulary logits."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[batch, ...] -> [batch·beam, ...]``, each row repeated
        ``beam_size`` times in place."""
        return x.repeat_interleave(beam_size, dim=0)

    @staticmethod
    def _top_k(flat: torch.Tensor, k: int):
        """The ``k`` largest of each row and their indices, the lower index
        first among equal values (``lax.top_k``'s order)."""
        scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        return scores[:, :k], idx[:, :k]

    def initialize(self, initial_cell_states):
        cell_states = _map_states(
            initial_cell_states,
            lambda t: self.tile_beam_merge_with_batch(t, self.beam_size))
        first = initial_cell_states
        while isinstance(first, (list, tuple)):
            first = first[0]
        batch, dev = first.shape[0], first.device
        self._batch_size = batch
        # beam 0 live, the others at -1e9 so that step 1 fans out of one
        log_probs = torch.tensor(
            [0.0] + [-1e9] * (self.beam_size - 1), dtype=torch.float32,
            device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int64,
                              device=dev)
        inputs = torch.full((batch * self.beam_size,), self.start_token,
                            dtype=torch.int64, device=dev)
        if self.embedding_fn is not None:
            inputs = self.embedding_fn(inputs)
        states = self.StateWrapper(cell_states, log_probs, finished, lengths)
        return inputs, states, finished

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_cell_states = self.cell(inputs, states.cell_states,
                                               **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        V = cell_out.shape[-1]
        B, K = self._batch_size, self.beam_size
        finished, dev = states.finished, cell_out.device
        step_lp = torch.log_softmax(cell_out.float(), dim=-1) \
            .reshape(B, K, V)
        # a finished beam may emit only the end token (log-prob 0), so
        # its score stays as it is
        eos_only = torch.full((V,), -1e9, dtype=torch.float32, device=dev)
        eos_only[self.end_token] = 0.0
        step_lp = torch.where(finished[:, :, None], eos_only, step_lp)
        total = states.log_probs[:, :, None] + step_lp        # [B, K, V]
        top_scores, top_idx = self._top_k(total.reshape(B, K * V), K)
        parent = top_idx // V
        token = top_idx % V
        prev_fin = finished.gather(1, parent)
        new_fin = prev_fin | (token == self.end_token)
        new_len = states.lengths.gather(1, parent) + (~prev_fin).long()
        # the cell states follow their parent beams
        flat_parent = (parent + torch.arange(B, device=dev)[:, None] * K) \
            .reshape(-1)
        next_cell_states = _map_states(
            next_cell_states, lambda t: t.index_select(0, flat_parent))
        out = self.OutputWrapper(top_scores, token, parent)
        next_states = self.StateWrapper(next_cell_states, top_scores,
                                        new_fin, new_len)
        next_inputs = token.reshape(-1)
        if self.embedding_fn is not None:
            next_inputs = self.embedding_fn(next_inputs)
        return out, next_states, next_inputs, new_fin

    def finalize(self, outputs, final_states, sequence_lengths):
        """The token sequence of each final beam (``[T, B, K]``), walked
        back through the parents by ``gather_tree``."""
        return gather_tree(outputs.predicted_ids, outputs.parent_ids), \
            final_states

    @property
    def tracks_own_finished(self):
        return True


def _host_bool(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t).astype(bool)


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder.step`` until every beam is finished or
    ``max_step_num`` steps have run (None: until every beam is
    finished); ``kwargs`` go to each step.  Returns ``(outputs,
    final_states)`` (and the lengths with ``return_length``), outputs
    batch-major unless ``output_time_major``, ``None`` when no step ran.
    ``impute_finished`` zeroes the float outputs of beams finished
    before the step (the integer ids and parents stay, for the
    backtrace).  ``is_test`` is accepted and not read."""
    inputs, states, finished = decoder.initialize(inits)
    finished_arr = _host_bool(finished)
    step_outputs = []
    time = 0
    max_steps = max_step_num if max_step_num is not None else float("inf")
    while time < max_steps and not finished_arr.all():
        prev_finished = finished_arr
        out, states, inputs, step_finished = decoder.step(
            time, inputs, states, **kwargs)
        sf = _host_bool(step_finished)          # the step's one host pull
        # unless the decoder keeps its own finished set, a finished beam
        # stays finished
        finished_arr = sf if decoder.tracks_own_finished \
            else (prev_finished | sf)
        if impute_finished and prev_finished.any():
            def _impute(t):
                if not (isinstance(t, torch.Tensor)
                        and t.is_floating_point()):
                    return t
                mask = torch.from_numpy(prev_finished).to(t.device)
                mask = mask.reshape(mask.shape + (1,) * (t.dim()
                                                         - mask.dim()))
                return torch.where(mask, torch.zeros_like(t), t)

            out = type(out)(*[_impute(getattr(out, f))
                              for f in out._fields]) \
                if hasattr(out, "_fields") else _impute(out)
        step_outputs.append(out)
        time += 1

    seq_lengths = getattr(states, "lengths", None)
    if not step_outputs:
        return (None, states, seq_lengths) if return_length \
            else (None, states)

    first = step_outputs[0]
    if hasattr(first, "_fields"):
        stacked = type(first)(*[
            torch.stack([getattr(o, f) for o in step_outputs], dim=0)
            for f in first._fields])
    else:
        stacked = torch.stack(step_outputs, dim=0)

    if getattr(type(decoder), "finalize", Decoder.finalize) \
            is not Decoder.finalize:
        outputs, final_states = decoder.finalize(stacked, states,
                                                 seq_lengths)
    else:
        outputs, final_states = stacked, states

    def _to_batch_major(t):
        return t.transpose(0, 1) if t.dim() >= 2 else t

    if not output_time_major:
        if hasattr(outputs, "_fields"):
            outputs = type(outputs)(*[_to_batch_major(getattr(outputs, f))
                                      for f in outputs._fields])
        elif isinstance(outputs, torch.Tensor):
            outputs = _to_batch_major(outputs)
    if return_length:
        return outputs, final_states, seq_lengths
    return outputs, final_states

"""The pipeline engine: ``PipelineParallel``.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``
(``PipelineParallel`` :49, ``train_batch`` :131, ``eval_batch`` :171) in
Paddle's own design, one process per stage (see :mod:`.pp_schedule`):
the batch is cut into ``pipeline_configs.accumulate_steps``
micro-batches, and each stage runs its action list (1F1B, or the
interleaved schedule over virtual chunks).  A forward receives its input
from the previous global chunk's stage and sends its output to the next;
a backward receives the gradient of its output and sends the gradient of
its input back.  Each message is one ``dist.batch_isend_irecv``: a send
is posted and left in flight (waited for at the end of the batch), a
receive is waited for when its action runs, so no stage ever blocks on a
send (``pp_schedule.simulate`` checks the schedules under exactly that
rule).  An activation travels behind a small header (its shape and
dtype); activations move on the pipe group and gradients on the pipe
line's second group, so a backend that pairs messages by order (NCCL)
never mixes them, and every message carries a tag naming its micro-batch
and chunk (which gloo matches).

The last global chunk computes ``loss_fn(output, labels)`` for each
micro-batch and starts its backward from ``loss / accumulate_steps``.
After the backward, the tied weights' gradients are summed over the
stages that share them (:meth:`PipelineLayer.allreduce_shared_weight_
gradients`); ``train_batch`` then steps the optimizer (the hybrid
optimizer averages over the data ranks and clips over the pipe group)
and returns the mean micro-batch loss, broadcast from the last stage to
the pipe group.  ``forward`` and ``eval_batch`` run the forwards alone.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from .. import topology as topo_mod
from .parallel_layers.pp_layers import PipelineLayer
from .pp_schedule import forward_only, schedule
from .tensor_parallel import place_parameters

__all__ = ["PipelineParallel"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8]
_HEADER = 8          # ndim, dtype code, up to 6 dims


class PipelineParallel(nn.Module):
    """Runs a :class:`PipelineLayer` over the pipe axis of ``hcg``."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        hcg = hcg or topo_mod.get_hybrid_communicate_group()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        pcfg = strategy.pipeline_configs if strategy is not None else None
        self.accumulate_steps = pcfg.accumulate_steps if pcfg else 1
        self.micro_batch_size = pcfg.micro_batch_size if pcfg else 1
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.stage_id = hcg.get_stage_id()
        self.num_virtual = layers._num_virtual
        self._chunks = self.num_stages * self.num_virtual
        self._acts = hcg.get_pipe_parallel_group()
        self._grads = hcg.get_pipe_parallel_grad_group()
        self._next = hcg.get_p2p_next_rank()
        self._prev = hcg.get_p2p_prev_rank()
        self._last_rank = self._acts.ranks[-1]
        self._in_flight: list = []
        place_parameters(layers, hcg)
        layers.sync_shared_weights()

    # -- point to point -----------------------------------------------------

    def _post(self, op, t, peer: int, group, tag: int):
        reqs = dist.batch_isend_irecv([dist.P2POp(
            op, t, peer, group.process_group, tag)])
        if op is dist.isend:
            self._in_flight.append((reqs, t))
        else:
            for r in reqs:
                r.wait()
        return t

    def _send_act(self, t: torch.Tensor, tag: int) -> None:
        t = t.detach().contiguous()
        header = torch.zeros(_HEADER, dtype=torch.int64)
        header[0], header[1] = t.dim(), _DTYPES.index(t.dtype)
        header[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
        self._post(dist.isend, header.to(t.device), self._next, self._acts,
                   2 * tag)
        self._post(dist.isend, t, self._next, self._acts, 2 * tag + 1)

    def _recv_act(self, tag: int, device) -> torch.Tensor:
        header = self._post(dist.irecv, torch.zeros(_HEADER,
                                                    dtype=torch.int64,
                                                    device=device),
                            self._prev, self._acts, 2 * tag).tolist()
        shape = header[2:2 + header[0]]
        buf = torch.empty(shape, dtype=_DTYPES[header[1]], device=device)
        return self._post(dist.irecv, buf, self._prev, self._acts,
                          2 * tag + 1)

    def _drain(self) -> None:
        for reqs, _ in self._in_flight:
            for r in reqs:
                r.wait()
        self._in_flight.clear()

    def _broadcast_last(self, t: Optional[torch.Tensor], device
                        ) -> torch.Tensor:
        """The last stage's ``t`` on every rank of the pipe group."""
        header = torch.zeros(_HEADER, dtype=torch.int64, device=device)
        if t is not None:
            header[0], header[1] = t.dim(), _DTYPES.index(t.dtype)
            header[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
        dist.broadcast(header, self._last_rank, group=self._acts.process_group)
        h = header.tolist()
        if t is None:
            t = torch.empty(h[2:2 + h[0]], dtype=_DTYPES[h[1]], device=device)
        t = t.contiguous()
        dist.broadcast(t, self._last_rank, group=self._acts.process_group)
        return t

    # -- the schedule ---------------------------------------------------------

    def _split(self, t, n: int) -> list:
        if not isinstance(t, torch.Tensor) or n <= 1:
            return [t] * max(n, 1)
        if t.shape[0] % n:
            raise ValueError(f"batch size {t.shape[0]} is not divisible by "
                             f"accumulate_steps {n}")
        return list(t.chunk(n, dim=0))

    def _loss(self, out, labels) -> torch.Tensor:
        if self._layers._loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn for train_batch")
        loss = self._layers._loss_fn(out, labels)
        return loss.mean() if loss.dim() > 0 else loss

    def _run(self, actions, inputs, labels, train: bool, scaler=None):
        """Run ``actions``; returns the last stage's summed micro losses
        (``labels`` given) or its outputs, None elsewhere."""
        M = self.accumulate_steps
        last = self._chunks - 1
        micro_x = self._split(inputs, M)
        micro_y = self._split(labels, M) if labels is not None else None
        device = next((t.device for t in (inputs, labels)
                       if isinstance(t, torch.Tensor)), torch.device("cpu"))
        ins, outs, results = {}, {}, []
        total = None
        for kind, m, c in actions:
            g = c * self.num_stages + self.stage_id
            tag = m * self._chunks + g
            if kind == "F":
                if g == 0:
                    x = micro_x[m]
                else:
                    x = self._recv_act(tag - 1, device)
                    if train and x.is_floating_point():
                        x.requires_grad_()
                y = self._layers.forward_chunk(c, x)
                if g == last:
                    if micro_y is not None:
                        loss = self._loss(y, micro_y[m])
                        total = loss.detach() if total is None \
                            else total + loss.detach()
                        y = loss / M
                    else:
                        results.append(y.detach())
                else:
                    self._send_act(y, tag)
                if train:
                    ins[(m, c)], outs[(m, c)] = x, y
                continue
            x, y = ins.pop((m, c)), outs.pop((m, c))
            if g == last:
                (scaler.scale(y) if scaler is not None else y).backward()
            else:
                grad = self._post(dist.irecv, torch.empty_like(y), self._next,
                                  self._grads, tag + 1)
                torch.autograd.backward(y, grad)
            if g != 0:
                gx = x.grad if x.grad is not None else torch.zeros_like(x)
                self._post(dist.isend, gx.contiguous(), self._prev,
                           self._grads, tag)
        self._drain()
        if labels is not None:
            return total
        return torch.cat(results) if results else None

    def forward_backward_pipeline(self, data, scaler=None) -> torch.Tensor:
        """Forward and backward of every micro-batch of ``data = (inputs,
        labels)`` (this data rank's batch), the tied gradients summed;
        returns the mean micro loss on every pipe rank."""
        inputs, labels = data
        acts = schedule(self.num_stages, self.stage_id,
                        self.accumulate_steps, self.num_virtual)
        total = self._run(acts, inputs, labels, True, scaler)
        self._layers.allreduce_shared_weight_gradients()
        device = total.device if total is not None else inputs.device
        loss = total / self.accumulate_steps if total is not None else None
        return self._broadcast_last(loss, device)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss: bool = True):
        inputs, labels = data
        acts = forward_only(self.num_stages, self.stage_id,
                            self.accumulate_steps, self.num_virtual)
        if compute_loss and self._layers._loss_fn is not None:
            total = self._run(acts, inputs, labels, False)
            loss = total / self.accumulate_steps if total is not None \
                else None
            return self._broadcast_last(loss, inputs.device)
        return self._broadcast_last(self._run(acts, inputs, None, False),
                                    inputs.device)

    def forward(self, x):
        """The model's output on ``x`` (run as micro-batches through the
        stages, without gradients), on every pipe rank."""
        acts = forward_only(self.num_stages, self.stage_id,
                            self.accumulate_steps, self.num_virtual)
        with torch.no_grad():
            out = self._run(acts, x, None, False)
            return self._broadcast_last(out, x.device)

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict

"""``init_parallel_env`` and ``DataParallel``.

Port of ``paddle_tpu/distributed/parallel.py`` (``init_parallel_env`` :30,
``DataParallel`` :62) in its multi-controller mode (:90-122), which is
Paddle's own: one process per rank, each holding its own shard of the
batch and its own replica of the parameters.

:func:`init_parallel_env` makes the ``torch.distributed`` world from the
launcher's contract (:mod:`.env`): NCCL on the card (the process's card is
``PADDLE_LOCAL_RANK``), gloo on the CPU, rendezvous at ``PADDLE_MASTER``.
Without a launcher it makes a world of one (:func:`..mesh.ensure_world`).

:class:`DataParallel` broadcasts the parameters and buffers from the
group's first rank when it wraps them, and averages the gradients over
the group after each backward: the first gradient a backward accumulates
queues one callback at the end of that backward
(``Variable._execution_engine.queue_callback``), which all-reduces every
gradient in one flat buffer per dtype and divides by the group's size.
So, as in Paddle, each rank's loss is the mean over its own shard, and
after ``backward`` every rank holds the gradient of the mean over the
global batch.  ``no_sync()`` skips the averaging for the backwards inside
it (the gradients accumulate locally; the next backward outside it
averages the sum); :meth:`DataParallel.sync_gradients` averages now, once
per backward (a call after the automatic one does nothing).  On a group
of one nothing is registered and nothing communicates.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from . import env as env_mod
from . import mesh as mesh_mod

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "DataParallel", "sync_params_buffers", "average_gradients"]


def init_parallel_env(device="cuda") -> env_mod.ParallelEnv:
    """Make the default ``torch.distributed`` group from the launcher's
    contract, once (an existing world is kept): NCCL for
    ``device="cuda"`` (asking for it without a card raises), gloo for
    ``"cpu"``.  Returns the contract (its ``rank`` and ``world_size`` the
    world's)."""
    penv = env_mod.ParallelEnv()
    if not dist.is_initialized():
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init_parallel_env: device 'cuda' asked for, but no "
                    "CUDA device is available (pass device='cpu')")
            torch.cuda.set_device(penv.device_id % torch.cuda.device_count())
        if penv.launched:
            dist.init_process_group(
                mesh_mod.backend_for(dev),
                init_method=f"tcp://{penv.master}", rank=penv.rank,
                world_size=penv.world_size, timeout=mesh_mod.GROUP_TIMEOUT)
        elif penv.world_size > 1:
            raise RuntimeError(
                f"init_parallel_env: PADDLE_TRAINERS_NUM is "
                f"{penv.world_size} but no PADDLE_MASTER or "
                "PADDLE_TRAINER_ENDPOINTS names the rendezvous")
        else:
            mesh_mod.ensure_world(dev)
    penv.rank, penv.world_size = dist.get_rank(), dist.get_world_size()
    return penv


def get_rank(group=None) -> int:
    return env_mod.get_rank(group)


def get_world_size(group=None) -> int:
    return env_mod.get_world_size(group)


def _pg(group):
    """``(process group, size)`` of a collective ``Group``, a process
    group, or the world (None)."""
    if group is None:
        return None, dist.get_world_size() if dist.is_initialized() else 1
    pg = getattr(group, "process_group", group)
    if pg is None:
        return None, 1
    return pg, dist.get_world_size(pg)


@torch.no_grad()
def sync_params_buffers(module: nn.Module, group=None) -> None:
    """Broadcast every parameter and buffer of ``module`` from the first
    rank of ``group`` (the world by default) over it."""
    pg, n = _pg(group)
    if n == 1:
        return
    src = dist.get_global_rank(pg, 0) if pg is not None else 0
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src, group=pg)


def _flat_buckets(tensors: List[torch.Tensor]) -> Dict[torch.dtype, list]:
    buckets: Dict[torch.dtype, list] = {}
    for t in tensors:
        buckets.setdefault(t.dtype, []).append(t)
    return buckets


@torch.no_grad()
def average_gradients(params, group=None,
                      comm_dtype: Optional[torch.dtype] = None) -> None:
    """Average the gradients of ``params`` over ``group`` in place: one
    all-reduce of a flat buffer per dtype (``comm_dtype``: f32 gradients
    travel in it, summed there, then divided in f32)."""
    pg, n = _pg(group)
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for dtype, gs in _flat_buckets(grads).items():
        wire = comm_dtype if comm_dtype is not None and \
            dtype == torch.float32 else dtype
        flat = torch.cat([g.reshape(-1).to(wire) for g in gs])
        dist.all_reduce(flat, group=pg)
        flat = flat.to(dtype).div_(n)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


class DataParallel(nn.Module):
    """Data-parallel wrapper over ``group`` (the world by default): see the
    module.  ``state_dict`` and ``load_state_dict`` are the wrapped
    layer's, and its attributes read through."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        _, self._nranks = _pg(group)
        self._sync = True
        self._queued = False
        self._synced = False
        if self._nranks > 1:
            sync_params_buffers(layers, group)
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._grad_ready)

    def _grad_ready(self, _p) -> None:
        if self._sync and not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._end_of_backward)

    def _end_of_backward(self) -> None:
        self._queued = False
        self.sync_gradients()

    def forward(self, *inputs, **kwargs):
        self._synced = False
        return self._layers(*inputs, **kwargs)

    def sync_gradients(self) -> None:
        """Average the gradients over the group now (once per backward)."""
        if self._nranks == 1 or self._synced:
            return
        average_gradients(self._layers.parameters(), self._group)
        self._synced = True

    def scale_loss(self, loss):
        """The loss itself: the averaging divides by the group's size."""
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside accumulate their gradients locally."""
        old, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = old

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)

"""Semi-automatic parallelism: ``ProcessMesh``, ``shard_tensor``,
``shard_op`` and ``Engine``.

Port of ``paddle_tpu/distributed/auto_parallel/__init__.py`` (reference:
python/paddle/distributed/auto_parallel — interface.py:34 shard_tensor,
:73 shard_op, engine.py:51 Engine, process_mesh.py ProcessMesh) over
``torch.distributed``, one process a rank:

- A :class:`ProcessMesh` names global ranks in a (nested) list and its
  dims; :meth:`ProcessMesh.device_mesh` is the ``DeviceMesh`` with the
  same ``dim_names``.  The first one made is the default mesh.
- :func:`shard_tensor` returns a ``DTensor`` placed as a
  ``dims_mapping`` or a ``shard_spec`` says (a parameter: a new
  ``nn.Parameter`` over it); :func:`shard_op` redistributes a callable's
  outputs.  DTensor stays at this surface.
- :class:`Engine` runs ``prepare``d train, eval and predict steps, each a
  ``jit.to_static`` program, as ``_build_steps`` does in the JAX package
  (:238-267).  K1-K3's ``autograd.Function`` and a CUDA graph take plain
  tensors, so the step runs on this rank's local shards with explicit
  collectives, as GSPMD would partition the JAX program: the dim that
  ``inputs_spec`` names splits the batch (each rank takes its slice of
  the global batch, gradients are averaged over that dim as
  ``DataParallel`` averages them, and the loss reported is the mean over
  it); a dim named ``"model"`` splits the model into tensor-parallel
  shards (``models.shard_model``: the ``mp_layers`` that the JAX
  package's ``"model"`` annotation drives), with the optimizer moved onto
  the shard's parameters.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import mesh as mesh_mod
from ..sharding_spec import set_param_spec, to_placements

__all__ = ["ProcessMesh", "get_default_process_mesh", "shard_tensor",
           "shard_op", "Engine"]

_default_process_mesh: Optional["ProcessMesh"] = None


class ProcessMesh:
    """A Cartesian topology of processes (global ranks; reference:
    auto_parallel/process_mesh.py).  ``mesh`` is a (nested) list of
    ranks, its shape the topology; ``dim_names`` names the dims (default
    ``d0, d1, ...``)."""

    def __init__(self, mesh: Sequence,
                 dim_names: Optional[Sequence[str]] = None):
        arr = np.asarray(mesh, dtype=np.int64)
        if arr.ndim == 0:
            raise ValueError("process mesh must have at least one dimension")
        self._ids = arr
        self._dim_names = (list(dim_names) if dim_names is not None
                           else [f"d{i}" for i in range(arr.ndim)])
        if len(self._dim_names) != arr.ndim:
            raise ValueError(
                f"{len(self._dim_names)} dim_names for a {arr.ndim}-D mesh")
        self._device_meshes: dict = {}
        global _default_process_mesh
        if _default_process_mesh is None:
            _default_process_mesh = self

    @property
    def mesh(self):
        return self._ids.tolist()

    @property
    def topology(self) -> List[int]:
        return list(self._ids.shape)

    shape = topology

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def processes(self) -> List[int]:
        return self._ids.reshape(-1).tolist()

    @property
    def ndim(self) -> int:
        return self._ids.ndim

    def dim_size(self, name: str) -> int:
        """The size of dim ``name`` (1 for a name the mesh lacks)."""
        if name not in self._dim_names:
            return 1
        return int(self._ids.shape[self._dim_names.index(name)])

    def device_mesh(self, device_type: Optional[str] = None):
        """The ``DeviceMesh`` over these ranks with these ``dim_names``
        (made once per device type; collective over the world).  Without a
        world, a world of one is made (``mesh.ensure_world``); a rank past
        the world raises."""
        from torch.distributed.device_mesh import DeviceMesh

        if device_type is None:
            device_type = "cuda" if dist.is_initialized() and \
                dist.get_backend() == "nccl" else "cpu"
        if device_type not in self._device_meshes:
            mesh_mod.ensure_world(device_type)
            world = dist.get_world_size()
            if int(self._ids.max()) >= world or int(self._ids.min()) < 0:
                raise ValueError(f"process mesh names ranks {self.processes}"
                                 f", the world has {world}")
            self._device_meshes[device_type] = DeviceMesh(
                device_type, torch.from_numpy(self._ids),
                mesh_dim_names=tuple(self._dim_names))
        return self._device_meshes[device_type]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._ids, other._ids)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._ids.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.topology}, "
                f"dim_names={self._dim_names})")


def get_default_process_mesh() -> Optional[ProcessMesh]:
    return _default_process_mesh


def _spec_from_attr(ndim: int, pm: ProcessMesh, dims_mapping=None,
                    shard_spec=None) -> tuple:
    """``dims_mapping[i] = k`` puts tensor dim i on mesh dim k (-1:
    replicated); ``shard_spec`` is the name-based form ``[dim_name |
    None, ...]``."""
    if shard_spec is not None:
        entries = list(shard_spec) + [None] * (ndim - len(shard_spec))
        for e in entries:
            if e is not None and e not in pm.dim_names:
                raise ValueError(f"unknown mesh dim {e!r}; has {pm.dim_names}")
        return tuple(entries)
    if dims_mapping is None:
        return (None,) * ndim
    entries = [None if m == -1 else pm.dim_names[m]
               for m in list(dims_mapping)[:ndim]]
    return tuple(entries + [None] * (ndim - len(entries)))


def _resolve(dist_attr, process_mesh, shard_spec, ndim):
    dist_attr = dist_attr or {}
    pm = (process_mesh or dist_attr.get("process_mesh")
          or _default_process_mesh)
    if pm is None:
        raise ValueError("no ProcessMesh: pass process_mesh= or create one")
    if not isinstance(pm, ProcessMesh):
        pm = ProcessMesh(pm)
    return pm, _spec_from_attr(ndim, pm, dist_attr.get("dims_mapping"),
                               shard_spec)


def _place(x: torch.Tensor, spec: tuple, dm):
    """``x`` as a ``DTensor`` placed by ``spec`` on ``dm``: a plain tensor
    is taken as the whole value on every rank; differentiable."""
    from torch.distributed.tensor import DTensor, Replicate

    placements = to_placements(spec, dm)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    return x.redistribute(dm, placements)


def shard_tensor(x: torch.Tensor, dist_attr: Optional[dict] = None, *,
                 process_mesh=None, shard_spec=None):
    """``x`` as a ``DTensor`` placed as ``dist_attr`` (``{"process_mesh":
    pm, "dims_mapping": [0, -1]}``) or ``shard_spec`` (``["x", None]``)
    says (reference: interface.py:34).  A leaf that requires a gradient (a
    parameter) comes back as a new ``nn.Parameter`` over its ``DTensor``,
    annotated with the spec, for the caller to put in its place; any other
    tensor is redistributed differentiably.  The first mesh used becomes
    the global mesh."""
    from torch.distributed.tensor import distribute_tensor

    pm, spec = _resolve(dist_attr, process_mesh, shard_spec, x.dim())
    dm = pm.device_mesh(x.device.type)
    if mesh_mod.get_global_mesh() is None:
        mesh_mod.set_global_mesh(dm)
    if x.is_leaf and x.requires_grad:
        out = nn.Parameter(distribute_tensor(x.detach(), dm,
                                             to_placements(spec, dm)))
        return set_param_spec(out, spec)
    return _place(x, spec, dm)


def shard_op(op_fn: Callable, dist_attr: Optional[dict] = None, *,
             process_mesh=None, out_shard_specs=None):
    """``op_fn`` whose tensor outputs are redistributed as
    ``out_shard_specs[i]`` (or ``dist_attr``'s ``dims_mapping``) says
    (reference: interface.py:73); an output with neither comes back as it
    is."""

    def _wrapped(*args, **kwargs):
        out = op_fn(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else [out]
        res = []
        for i, o in enumerate(outs):
            sspec = out_shard_specs[i] if out_shard_specs is not None \
                and i < len(out_shard_specs) else None
            da = dist_attr if dist_attr and "dims_mapping" in dist_attr \
                else None
            if not isinstance(o, torch.Tensor) or (sspec is None
                                                   and da is None):
                res.append(o)
                continue
            pm, spec = _resolve(da, process_mesh
                                or (dist_attr or {}).get("process_mesh"),
                                sspec, o.dim())
            res.append(_place(o, spec, pm.device_mesh(o.device.type)))
        if isinstance(out, tuple):
            return tuple(res)
        if isinstance(out, list):
            return res
        return res[0]

    return _wrapped


def _spec_dim(spec_like) -> Optional[str]:
    """The mesh dim an ``inputs_spec`` splits the batch over: its first
    entry (a name, or a ``shard_spec`` list)."""
    if spec_like is None:
        return None
    if isinstance(spec_like, dict):
        return None
    if isinstance(spec_like, str):
        return spec_like
    first = list(spec_like)[0] if len(spec_like) else None
    return first if isinstance(first, str) else None


class Engine:
    """Train, eval and predict runner of a model on the default process
    mesh (reference: engine.py:51 ``__init__``, :87 ``prepare``, :259
    ``fit``, :298 ``evaluate``, :340 ``predict``; see the module for how
    the mesh's dims are run)."""

    def __init__(self, model=None, inputs_spec=None, labels_spec=None,
                 cluster=None, strategy=None):
        self.model = model
        self.inputs_spec = inputs_spec
        self.labels_spec = labels_spec
        self.strategy = strategy
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self._eval_step = None
        self._pred_step = None
        self._data = None          # (process group, rank, size) of the batch dim

    # -- setup ---------------------------------------------------------------

    def prepare(self, optimizer=None, loss=None, gradient_scale=True,
                metrics=None, all_ranks=False):
        from ...optimizer import Optimizer

        if optimizer is not None and not isinstance(optimizer, Optimizer):
            raise TypeError("'optimizer' must be a paddle Optimizer")
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("'loss' must be callable")
        self._loss = loss
        self._metrics = list(metrics or [])
        self._plan()
        self._build_steps()
        return self

    def _device(self):
        p = next(self.model.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _plan(self) -> None:
        """Split the batch and the model over the default mesh's dims."""
        pm = _default_process_mesh
        if pm is None:
            return
        dm = pm.device_mesh(self._device().type)
        if mesh_mod.get_global_mesh() is None:
            mesh_mod.set_global_mesh(dm)
        if pm.dim_size("model") > 1:
            self._shard_model(dm["model"])
        data = _spec_dim(self.inputs_spec)
        if data is not None and pm.dim_size(data) > 1:
            self._data = (dm.get_group(data), dm.get_local_rank(data),
                          pm.dim_size(data))

    def _shard_model(self, model_mesh) -> None:
        """The rank's tensor-parallel shard of the model, and the optimizer
        moved onto its parameters (before any step made state)."""
        from ...models.convert import shard_model

        whole = self.model
        shard = shard_model(whole, model_mesh).train(whole.training)
        opt = self._optimizer
        if opt is not None:
            if opt.state:
                raise RuntimeError("Engine.prepare: the optimizer already "
                                   "holds state; prepare before any step")
            names = {id(p): n for n, p in whole.named_parameters()}
            new = dict(shard.named_parameters())
            for group in opt.param_groups:
                group["params"] = [new[names[id(p)]] for p in group["params"]]
            opt._names = {id(new[n]): opt._names.get(id(p), n)
                          for n, p in whole.named_parameters()
                          if id(p) in opt._names}
        self.model = shard

    def _local(self, t):
        """This rank's slice of a global batch over the batch dim."""
        if self._data is None or not isinstance(t, torch.Tensor):
            return t
        _, rank, size = self._data
        if t.shape[0] % size:
            raise ValueError(f"Engine: batch {t.shape[0]} does not split "
                             f"over {size} ranks")
        n = t.shape[0] // size
        return t.narrow(0, rank * n, n)

    def _mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss's mean over the batch dim's ranks."""
        if self._data is None:
            return loss
        pg, _, size = self._data
        out = loss.detach().clone()
        dist.all_reduce(out, group=pg)
        return out / size

    def _sync_grads(self) -> None:
        if self._data is not None:
            from ..parallel import average_gradients

            average_gradients(self.model.parameters(), self._data[0])

    def _build_steps(self):
        from ... import jit as jit_mod

        loss_fn, opt = self._loss, self._optimizer

        def _train(x, y):
            loss = loss_fn(self.model(self._local(x)), self._local(y))
            loss.backward()
            self._sync_grads()
            opt.step()
            opt.clear_grad()
            return self._mean(loss.detach())

        def _eval(x, y):
            return self._mean(loss_fn(self.model(self._local(x)),
                                      self._local(y)).detach())

        def _pred(x):
            out = self.model(self._local(x))
            if self._data is None:
                return out
            pg, _, size = self._data
            parts = [torch.empty_like(out) for _ in range(size)]
            dist.all_gather(parts, out.contiguous(), group=pg)
            return torch.cat(parts)

        if opt is not None and loss_fn is not None:
            self._train_step = jit_mod.to_static(_train)
        if loss_fn is not None:
            self._eval_step = jit_mod.to_static(_eval)
        self._pred_step = jit_mod.to_static(_pred)

    # -- iteration -----------------------------------------------------------

    def _batches(self, data, batch_size, shuffle=False):
        from ...io import DataLoader, Dataset

        dev = self._device()
        if isinstance(data, DataLoader):
            for b in data:
                yield [t.to(dev) if isinstance(t, torch.Tensor) else t
                       for t in (b if isinstance(b, (tuple, list))
                                 else [b])]
            return
        if isinstance(data, (tuple, list)) and len(data) == 2 and not \
                isinstance(data[0], (int, float)):
            xs, ys = data
            n = len(xs)
            for i in range(0, n - n % batch_size or n, batch_size):
                yield (torch.as_tensor(np.asarray(xs[i:i + batch_size]))
                       .to(dev),
                       torch.as_tensor(np.asarray(ys[i:i + batch_size]))
                       .to(dev))
            return
        if isinstance(data, Dataset):
            yield from self._batches(
                DataLoader(data, batch_size=batch_size, shuffle=shuffle),
                batch_size)
            return
        raise TypeError(f"unsupported data {type(data)}")

    def fit(self, train_data, batch_size: int = 1, epochs: int = 1,
            steps_per_epoch: Optional[int] = None, verbose: int = 0,
            collate_fn=None):
        """Train; returns the losses (floats, the mean over the batch
        dim's ranks: the global batch's loss)."""
        if self._train_step is None:
            raise RuntimeError("call prepare(optimizer=..., loss=...) first")
        history = []
        for ep in range(epochs):
            for step, batch in enumerate(self._batches(
                    train_data, batch_size, shuffle=False)):
                if steps_per_epoch is not None and step >= steps_per_epoch:
                    break
                x, y = batch if isinstance(batch, (tuple, list)) else (batch,
                                                                       None)
                history.append(float(self._train_step(x, y)))
                if verbose:
                    print(f"epoch {ep} step {step}: loss {history[-1]:.6f}")
        return history

    def evaluate(self, eval_data, batch_size: int = 1):
        if self._eval_step is None:
            raise RuntimeError("call prepare(loss=...) first")
        losses = [float(self._eval_step(x, y))
                  for x, y in self._batches(eval_data, batch_size)]
        return float(np.mean(losses)) if losses else 0.0

    def predict(self, test_data, batch_size: int = 1):
        outs = []
        for batch in self._batches(test_data, batch_size):
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            outs.append(self._pred_step(x))
        return outs

    # -- checkpoint ----------------------------------------------------------

    def save(self, path: str, training: bool = True, mode=None):
        """Save the model's state (this rank's shard under a model dim)
        and, when ``training``, the optimizer's."""
        from ...framework.io import save as fw_save

        state = {"model": self.model.state_dict()}
        if training and self._optimizer is not None:
            state["optimizer"] = self._optimizer.state_dict()
        fw_save(state, path)

    def load(self, path: str, strict: bool = True,
             load_optimizer: bool = True, mode=None):
        from ...framework.io import load as fw_load

        state = fw_load(path)
        self.model.load_state_dict(state["model"], strict=strict)
        if load_optimizer and self._optimizer is not None and \
                "optimizer" in state:
            self._optimizer.set_state_dict(state["optimizer"])

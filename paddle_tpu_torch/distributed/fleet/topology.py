"""The hybrid topology: axis math and one communication group per axis.

Port of ``paddle_tpu/distributed/fleet/topology.py``
(``CommunicateTopology`` :24, ``HybridCommunicateGroup`` :83,
``ParallelMode`` :199).  The five axes are ``[data, pipe, sharding, sep,
model]``, outermost first: global rank ``r`` has the coordinates of the
``r``-th point of their cartesian product, so the model axis's ranks are
adjacent.  Each process reads its own coordinates from its global rank.

Every axis's groups are made on every rank in one fixed order (axis by
axis, each axis's groups in :meth:`CommunicateTopology.get_comm_list`
order, then the data x sharding "check" groups, then a second group per
pipe line for gradients), because making a group is collective over the
world.  A group of one rank holds no process group (its collectives are
the identity).  The pipe axis keeps two groups per line: activations move
on one and their gradients on the other, so a backend that matches
point-to-point messages by order alone (NCCL) never pairs an activation
with a gradient.
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from .. import mesh as mesh_mod
from ..collective import Group, new_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelMode",
           "set_hybrid_communicate_group", "get_hybrid_communicate_group"]

HYBRID_AXES = ("data", "pipe", "sharding", "sep", "model")


class CommunicateTopology:
    """Coordinate math over named axes (no communication)."""

    def __init__(self, hybrid_group_names: Sequence[str] = HYBRID_AXES,
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = collections.namedtuple("Coordinate",
                                                 self._parallel_names)
        self._world_size = 1
        for d in self._dims:
            self._world_size *= d
        coords = [self.coordinate(*c) for c in
                  itertools.product(*[range(d) for d in self._dims])]
        self._coord2rank = dict(zip(coords, range(self._world_size)))
        self._rank2coord = {r: c for c, r in self._coord2rank.items()}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **kwargs) -> int:
        assert len(kwargs) == len(self._parallel_names)
        return self._coord2rank[self.coordinate(**kwargs)]

    def get_coord(self, rank: int):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """Every rank whose coordinate on ``axis_name`` is ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The rank lists that communicate along ``axis_name`` (that axis
        varies, the others are fixed)."""
        axis = self._parallel_names.index(axis_name)
        others = [range(d) for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for other in itertools.product(*others):
            ranks = []
            for v in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, v)
                ranks.append(self._coord2rank[self.coordinate(*coord)])
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = self.get_coord(global_rank)
        return self.get_rank(**coord._replace(**kwargs)._asdict())


class HybridCommunicateGroup:
    """This rank's view of the topology: its coordinates, and its group on
    each axis.  Collective to make (every rank makes it with the same
    topology).  ``global_rank`` defaults to this process's rank; the
    world must hold exactly the topology's ranks (a topology of one needs
    no world)."""

    def __init__(self, topology: CommunicateTopology,
                 global_rank: Optional[int] = None):
        self._topo = topology
        world = dist.get_world_size() if dist.is_initialized() else 1
        if topology.world_size() != world:
            raise ValueError(
                f"the hybrid degrees multiply to {topology.world_size()} "
                f"ranks, but the world has {world}")
        if global_rank is None:
            global_rank = dist.get_rank() if dist.is_initialized() else 0
        self.global_rank = int(global_rank)
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self._mp_degree = topology.get_dim("model")
        self._groups: Dict[str, Group] = {}
        for name in names:
            self._groups[name] = self._make(topology.get_comm_list(name))
        # data x sharding: the ranks that share this rank's other
        # coordinates (the batch axes, over which gradients are averaged)
        fixed = [n for n in names if n not in ("data", "sharding")]
        lines = collections.OrderedDict()
        for c, r in sorted(topology._coord2rank.items(), key=lambda x: x[1]):
            lines.setdefault(tuple(getattr(c, n) for n in fixed),
                             []).append(r)
        self._check_group = self._make(list(lines.values()))
        # the pipe line's second group, for gradients
        self._pipe_grad_group = self._groups["pipe"]
        if self._pp_degree > 1:
            mine = None
            for ranks in topology.get_comm_list("pipe"):
                pg = dist.new_group(ranks, timeout=mesh_mod.GROUP_TIMEOUT)
                if self.global_rank in ranks:
                    mine = Group(ranks, gid=-1, pg=pg)
            self._pipe_grad_group = mine

    def _make(self, rank_lists: List[List[int]]) -> Group:
        """One group per rank list, made on every rank in order; this
        rank's."""
        mine = None
        for ranks in rank_lists:
            g = new_group(ranks) if len(ranks) > 1 else \
                Group(ranks, gid=-1)
            if self.global_rank in ranks:
                mine = g
        return mine

    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_parallel_mode(self) -> str:
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1:
            return "DATA_PARALLEL" if self._dp_degree > 1 else "SINGLE"
        if self._sharding_degree > 1 and self._mp_degree == 1 and \
                self._pp_degree == 1:
            return "SHARDING_PARALLEL"
        if self._pp_degree > 1:
            return "PIPELINE_PARALLEL"
        return "TENSOR_PARALLEL"

    def _coord(self):
        return self._topo.get_coord(self.global_rank)

    # -- per-axis queries (Paddle's names) -----------------------------------

    def get_data_parallel_world_size(self): return self._dp_degree
    def get_data_parallel_rank(self): return self._coord().data
    def get_data_parallel_group(self): return self._groups["data"]
    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    def get_model_parallel_world_size(self): return self._mp_degree
    def get_model_parallel_rank(self): return self._coord().model
    def get_model_parallel_group(self): return self._groups["model"]
    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    def get_pipe_parallel_world_size(self): return self._pp_degree
    def get_stage_id(self): return self._coord().pipe
    def get_pipe_parallel_group(self): return self._groups["pipe"]
    def get_pipe_parallel_grad_group(self): return self._pipe_grad_group

    def get_sharding_parallel_world_size(self): return self._sharding_degree
    def get_sharding_parallel_rank(self): return self._coord().sharding
    def get_sharding_parallel_group(self): return self._groups["sharding"]
    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    def get_sep_parallel_world_size(self): return self._sep_degree
    def get_sep_parallel_rank(self): return self._coord().sep
    def get_sep_parallel_group(self): return self._groups["sep"]

    def get_check_parallel_group(self): return self._check_group

    def get_batch_rank(self) -> int:
        """This rank's position over the batch axes (data, then sharding):
        which slice of a global batch it holds."""
        c = self._coord()
        return c.data * self._sharding_degree + c.sharding

    def is_first_stage(self): return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_next_rank(self):
        return self._topo.get_rank_from_stage(
            self.global_rank, pipe=(self.get_stage_id() + 1)
            % self._pp_degree)

    def get_p2p_prev_rank(self):
        return self._topo.get_rank_from_stage(
            self.global_rank, pipe=(self.get_stage_id() - 1)
            % self._pp_degree)


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg


class ParallelMode:
    """Paddle's enum of hybrid modes."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3

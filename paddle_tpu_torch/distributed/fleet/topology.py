"""Hybrid-parallel topology (counterpart of
paddle_tpu/distributed/fleet/topology.py).

``CommunicateTopology`` is the reference's rank arithmetic over the
cartesian world ``["data", "pipe", "sharding", "sep", "model"]`` (with
"expert" where fleet inserts it), row-major in that order, so global rank
r is the reference's mesh position r. ``HybridCommunicateGroup`` builds,
for each axis, one torch ProcessGroup per rank list of
``get_comm_list(axis)``; every rank creates every group in the same order,
as Paddle's does, and keeps the one it belongs to. An axis of degree 1
gets a one-rank group with no ProcessGroup, whose collectives are local
copies.

Three groups span several axes (the ZeRO and expert-parallel gradient
sums, made after the axis groups, every rank making every one):
the *data world* (``data`` x ``sharding`` x ``expert``: every rank that
sees its own rows), the *expert replicas* (``data`` x ``sharding``: the
ranks that hold the same experts) and the *sharding complement*
(``data`` x ``expert``: the data world's ranks of this rank's sharding
coordinate). A group whose ranks differ on one axis only is that axis'
group.
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

from .. import env
from ..collective import Group, new_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]

_AXIS_ALIAS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
               "sep": "sep", "model": "mp", "expert": "ep"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = itertools.product(*(range(d) for d in dims))
        self._world = np.arange(int(np.prod(dims))).reshape(dims)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(self._world.size)

    def get_rank(self, **kwargs):
        coords = tuple(kwargs[name] for name in self._parallel_names)
        return int(self._world[coords])

    def get_coord(self, rank):
        coords = np.argwhere(self._world == rank)[0]
        C = collections.namedtuple("Coord", self._parallel_names)
        return C(*[int(c) for c in coords])

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return self._world[tuple(sl)].reshape(-1).tolist()

    def get_comm_list(self, axis_name):
        """All rank-groups along one axis (the per-axis comm groups)."""
        axis = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._world, axis, -1)
        return moved.reshape(-1, self._dims[axis]).tolist()

    def get_multi_axis_comm_list(self, axis_names):
        """All rank-groups whose ranks differ on ``axis_names`` only (the
        names absent from the topology are skipped)."""
        axes = [self._parallel_names.index(a) for a in axis_names
                if a in self._parallel_names]
        size = int(np.prod([self._dims[a] for a in axes]))
        moved = np.moveaxis(self._world, axes, list(
            range(len(self._dims) - len(axes), len(self._dims))))
        return moved.reshape(-1, size).tolist()

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)
        tf = coord._asdict()
        tf.update(kwargs)
        return self.get_rank(**tf)


class HybridCommunicateGroup:
    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        if topology.world_size() != env.get_world_size():
            raise ValueError(
                f"hybrid degrees {dict(zip(names, topology._dims))} must "
                f"multiply to the world size {env.get_world_size()}")
        self.global_rank = env.get_rank()
        self._coord = topology.get_coord(self.global_rank)
        self._groups = {}
        for name in names:
            self._groups[_AXIS_ALIAS[name]] = self._axis_group(name)
        self._dp_degree = topology.get_dim("data")
        self._mp_degree = topology.get_dim("model")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self._ep_degree = topology.get_dim("expert") \
            if "expert" in names else 1
        self._multi, made = {}, {}
        for key, axes in (("data_world", ("data", "sharding", "expert")),
                          ("expert_replica", ("data", "sharding")),
                          ("sharding_complement", ("data", "expert"))):
            self._multi[key] = self._multi_axis_group(key, axes, made)
        from ..collective import _world_group
        self._check_group = _world_group()

    def _multi_axis_group(self, key, axes, made):
        """This rank's group over ``axes``: a one-axis group's own when
        only one of them has a degree above 1, the group ``made`` holds
        for the same rank lists, else a new group per rank list (every
        rank makes every one, in comm-list order)."""
        names = self._topo.get_hybrid_group_names()
        live = [a for a in axes if a in names and self._topo.get_dim(a) > 1]
        if len(live) <= 1:
            return self._groups[_AXIS_ALIAS[live[0] if live else "data"]]
        lists = tuple(map(tuple, self._topo.get_multi_axis_comm_list(live)))
        if lists in made:
            return made[lists]
        mine = None
        for ranks in lists:
            g = new_group(ranks)
            g.name = f"{key}_group"
            g._explicit = False
            if self.global_rank in ranks:
                mine = g
        made[lists] = mine
        return mine

    def _axis_group(self, name):
        """This rank's group along ``name``; every rank makes every
        group of the axis, in comm-list order."""
        mine = None
        for ranks in self._topo.get_comm_list(name):
            if len(ranks) == 1:
                g = Group(ranks, None, name=f"{_AXIS_ALIAS[name]}_group") \
                    if self.global_rank in ranks else None
            else:
                g = new_group(ranks)
                g.name = f"{_AXIS_ALIAS[name]}_group"
                g._explicit = False          # a hybrid axis, not a subset
            if self.global_rank in ranks:
                mine = g
        return mine

    def get_axis_group(self, axis):
        """The group of a short axis name ("dp", "mp", "pp", "sharding",
        "sep", "ep")."""
        return self._groups.get(axis)

    # -- degrees -----------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_expert_parallel_world_size(self):
        return self._ep_degree

    # -- ranks: this rank's coordinate on each axis --------------------------
    def _axis_rank(self, name):
        return getattr(self._coord, name) \
            if name in self._topo.get_hybrid_group_names() else 0

    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_rank(self):
        return self._axis_rank("data")

    def get_model_parallel_rank(self):
        return self._axis_rank("model")

    def get_stage_id(self):
        return self._axis_rank("pipe")

    def get_sharding_parallel_rank(self):
        return self._axis_rank("sharding")

    def get_sep_parallel_rank(self):
        return self._axis_rank("sep")

    def get_expert_parallel_rank(self):
        return self._axis_rank("expert")

    # -- groups ------------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sep_parallel_group(self):
        return self._groups.get("sep") if self._sep_degree > 1 else None

    def get_expert_parallel_group(self):
        return self._groups.get("ep") if self._ep_degree > 1 else None

    def get_data_world_group(self):
        """Every rank that sees its own rows (dp x sharding x ep): the
        group dense gradients are averaged over."""
        return self._multi["data_world"]

    def get_expert_replica_group(self):
        """The ranks that hold this rank's experts (dp x sharding of one
        ep rank): the group expert gradients are summed over."""
        return self._multi["expert_replica"]

    def get_sharding_complement_group(self, expert=False):
        """The ranks of the data world (of the expert replicas when
        ``expert``) that share this rank's sharding coordinate: where a
        gradient reduce-scattered over the sharding group is summed
        further."""
        return self._groups["dp"] if expert \
            else self._multi["sharding_complement"]

    def get_check_parallel_group(self, sharding=False):
        return self._check_group

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    # -- pipe helpers ------------------------------------------------------
    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return (self._groups["pp"],)

    @property
    def topology(self):
        return self._topo

"""The rank axis every mock-up is written against.

The JAX package runs p ranks under ``vmap(axis_name=)`` or ``shard_map``
and reaches them through ``lax`` collectives on a named axis.  Eager
PyTorch has no named axes, so the port passes an explicit axis object.
``StackedAxis`` keeps all p ranks on one device: ranks are the LEADING
dimension of every tensor, so a per-rank ``[n, ...]`` operand is a
``[p, n, ...]`` tensor, and a collective is a reduction, broadcast or
index copy along that dimension.  On a GPU a ring hop is therefore a
device-memory copy, not a link transfer.

A ``StackedMesh`` stacks the ranks of several named axes the same way:
dim 0 holds one lane per mesh rank, in row-major order, and each name
is a ``StackedAxis`` view over those lanes.  The number of lanes and the
axis size are two things: ``axis.lanes`` is the length of dim 0,
``axis.size`` the group a collective runs over.

Per-rank integers (``index()``, ring source ranks, rooted masks) are
``[lanes]`` tensors on the axis device, so the same mock-up code runs
unchanged on a process axis.

``GroupAxis`` and ``GroupMesh`` are that process axis, the counterpart
of the JAX package's ``shard_map`` mode: one rank per process, the
collectives of ``torch.distributed`` over a process group (NCCL on the
card, gloo on the CPU).  Every tensor on a process axis is ``[1, ...]``,
this process's one lane (``lanes == 1``), and ``index()`` holds its
coordinate, so no mock-up changes.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  With no GPU the caller must ask for the CPU
    explicitly (``device="cpu"``); nothing falls back to it quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               "unavailable")
        if dev.index is None:       # the index tensors report theirs
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ring_perm(p: int, shift: int = 1) -> list[tuple[int, int]]:
    """Permutation sending rank i -> rank (i + shift) % p (a ring hop)."""
    return [(i, (i + shift) % p) for i in range(p)]


def shift_perm(p: int, shift: int) -> list[tuple[int, int]]:
    """Non-wrapping shift: rank i -> i + shift (ranks without a source
    receive zeros)."""
    if shift >= 0:
        return [(i, i + shift) for i in range(p - shift)]
    return [(i, i + shift) for i in range(-shift, p)]


def tree_rounds(p: int) -> int:
    """Number of rounds of a binomial tree over p ranks."""
    r = 0
    while (1 << r) < p:
        r += 1
    return r


def _keep(cache: dict, key, t: torch.Tensor) -> None:
    """Cache ``t`` unless it is a fake tensor (made while a program is
    captured on fake tensors, ``analysis.graph.capture``): a real run
    after the capture must not meet it."""
    if not is_fake(t):
        cache[key] = t


class StackedAxis:
    """One rank axis over lanes stacked along dim 0 of every tensor, on one
    device.

    ``StackedAxis(p, device)`` is the one-axis case: p lanes, lane r is
    rank r.  ``StackedMesh(shape, names, device).axis(name)`` is a view of
    one named axis of a mesh whose lanes are the mesh's ranks in row-major
    order (the outer name varies slowest, as nested ``vmap`` stacks them).
    Either way ``size`` is the axis extent (the group a collective runs
    over), ``lanes`` the length of dim 0, ``index()`` each lane's
    coordinate on this axis, and every collective runs within the groups of
    lanes that share all the other coordinates."""

    def __init__(self, p: int, device=None, *, name: str = ""):
        if p < 1:
            raise ValueError(f"axis size must be >= 1, got {p}")
        self._setup((int(p),), 0, name, resolve_device(device))

    @classmethod
    def _view(cls, shape: tuple[int, ...], dim: int, name: str,
              device: torch.device) -> "StackedAxis":
        ax = cls.__new__(cls)
        ax._setup(shape, dim, name, device)
        return ax

    def _setup(self, shape, dim, name, device) -> None:
        self.shape = tuple(shape)            # the mesh the lanes form
        self.dim = dim                       # this axis' place in it
        self.name = name
        self.p = self.shape[dim]
        self.lanes = math.prod(self.shape)
        self.stride = math.prod(self.shape[dim + 1:])
        self.device = device
        self._index: dict[torch.dtype, torch.Tensor] = {}
        self._lane: torch.Tensor | None = None
        self._perms: dict[tuple, tuple] = {}

    def __repr__(self) -> str:
        if len(self.shape) == 1:
            return f"StackedAxis(p={self.p}, device={self.device})"
        return (f"StackedAxis({self.name!r}, p={self.p}, mesh={self.shape}, "
                f"device={self.device})")

    @property
    def size(self) -> int:
        return self.p

    def index(self, dtype: torch.dtype = torch.int64) -> torch.Tensor:
        """Each lane's coordinate on this axis: a ``[lanes]`` tensor on the
        device (``0..p-1`` on a one-axis ``StackedAxis``)."""
        t = self._index.get(dtype)
        if t is None:
            t = ((torch.arange(self.lanes, device=self.device)
                  // self.stride) % self.p).to(dtype)
            _keep(self._index, dtype, t)
        return t

    def lane_index(self) -> torch.Tensor:
        """``0..lanes-1``: the dim-0 index of each lane (what a per-lane
        gather ``x[lane, i[lane]]`` indexes dim 0 with)."""
        if self._lane is None:
            self._lane = torch.arange(self.lanes, device=self.device)
        return self._lane

    def groups(self) -> torch.Tensor:
        """The lanes of each group: a ``[n_groups, p]`` long tensor on the
        device, row g the lanes of group g in axis order (contiguous rows
        of lanes on the innermost axis).  For kernels that run one ring
        over the p lanes of one group."""
        lanes = torch.arange(self.lanes, device=self.device)
        return lanes.view(self.shape).movedim(self.dim, -1).reshape(
            -1, self.p)

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.lanes:
            raise ValueError(f"leading dim {x.shape[0]} != lanes "
                             f"{self.lanes} of axis {self!r}")

    def _mesh_view(self, x: torch.Tensor) -> torch.Tensor:
        """``[lanes, ...]`` viewed as ``[*mesh shape, ...]``."""
        self._check(x)
        return x.reshape(self.shape + tuple(x.shape[1:]))

    def _lanes_of(self, y: torch.Tensor) -> torch.Tensor:
        return y.reshape((self.lanes,) + tuple(y.shape[len(self.shape):]))

    # -- collectives ---------------------------------------------------------
    def all_gather(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        """``[L, n, ...]`` -> ``[L, p*n, ...]`` (tiled) or ``[L, p, n, ...]``:
        every rank holds every rank of its group's block, in rank order."""
        m, k = len(self.shape), self.dim
        xv = self._mesh_view(x)
        rest = tuple(x.shape[1:])
        g = xv.movedim(k, m - 1).unsqueeze(k)
        out = g.expand(self.shape + (self.p,) + rest).contiguous()
        if tiled:
            return out.view((self.lanes, self.p * x.shape[1]) + rest[1:])
        return out.view((self.lanes, self.p) + rest)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group; every rank holds the sum."""
        xv = self._mesh_view(x)
        s = xv.sum(self.dim, keepdim=True, dtype=x.dtype)
        return self._lanes_of(s.expand(xv.shape).contiguous())

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over the group; every rank holds it (``lax.pmax``)."""
        xv = self._mesh_view(x)
        return self._lanes_of(
            xv.amax(self.dim, keepdim=True).expand(xv.shape).contiguous())

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``[L, p*n, ...]`` -> ``[L, n, ...]``: rank r holds block r of the
        sum over its group."""
        rows = x.shape[1]
        if rows % self.p:
            raise ValueError(f"rows {rows} not divisible by axis size {self.p}")
        m, k = len(self.shape), self.dim
        xv = self._mesh_view(x)
        s = xv.sum(k, dtype=x.dtype)
        s = s.reshape(s.shape[:m - 1] + (self.p, rows // self.p)
                      + tuple(x.shape[2:]))
        return self._lanes_of(s.movedim(m - 1, k))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[L, p*n, ...]`` -> ``[L, p*n, ...]``: rank r's block j is rank
        j's block r (within the group)."""
        rows = x.shape[1]
        if rows % self.p:
            raise ValueError(f"rows {rows} not divisible by axis size {self.p}")
        m = len(self.shape)
        rest = tuple(x.shape[2:])
        xv = self._mesh_view(x).reshape(self.shape + (self.p, rows // self.p)
                                        + rest)
        y = xv.transpose(self.dim, m).contiguous()
        return y.view((self.lanes, rows) + rest)

    def _perm(self, pairs) -> tuple:
        """Lane-level source/destination indices of a rank permutation."""
        key = tuple((int(s), int(d)) for s, d in pairs)
        hit = self._perms.get(key)
        if hit is None:
            src_of = [-1] * self.p
            for s, d in key:
                if not (0 <= s < self.p and 0 <= d < self.p):
                    raise ValueError(f"pair {(s, d)} outside axis {self.p}")
                if src_of[d] >= 0:
                    raise ValueError(f"rank {d} has two sources")
                src_of[d] = s
            dst = [lane for lane in range(self.lanes)
                   if src_of[(lane // self.stride) % self.p] >= 0]
            src = [lane + (src_of[c] - c) * self.stride for lane in dst
                   for c in [(lane // self.stride) % self.p]]
            src_t = torch.tensor(src, device=self.device, dtype=torch.long)
            if len(dst) == self.lanes:
                hit = (True, src_t, None)
            else:
                hit = (False, src_t,
                       torch.tensor(dst, device=self.device,
                                    dtype=torch.long))
            self._perms[key] = hit
        return hit

    def pshift(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """``ppermute`` over (src, dst) rank pairs within every group;
        partial permutations are legal and a rank with no source receives
        zeros."""
        self._check(x)
        full, src, dst = self._perm(pairs)
        if full:
            return x.index_select(0, src)
        out = torch.zeros_like(x)
        if src.numel():
            out.index_copy_(0, dst, x.index_select(0, src))
        return out


class StackedMesh:
    """A mesh of named axes whose ranks are stacked as lanes along dim 0
    of every tensor, on one device: the counterpart of the JAX package's
    host mesh (``launch/mesh.py``, ``Mesh(devices.reshape(shape),
    names)``).  Lane ``i*q + j`` of a ``(d, q)`` mesh is rank ``i`` on the
    first axis and rank ``j`` on the second.  ``axis(name)`` (or
    ``mesh[name]``) is the ``StackedAxis`` view of one name; a one-name
    mesh's axis behaves as ``StackedAxis(p)``."""

    def __init__(self, shape, names, device=None):
        self.shape = tuple(int(s) for s in shape)
        self.names = tuple(names)
        if len(self.shape) != len(self.names) or not self.shape:
            raise ValueError(f"mesh shape {self.shape} and names "
                             f"{self.names} differ in length")
        if min(self.shape) < 1 or len(set(self.names)) != len(self.names):
            raise ValueError(f"bad mesh {self.shape} {self.names}")
        self.device = resolve_device(device)
        self.lanes = math.prod(self.shape)
        self._axes = {n: StackedAxis._view(self.shape, k, n, self.device)
                      for k, n in enumerate(self.names)}

    def __repr__(self) -> str:
        return (f"StackedMesh({dict(zip(self.names, self.shape))}, "
                f"device={self.device})")

    def axis(self, name: str) -> StackedAxis:
        return self._axes[name]

    __getitem__ = axis


# ---------------------------------------------------------------------------
# the process axis: one rank per process, over torch.distributed
# ---------------------------------------------------------------------------

_NO_GRID = ("is not defined on a process-group axis (GroupAxis): its "
            "ranks are processes, one lane each, so there is no grid of "
            "lanes to index")


class GroupAxis:
    """One rank axis whose ranks are processes of a ``torch.distributed``
    process group: the counterpart of a ``shard_map`` mesh axis.

    ``GroupAxis(device)`` spans every process of the initialized world
    (``launch.mesh.init_world``); ``GroupMesh(shape, names)[name]`` is a
    view of one named axis of a mesh of processes.  The lane interface is
    ``StackedAxis``'s with one lane: every tensor is ``[1, ...]``,
    ``lanes == 1``, ``size`` the group's world, ``index()`` a 1-element
    tensor holding this process's coordinate (``rank`` as a Python int),
    ``lane_index()`` ``tensor([0])``.  ``groups()`` and ``stride`` are
    not defined.  ``calls`` counts the library collectives issued, one
    each, and the barriers under ``barrier``.

    The device follows the backend: NCCL runs on the card, gloo only on
    the CPU, and either must be asked for; nothing falls back, and a
    backend that lacks a collective raises."""

    lanes = 1

    def __init__(self, device=None, *, name: str = ""):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call launch.mesh."
                               "init_world first")
        world = dist.get_world_size()
        dev = _group_device(device)
        self._setup((world,), 0, name, dev, dist.group.WORLD,
                    list(range(world)), dist.get_rank(), dist.get_rank())

    @classmethod
    def _view(cls, shape, dim, name, device, group, ranks, coord,
              mesh_rank) -> "GroupAxis":
        ax = cls.__new__(cls)
        ax._setup(shape, dim, name, device, group, ranks, coord, mesh_rank)
        return ax

    def _setup(self, shape, dim, name, device, group, ranks, coord,
               mesh_rank) -> None:
        self.shape = tuple(shape)         # the mesh of processes
        self.dim = dim                    # this axis' place in it
        self.name = name
        self.p = self.shape[dim]
        self.device = device
        self.group = group
        self.ranks = list(ranks)          # global ranks in axis order
        self.rank = int(coord)            # this process's coordinate
        self.mesh_rank = int(mesh_rank)   # its lane in the mesh's layout
        self.calls: collections.Counter = collections.Counter()
        self._index: dict[torch.dtype, torch.Tensor] = {}
        self._lane = torch.zeros(1, dtype=torch.long, device=device)

    def __repr__(self) -> str:
        return (f"GroupAxis({self.name!r}, p={self.p}, rank={self.rank}, "
                f"mesh={self.shape}, backend="
                f"{dist.get_backend(self.group)}, device={self.device})")

    @property
    def size(self) -> int:
        return self.p

    @property
    def stride(self) -> int:
        raise NotImplementedError(f"stride {_NO_GRID}")

    def groups(self) -> torch.Tensor:
        raise NotImplementedError(f"groups() {_NO_GRID}")

    def index(self, dtype: torch.dtype = torch.int64) -> torch.Tensor:
        """This process's coordinate on the axis: a ``[1]`` tensor."""
        t = self._index.get(dtype)
        if t is None:
            t = torch.tensor([self.rank], dtype=dtype, device=self.device)
            _keep(self._index, dtype, t)
        return t

    def lane_index(self) -> torch.Tensor:
        return self._lane

    def barrier(self) -> None:
        """A 1-element all-reduce over the group, then wait for the card
        (counted under ``barrier``, apart from the collectives)."""
        self.calls["barrier"] += 1
        dist.all_reduce(torch.ones(1, device=self.device), group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _one(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != 1:
            raise ValueError(f"leading dim {x.shape[0]} != 1 lane of "
                             f"{self!r}")
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, {self!r}")
        return x.contiguous()

    def _blocks(self, x: torch.Tensor) -> int:
        rows = x.shape[1]
        if rows % self.p:
            raise ValueError(f"rows {rows} not divisible by axis size "
                             f"{self.p}")
        return rows // self.p

    # -- collectives (each one library call, counted) -----------------------
    def all_gather(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        """``[1, n, ...]`` -> ``[1, p*n, ...]`` (tiled) or ``[1, p, n,
        ...]``, in rank order."""
        x = self._one(x)
        rest = tuple(x.shape[1:])
        out = x.new_empty((self.p,) + rest)
        self.calls["all_gather"] += 1
        dist.all_gather_into_tensor(out, x, group=self.group)
        if tiled:
            return out.view((1, self.p * x.shape[1]) + rest[1:])
        return out.unsqueeze(0)

    def _all_reduce(self, x: torch.Tensor, op, name: str) -> torch.Tensor:
        y = self._one(x).clone()
        self.calls[name] += 1
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group; every rank holds the sum."""
        return self._all_reduce(x, dist.ReduceOp.SUM, "psum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over the group; every rank holds it."""
        return self._all_reduce(x, dist.ReduceOp.MAX, "pmax")

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, p*n, ...]`` -> ``[1, n, ...]``: block ``rank`` of the sum
        over the group."""
        n = self._blocks(x)
        x = self._one(x)
        out = x.new_empty((1, n) + tuple(x.shape[2:]))
        self.calls["psum_scatter"] += 1
        dist.reduce_scatter_tensor(out[0], x[0], group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, p*n, ...]`` -> ``[1, p*n, ...]``: block j is rank j's
        block ``rank``."""
        self._blocks(x)
        x = self._one(x)
        out = torch.empty_like(x)
        self.calls["all_to_all"] += 1
        dist.all_to_all_single(out[0], x[0], group=self.group)
        return out

    def pshift(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """``ppermute`` over (src, dst) coordinate pairs: one batch of
        point-to-point sends and receives (global ranks); partial
        permutations are legal and a rank with no source receives zeros;
        a pair from a rank to itself is a local copy."""
        x = self._one(x)
        src, dsts = None, []
        for s, d in pairs:
            s, d = int(s), int(d)
            if not (0 <= s < self.p and 0 <= d < self.p):
                raise ValueError(f"pair {(s, d)} outside axis {self.p}")
            if d == self.rank:
                if src is not None:
                    raise ValueError(f"rank {d} has two sources")
                src = s
            if s == self.rank:
                dsts.append(d)
        out = torch.zeros_like(x) if src is None else torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self.ranks[d], self.group)
               for d in dsts if d != self.rank]
        if src == self.rank:
            out.copy_(x)
        elif src is not None:
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[src],
                                  self.group))
        if ops:
            self.calls["pshift"] += 1
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


def _group_device(device) -> torch.device:
    """The device of a process axis: it must be the backend's (NCCL the
    card, gloo the CPU).  The fake backend (``launch.mesh.init_fake_world``)
    moves no data: its tensors are fake, and the device (default the
    CPU) only labels them, so a ``cuda`` label needs no card."""
    backend = dist.get_backend()
    if backend == "fake":
        dev = torch.device("cpu" if device is None else device)
        return torch.device(dev.type, 0) if (
            dev.type == "cuda" and dev.index is None) else dev
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL runs on the card, not on {dev}")
    if backend == "gloo" and dev.type != "cpu":
        raise ValueError(f"gloo runs here only on the CPU: pass "
                         f"device='cpu', not {dev}")
    return dev


class GroupMesh:
    """A mesh of named axes over every process of the world: the
    counterpart of the JAX package's ``make_host_mesh(shape, names)``
    under ``shard_map``.  Rank r's coordinates are ``r`` unravelled in
    row-major order over ``shape`` (the order ``StackedMesh`` gives its
    lanes), so rank r holds lane r of the mesh's stacked layout
    (``mesh_rank``).  ``mesh[name]`` is a ``GroupAxis`` over the ranks
    that share every other coordinate; every rank builds every group, in
    the same order (``dist.new_group``)."""

    lanes = 1

    def __init__(self, shape, names, device=None):
        self.shape = tuple(int(s) for s in shape)
        self.names = tuple(names)
        if len(self.shape) != len(self.names) or not self.shape:
            raise ValueError(f"mesh shape {self.shape} and names "
                             f"{self.names} differ in length")
        if min(self.shape) < 1 or len(set(self.names)) != len(self.names):
            raise ValueError(f"bad mesh {self.shape} {self.names}")
        if not dist.is_initialized():
            raise RuntimeError("no process group: call launch.mesh."
                               "init_world first")
        world = dist.get_world_size()
        if math.prod(self.shape) != world:
            raise ValueError(f"mesh {self.shape} needs "
                             f"{math.prod(self.shape)} processes, the "
                             f"world has {world}")
        self.device = _group_device(device)
        self.rank = dist.get_rank()
        coords = np.unravel_index(self.rank, self.shape)
        grid = np.arange(world).reshape(self.shape)
        self._axes = {}
        for k, name in enumerate(self.names):
            rows = np.moveaxis(grid, k, -1).reshape(-1, self.shape[k])
            mine = None
            for row in rows:
                g = dist.new_group([int(r) for r in row])
                if self.rank in row:
                    mine = (g, [int(r) for r in row])
            self._axes[name] = GroupAxis._view(
                self.shape, k, name, self.device, mine[0], mine[1],
                coords[k], self.rank)

    def __repr__(self) -> str:
        return (f"GroupMesh({dict(zip(self.names, self.shape))}, "
                f"rank={self.rank}, device={self.device})")

    @property
    def mesh_rank(self) -> int:
        return self.rank

    def axis(self, name: str) -> GroupAxis:
        return self._axes[name]

    __getitem__ = axis

    def barrier(self) -> None:
        """A 1-element all-reduce over every process, then wait for the
        card."""
        ones = torch.ones(1, device=self.device)
        dist.all_reduce(ones)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def is_mesh(axis) -> bool:
    """A mesh of named axes (stacked or of processes), as opposed to one
    axis."""
    return isinstance(axis, (StackedMesh, GroupMesh))


def spans_processes(axis) -> bool:
    """A process axis or mesh: ranks are processes, one lane each."""
    return isinstance(axis, (GroupAxis, GroupMesh))


# ---------------------------------------------------------------------------
# carrying per-rank operands between numpy and the stacked layout
# ---------------------------------------------------------------------------


def stack_shards(shards, device=None, dtype: torch.dtype | None = None
                 ) -> torch.Tensor:
    """Stack per-rank numpy arrays into one ``[p, ...]`` tensor.

    numpy has no bfloat16 of its own; arrays of the ``ml_dtypes`` bfloat16
    type (what the JAX package hands out) are carried bit for bit."""
    arr = np.stack([np.asarray(s) for s in shards])
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def unstack(t: torch.Tensor) -> list[np.ndarray]:
    """``[p, ...]`` tensor -> list of per-rank numpy arrays (bfloat16 comes
    back as float32, which holds every bfloat16 value exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return list(t.numpy())

"""The device mesh, partition-spec templates and their resolution; port of
``repro/launch/mesh.py``, with the collectives that XLA's partitioner
inserts there.

* ``P``: a partition spec, the semantics of ``jax.sharding.PartitionSpec``:
  one entry a dimension, each an axis name, a tuple of names (the
  dimension split over those mesh axes, left to right: the first axis
  major) or ``None`` (not split).  A one-name tuple is that name, an empty
  one ``None``, as in JAX.
* ``AbstractMesh(shape, axes)``: axis names and sizes and nothing else,
  for the spec functions (the counterpart of ``jax.sharding.AbstractMesh``).
* ``make_mesh(shape, axes, device_type)``: a ``Mesh`` over
  ``torch.distributed.device_mesh.init_device_mesh``, one process a
  device, the default process group already started (``launch.dist``).
  Rank ``r`` sits at the row-major coordinate of ``r`` in ``shape``.
  ``make_production_mesh`` gives the reference's ``(16, 16)`` ``("data",
  "model")`` and ``(2, 16, 16)`` ``("pod", "data", "model")`` meshes.
* ``batch_axes_of``, ``resolve_spec(s)``, ``sanitize_spec`` and ``to_dp``
  (the ``pure_dp`` layout's templates): the reference's, result for
  result.
* ``local_slices``, ``shard`` and ``unshard``: a rank's part of a leaf
  under a sanitized spec, by index arithmetic, and the whole leaf back.
* The collectives, each over the process group of a tuple of mesh axes and
  each a no-op where those axes have size 1 (so a mesh of one device runs
  the unsharded computation op for op): ``all_gather`` (backward: a
  reduce-scatter), ``gather_split`` (backward: this rank's chunk),
  ``reduce_scatter`` (backward: an all-gather),
  ``reduce_grad`` (identity forward, all-reduce backward: the entry into
  a tensor-parallel region), ``reduce`` (all-reduce forward, identity
  backward: its exit) and ``psum`` (an all-reduce outside autograd).
  Every sum over ranks adds the ranks' values in rank order, the same
  order on every rank, so the result is the same bits everywhere and from
  run to run: the all-reduce is an all-gather then an ordered sum, the
  reduce-scatter an all-to-all then an ordered sum.  ``exchange`` is an
  all-to-all of uneven parts (backward: the reverse one).  ``gather_list`` gives
  the ranks' tensors in rank order outside autograd (the distributed
  flash-decode's partials).
* ``CollectiveCounter``: inside its ``with`` block, every all-gather and
  all-to-all of this module is counted by kind, with the bytes this rank
  receives from the others (what the rank-ordered collectives move: ``(n -
  1)`` shards for an all-gather over ``n`` ranks, ``(n - 1) / n`` of the
  buffer for an all-to-all); the dry-run's collective census.
"""
from __future__ import annotations

import itertools
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Entry = Optional[object]          # None | str | Tuple[str, ...]


def _entry(e) -> Entry:
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    if not e:
        return None
    return e[0] if len(e) == 1 else e


class P(tuple):
    """A partition spec: ``P("data", "model", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def entry_axes(e: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def drop_axes(spec: P, axes: Sequence[str]) -> P:
    """``spec`` with every entry's ``axes`` removed."""
    return P(*(tuple(a for a in entry_axes(e) if a not in axes)
               for e in spec))


class AbstractMesh:
    """Axis names and sizes only."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, map(int, shape)))
        # caches of objects derived from the mesh (models.parallel)
        self.cache: Dict = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({dict(self.shape)})"


class Mesh(AbstractMesh):
    """A mesh of processes: this rank's coordinate, and a process group for
    every set of axes each larger than 1."""

    def __init__(self, device_mesh):
        super().__init__(device_mesh.mesh.shape,
                         device_mesh.mesh_dim_names)
        self.device_mesh = device_mesh
        self.coords = dict(zip(self.axis_names,
                               device_mesh.get_coordinate()))
        ranks = device_mesh.mesh
        self._groups: Dict[Tuple[str, ...], object] = {}
        # every rank makes the same groups in the same order
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                if any(self.shape[a] == 1 for a in axes):
                    continue
                dims = [self.axis_names.index(a) for a in axes]
                rest = [d for d in range(ranks.dim()) if d not in dims]
                r = ranks.permute(*rest, *dims).reshape(
                    -1, self.axis_size(axes))
                self._groups[axes] = dist.new_subgroups_by_enumeration(
                    r.tolist())[0]

    def _axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        return tuple(a for a in axes if self.shape[a] > 1)

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (in mesh order), or ``None``
        where their size is 1."""
        axes = self._axes(axes)
        return self._groups[axes] if axes else None

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes``, its rank in their
        group."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinate of global rank ``rank``."""
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> Mesh:
    """A ``Mesh`` of ``shape`` over the started default process group,
    whose world size must be ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                           f"processes; the process group has {world}")
    return Mesh(init_device_mesh(device_type, tuple(shape),
                                 mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """16 x 16 = 256 devices a pod; 2 pods = 512 multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


# ---------------------------------------------------------------------------
# spec resolution (the reference's functions)
# ---------------------------------------------------------------------------


def batch_axes_of(mesh, cfg=None) -> Tuple[str, ...]:
    """The axes the batch is split over: ``"data"``, or ``"data"`` and
    ``"model"`` under ``cfg.pure_dp``; on two pods ``"pod"`` before them.
    Without a mesh, the templates' axes."""
    axes = ("data", "model") if (cfg is not None and cfg.pure_dp) \
        else ("data",)
    if mesh is not None and "pod" in mesh.axis_names:
        return ("pod",) + axes
    return axes


def to_dp(spec: P) -> P:
    """The ``pure_dp`` layout of a leaf's template (the reference's
    ``cell_structs``): its first ``"data"`` entry over ``("data",
    "model")``, every other ``"data"`` or ``"model"`` entry dropped."""
    out, seen = [], False
    for e in spec:
        if e == "data" and not seen:
            out.append(("data", "model"))
            seen = True
        elif e in ("data", "model"):
            out.append(None)
        else:
            out.append(e)
    return P(*out)


def resolve_spec(spec: P, mesh) -> P:
    """Map template axes onto the concrete mesh: on multi-pod meshes every
    'data' entry becomes ('pod', 'data') — FSDP/batch span both axes."""
    if "pod" not in mesh.axis_names:
        return spec
    out = []
    for e in spec:
        ee = []
        for x in entry_axes(e):
            ee.extend(("pod", "data") if x == "data" else (x,))
        out.append(e if e is None else tuple(ee))
    return P(*out)


def resolve_specs(tree, mesh):
    """``resolve_spec`` over a dict (nested or flat), list or tuple of
    specs."""
    if isinstance(tree, P):
        return resolve_spec(tree, mesh)
    if isinstance(tree, dict):
        return {k: resolve_specs(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(resolve_specs(v, mesh) for v in tree)
    return tree


def sanitize_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop the entries whose axes do not divide their dimension evenly
    (vocab 49155 over 16, batch 1 over 'data', 28 heads over 16)."""
    spec = resolve_spec(spec, mesh)
    out = []
    for i, e in enumerate(spec):
        if e is None or i >= len(shape):
            out.append(e)
            continue
        p = math.prod(mesh.shape[a] for a in entry_axes(e))
        out.append(e if shape[i] % p == 0 else None)
    return P(*out)


# ---------------------------------------------------------------------------
# a rank's part of a leaf
# ---------------------------------------------------------------------------


def _index(e: Entry, coords: Dict[str, int], mesh) -> Tuple[int, int]:
    """(this rank's chunk, the number of chunks) of a dimension under
    entry ``e``: row-major over its axes, the first axis major."""
    i, n = 0, 1
    for a in entry_axes(e):
        i = i * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return i, n


def local_slices(spec: P, shape: Sequence[int], mesh,
                 coords: Optional[Dict[str, int]] = None
                 ) -> Tuple[slice, ...]:
    """The slices of a leaf of ``shape`` held at ``coords`` (this rank's
    by default) under the sanitized ``spec``."""
    coords = mesh.coords if coords is None else coords
    out = []
    for d, size in enumerate(shape):
        i, n = _index(spec[d] if d < len(spec) else None, coords, mesh)
        if size % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {n} (spec {spec})")
        c = size // n
        out.append(slice(i * c, (i + 1) * c))
    return tuple(out)


def shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's part of the whole leaf ``x``: ``x`` itself where the
    spec splits nothing, else a contiguous copy of the slice."""
    sl = local_slices(spec, x.shape, mesh)
    if all(s.stop - s.start == n for s, n in zip(sl, x.shape)):
        return x
    return x[sl].clone(memory_format=torch.contiguous_format)


def global_shape(local: Sequence[int], spec: P, mesh) -> Tuple[int, ...]:
    return tuple(n * mesh.axis_size(entry_axes(spec[d]) if d < len(spec)
                                    else ())
                 for d, n in enumerate(local))


def unshard(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from every rank's part (an all-gather over the axes
    the spec splits over)."""
    axes = tuple(a for a in mesh.axis_names
                 if any(a in entry_axes(e) for e in spec))
    group = mesh.group(axes)
    if group is None:
        return local
    parts = _all_gather(local, group)
    whole = local.new_empty(global_shape(local.shape, spec, mesh))
    for i, part in enumerate(parts):
        coords = dict(mesh.coords)
        for a in reversed(mesh._axes(axes)):
            i, coords[a] = divmod(i, mesh.shape[a])
        whole[local_slices(spec, whole.shape, mesh, coords)] = part
    return whole


# ---------------------------------------------------------------------------
# collectives, rank-ordered
# ---------------------------------------------------------------------------


class CollectiveCounter:
    """``by_kind``: ``{kind: {"count": n, "bytes": b}}`` of the collectives
    run inside the ``with`` block, ``b`` the bytes this rank receives from
    the others; ``events``: each collective's bytes from ranks of this
    rank's node (``intra``) and from other nodes (``inter``), ranks filling
    nodes of ``node`` in order."""

    active: List["CollectiveCounter"] = []

    def __init__(self, node: int = 8):
        self.node = node
        self.by_kind: Dict[str, Dict[str, int]] = {}
        self.events: List[Dict[str, int]] = []

    def add(self, kind: str, sizes: Sequence[int], ranks: Sequence[int],
            me: int) -> None:
        """``sizes[i]``: the bytes received from group rank ``i`` (global
        rank ``ranks[i]``)."""
        node = me // self.node
        intra = sum(b for b, r in zip(sizes, ranks)
                    if r != me and r // self.node == node)
        inter = sum(b for b, r in zip(sizes, ranks) if r // self.node != node)
        rec = self.by_kind.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += intra + inter
        self.events.append({"kind": kind, "intra": intra, "inter": inter})

    def __enter__(self) -> "CollectiveCounter":
        CollectiveCounter.active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        CollectiveCounter.active.remove(self)


_GROUP_RANKS: Dict[object, List[int]] = {}


def _count(kind: str, per_peer, group) -> None:
    """Count one collective: ``per_peer`` bytes from each rank of
    ``group``, or a list of them by group rank."""
    if not CollectiveCounter.active:
        return
    if group not in _GROUP_RANKS:
        _GROUP_RANKS[group] = dist.get_process_group_ranks(group)
    ranks = _GROUP_RANKS[group]
    sizes = per_peer if isinstance(per_peer, list) \
        else [int(per_peer)] * len(ranks)
    for c in CollectiveCounter.active:
        c.add(kind, sizes, ranks, dist.get_rank())


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    x = x.contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    _count("all_gather", x.numel() * x.element_size(), group)
    return parts


def _ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _ordered_sum(_all_gather(x, group))


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group's ranks of ``x``'s chunk ``i`` along
    ``dim``, at the rank of index ``i``: an all-to-all of the chunks, then
    their ordered sum."""
    n = dist.get_world_size(group)
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    send = torch.cat([c.reshape(-1) for c in chunks])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _count("all_to_all", send.numel() * send.element_size() // n, group)
    return _ordered_sum(list(recv.chunk(n))).reshape(chunks[0].shape)


def _exchange(x: torch.Tensor, send: List[int], recv: List[int],
              group) -> torch.Tensor:
    """An all-to-all of uneven parts along dim 0: ``send[i]`` rows of
    ``x`` (in order) to group rank ``i``, ``recv[i]`` rows from it."""
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, recv, send, group=group)
    row = x[:1].numel() * x.element_size()
    _count("all_to_all", [n * row for n in recv], group)
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _exchange(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.recv, ctx.send, ctx.group), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.group), dim=ctx.dim), None, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.n, ctx.index = dim, dist.get_world_size(group), index
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.index].contiguous(), None, None, \
            None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, dim: int, axes: Sequence[str], mesh
               ) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim``; the backward pass sums
    the cotangent over the ranks and keeps this rank's chunk (a
    reduce-scatter)."""
    group = mesh.group(axes)
    return x if group is None else _Gather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, axes: Sequence[str], mesh
                   ) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's chunk of it along
    ``dim``; the backward pass concatenates the ranks' cotangents (an
    all-gather)."""
    group = mesh.group(axes)
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def gather_split(x: torch.Tensor, dim: int, axes: Sequence[str], mesh
                 ) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` for a consumer that every
    rank computes alike; the backward pass keeps this rank's chunk."""
    group = mesh.group(axes)
    if group is None:
        return x
    return _GatherSplit.apply(x, dim, group, mesh.index(mesh._axes(axes)))


def exchange(x: torch.Tensor, send: List[int], recv: List[int],
             axes: Sequence[str], mesh) -> torch.Tensor:
    """An all-to-all of uneven parts along dim 0 over ``axes``: ``send[i]``
    rows of ``x`` to the group's rank ``i``, ``recv[i]`` rows from it, the
    received rows in rank order; the backward pass sends the cotangent's
    rows back the same way."""
    group = mesh.group(axes)
    return x if group is None else _Exchange.apply(x, send, recv, group)


def reduce_grad(x: torch.Tensor, axes: Sequence[str], mesh) -> torch.Tensor:
    """Identity forward; the backward pass sums the cotangent over the
    ranks of ``axes``."""
    group = mesh.group(axes)
    return x if group is None else _ReduceGrad.apply(x, group)


def reduce(x: torch.Tensor, axes: Sequence[str], mesh) -> torch.Tensor:
    """The sum over the ranks of ``axes``; identity backward."""
    group = mesh.group(axes)
    return x if group is None else _Reduce.apply(x, group)


def psum(x: torch.Tensor, axes: Sequence[str], mesh) -> torch.Tensor:
    """The sum over the ranks of ``axes``, outside autograd."""
    group = mesh.group(axes)
    return x if group is None else _all_reduce(x.detach(), group)


def gather_list(x: torch.Tensor, axes: Sequence[str], mesh
                ) -> List[torch.Tensor]:
    """The ranks' ``x`` over ``axes``, in rank order (outside autograd);
    ``[x]`` where those axes have size 1."""
    group = mesh.group(axes)
    return [x] if group is None else _all_gather(x.detach(), group)


def all_gather_ranks(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every rank's ``x``, by global rank (outside autograd)."""
    return gather_list(x, mesh.axis_names, mesh)

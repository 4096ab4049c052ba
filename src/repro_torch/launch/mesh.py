"""Meshes, partition specs and the explicit collectives of the mesh paths.

Counterpart of ``repro/launch/mesh.py``, plus what the reference takes
from jax itself: ``PartitionSpec``, the abstract mesh, the ambient mesh of
``jax.set_mesh`` / ``compat.get_abstract_mesh`` and ``shard_map``.

FUNCTIONS, not module-level constants: importing this module touches no
device and starts no process group.

* ``Mesh`` -- axis names and sizes, as ``jax.sharding.AbstractMesh``;
  ``mesh.shape[name]`` is an axis size (``axis_size`` takes a
  ``DeviceMesh`` too).  A mesh made by ``make_host_mesh`` or
  ``make_production_mesh`` also holds a ``DeviceMesh`` over a process
  group and runs collectives; an abstract one (``Mesh(sizes, names)``)
  serves ``launch.cells.build_cell`` and the spec functions.
* ``make_production_mesh(multi_pod)`` -- (data=16, model=16), or (pod=2,
  data=16, model=16), over a "fake" process group of 256 or 512 ranks in
  which this process is rank 0: the dry run's mesh (collectives there move
  nothing).
* ``make_host_mesh(data, model)`` -- over the ranks that exist: the
  default group, which the caller starts (``gloo`` on the CPU, NCCL on
  cards); the shape clamped as the reference clamps it.
* ``PartitionSpec`` -- a tuple of entries, each ``None``, an axis name or
  a tuple of names, normalised and printed as jax's.
* ``set_mesh(mesh)`` / ``get_abstract_mesh()`` -- the ambient mesh that
  ``models.transformer`` and ``models.gnn`` read.
* ``shard_map(fn, mesh, in_specs, out_specs)`` -- ``fn`` runs on each
  rank's local blocks.  Plain tensors are global and the same on every
  rank: each rank cuts its block by its shard index, and a sharded result
  is gathered so that every rank gets the same global tensor.  DTensors
  (the dry run) are redistributed to the spec's placements and their
  local tensors taken; results are DTensors again.  Inside ``fn`` the
  collectives below run over the mesh's groups.

The shard index of a multi-axis entry is row-major over the entry's axes
in the ENTRY's order (jax's rule): on a (data=4, model=2) mesh, shard s of
``("model", "data")`` is held by the rank at data = s % 4, model = s // 4
(global rank (s % 4) * 2 + s // 4).  A process group numbers its ranks in
global order, so each collective maps shard order to group order itself.

The gradients are those of the global function, as every rank computes
the same loss from the same global tensors: a ``psum``'s backward passes
its cotangent through, an ``all_gather``'s sums it back (a
reduce-scatter), an ``all_to_all``'s sends it back, and an input the
spec replicates sums its ranks' cotangents (``all_reduce``).
"""

from __future__ import annotations

import contextlib
import itertools
import math

import numpy as np
import torch

# Roofline constants: one NVIDIA H100 80GB HBM3 (SXM, 700 W power limit),
# from its datasheet.
PEAK_FLOPS_BF16 = 989.4e12  # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12  # bytes/s of HBM3
ICI_BW = 450.0e9  # bytes/s of NVLink, each direction


# ==========================================================================
# PartitionSpec and meshes
# ==========================================================================

def _entry(e):
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    if not e:
        return None
    return e[0] if len(e) == 1 else e


class PartitionSpec(tuple):
    """jax's ``PartitionSpec``: one entry a dimension (``None``, an axis
    name, or a tuple of names, a 1-tuple kept as its name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))

    __str__ = __repr__


P = PartitionSpec


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry, in its order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """Axis names and sizes; with ``device_mesh`` also a process group of
    the mesh's ranks (row-major over the axes)."""

    def __init__(self, axis_sizes, axis_names, device_mesh=None):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{axis_sizes} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, map(int, axis_sizes)))
        self.device_mesh = device_mesh
        # the global ranks [sizes...], read once (no tensor op later: the
        # dry run traces under a fake mode)
        self._ranks = (None if device_mesh is None
                       else np.asarray(device_mesh.mesh.tolist(), dtype=np.int64))
        self._groups: dict = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        kind = "" if self.device_mesh is None else f", {self.device_mesh.device_type}"
        return f"Mesh({sizes}{kind})"

    # -- this rank's place ---------------------------------------------
    def _need_group(self):
        if self.device_mesh is None:
            raise ValueError(f"{self!r} is abstract: the mesh paths run on a "
                             "mesh with a process group (make_host_mesh)")

    def coordinate(self) -> dict:
        """This rank's index on each axis."""
        self._need_group()
        coord = self.device_mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        return dict(zip(self.axis_names, coord))

    def shard_index(self, axes) -> int:
        """This rank's shard of an entry over ``axes`` (row-major in the
        entry's order)."""
        coord = self.coordinate()
        s = 0
        for a in axes:
            s = s * self.shape[a] + coord[a]
        return s

    def group(self, axes):
        """-> (process group of this rank's coset over ``axes``, ``order``):
        ``order[s]`` is the group rank that holds shard ``s`` of ``axes``.
        Every coset's group is made at the first call for these axes, on
        every rank alike (``new_group`` is collective)."""
        self._need_group()
        import torch.distributed as dist

        axes = tuple(axes)
        key = tuple(sorted(axes, key=self.axis_names.index))
        ranks = self._ranks
        if key not in self._groups:
            dims = [self.axis_names.index(a) for a in key]
            rest = [i for i in range(len(self.axis_names)) if i not in dims]
            made = {}
            for fixed in itertools.product(*(range(ranks.shape[i]) for i in rest)):
                idx = [slice(None)] * ranks.ndim
                for i, v in zip(rest, fixed):
                    idx[i] = v
                members = sorted(int(r) for r in ranks[tuple(idx)].reshape(-1))
                made[tuple(members)] = dist.new_group(members)
            self._groups[key] = made
        me = self.coordinate()
        members = []
        # the coset's ranks in shard order of ``axes``
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(me)
            c.update(zip(axes, idx))
            members.append(int(ranks[tuple(c[a] for a in self.axis_names)]))
        sorted_members = sorted(members)
        order = [sorted_members.index(r) for r in members]
        return self._groups[key][tuple(sorted_members)], order


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of a ``Mesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape[name]
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_names(mesh) -> tuple:
    if mesh is None:
        return ()
    if isinstance(mesh, Mesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def _device_type() -> str:
    import torch.distributed as dist

    backend = dist.get_backend()
    return "cuda" if backend == "nccl" else "cpu"


def _fake_group(world: int) -> None:
    """This process as rank 0 of a fake group of ``world`` ranks (torch's
    testing backend: collectives return at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(data=16, model=16) = 256 ranks, or (pod=2, data=16, model=16) =
    512, over a fake process group (replacing the default group)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_group(math.prod(shape))
    dm = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    return Mesh(shape, axes, dm)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the default process group's ranks, the
    shape clamped to them as the reference clamps it to its devices."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs the default process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    dm = DeviceMesh(_device_type(), torch.arange(data * model).reshape(data, model),
                    mesh_dim_names=("data", "model"))
    return Mesh((data, model), ("data", "model"), dm)


def data_axes(mesh) -> tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def data_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def tp_size(mesh) -> int:
    return axis_size(mesh, "model") if "model" in axis_names(mesh) else 1


# ==========================================================================
# The ambient mesh
# ==========================================================================

_AMBIENT: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """``with set_mesh(mesh):`` -- the mesh that ``get_abstract_mesh``
    returns inside (jax's ``set_mesh``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_abstract_mesh():
    """The innermost ``set_mesh``'s mesh, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def keep_axes(spec, mesh) -> PartitionSpec:
    """``spec`` without the axis names ``mesh`` lacks (``maybe_shard``'s
    rule)."""
    names = set(axis_names(mesh))

    def keep(e):
        kept = tuple(a for a in entry_axes(e) if a in names)
        return kept if kept else None

    return P(*(keep(e) for e in spec))


# ==========================================================================
# Specs as DTensor placements
# ==========================================================================

def spec_to_placements(spec, mesh, ndim: int | None = None) -> list:
    """One placement a mesh axis: ``Shard(d)`` for the axes of dimension
    d's entry, ``Replicate()`` for the others.  An axis sharding two
    dimensions is refused.  An entry whose axes are out of the mesh's
    order (the routed table's ``("model", "data")``) gets the same
    placements as in order: the same local shapes and wire bytes, another
    assignment of blocks to ranks; the routed functions cut plain tensors
    by their own shard map, so this touches only a DTensor's values."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate() for _ in names]
    for d, e in enumerate(spec):
        for a in entry_axes(e):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {a!r} shards two dimensions of {spec}")
            out[i] = Shard(d)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than {ndim} dimensions")
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def from_local(local, device_mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) from this rank's block,
    unchecked (the dry run's local regions)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, device_mesh, placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


# ==========================================================================
# Collectives with the gradients of the global function
# ==========================================================================

def _fc():
    return torch.ops._c10d_functional


def _wait(t):
    return _fc().wait_tensor(t)


def _chunks_to(x, order, inverse: bool):
    """Reorder x's leading chunks (one a group rank) between shard order
    and group order."""
    if order == sorted(order):
        return x
    n = len(order)
    perm = [0] * n
    for s, r in enumerate(order):
        if inverse:
            perm[s] = r  # group-order input -> shard-order output
        else:
            perm[r] = s  # shard-order input -> group-order output
    idx = torch.tensor(perm, device=x.device)
    return x.reshape(n, -1, *x.shape[1:]).index_select(0, idx).reshape(x.shape)


def _gather(x, group, order):
    n = len(order)
    out = _wait(_fc().all_gather_into_tensor(x.contiguous(), n, group.group_name))
    return _chunks_to(out, order, inverse=True)


def _scatter_sum(x, group, order):
    n = len(order)
    x = _chunks_to(x.contiguous(), order, inverse=False)
    return _wait(_fc().reduce_scatter_tensor(x, "sum", n, group.group_name))


def _all_reduce(x, group):
    return _wait(_fc().all_reduce(x.contiguous(), "sum", group.group_name))


def _a2a(x, group, order):
    x = _chunks_to(x.contiguous(), order, inverse=False)
    split = [x.shape[0] // len(order)] * len(order)
    out = _wait(_fc().all_to_all_single(x, split, split, group.group_name))
    return _chunks_to(out, order, inverse=True)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, order):
        ctx.group, ctx.order = group, order
        return _gather(x, group, order)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.order), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        y = _all_reduce(x, group)
        return y if scale == 1 else y / scale

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1 else g / ctx.scale), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, order):
        ctx.group, ctx.order = group, order
        return _a2a(x, group, order)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.order), None, None


class _SumCotangents(torch.autograd.Function):
    """The identity whose backward sums the cotangent over a group: an
    input the spec replicates over that group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherOut(torch.autograd.Function):
    """A sharded result gathered to every rank; the backward keeps this
    rank's block of the (same on every rank) cotangent."""

    @staticmethod
    def forward(ctx, x, group, order, index):
        ctx.n, ctx.index = len(order), index
        return _gather(x, group, order)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n)[ctx.index].contiguous(), None, None, None


def all_gather(x, axes, mesh=None):
    """``lax.all_gather(x, axes, tiled=True)`` along dim 0."""
    mesh = mesh or get_abstract_mesh()
    group, order = mesh.group(entry_axes(axes))
    return _AllGather.apply(x, group, order)


def psum(x, axes, mesh=None):
    mesh = mesh or get_abstract_mesh()
    group, _ = mesh.group(entry_axes(axes))
    return _Psum.apply(x, group, 1)


def pmean(x, axes, mesh=None):
    mesh = mesh or get_abstract_mesh()
    group, order = mesh.group(entry_axes(axes))
    return _Psum.apply(x, group, len(order))


def pmax(x, axes, mesh=None):
    """``lax.pmax``, without a gradient (a decode step's softmax max)."""
    mesh = mesh or get_abstract_mesh()
    group, _ = mesh.group(entry_axes(axes))
    return _wait(_fc().all_reduce(x.contiguous(), "max", group.group_name))


def all_to_all(x, axes, mesh=None):
    """``lax.all_to_all(x, axes, 0, 0)``: chunk s of dim 0 goes to shard s,
    and chunk s of the result came from shard s."""
    mesh = mesh or get_abstract_mesh()
    group, order = mesh.group(entry_axes(axes))
    return _AllToAll.apply(x, group, order)


def axis_index(axes, mesh=None) -> int:
    """``lax.axis_index`` of an axis name or a tuple of them (row-major in
    their order)."""
    mesh = mesh or get_abstract_mesh()
    return mesh.shard_index(entry_axes(axes))


def lookup_rows(table, ids):
    """``F.embedding(ids, table)`` of DTensors (the dry run) in a local
    region: each rank gathers the rows of its block of the table's rows
    (ids outside it read zeros), a partial sum over the mesh axes that
    split the rows, as XLA's masked gather under pjit.  (DTensor's own
    rule for a row-sharded lookup leaves a masked partial whose reduction
    or backward fails under fake tensors or on torch 2.11.)"""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    rows = [i for i, p in enumerate(table.placements)
            if isinstance(p, Shard) and p.dim == 0]
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    id_pl = [p if isinstance(p, Shard) and i not in rows else Replicate()
             for i, p in enumerate(ids.placements)]
    ids = ids.redistribute(mesh, id_pl)
    # the rows' cotangents of ids split over an axis sum over that axis
    local = table.redistribute(mesh, [Shard(0) if i in rows else Replicate()
                                      for i in range(mesh.ndim)]).to_local(
        grad_placements=[Shard(0) if i in rows else
                         Partial() if isinstance(id_pl[i], Shard) else Replicate()
                         for i in range(mesh.ndim)])
    idl = ids.to_local().long()
    coord, block = mesh.get_coordinate(), 0
    for i in rows:
        block = block * mesh.size(i) + coord[i]
    n = local.shape[0]
    keep = (idl >= block * n) & (idl < (block + 1) * n)
    got = F.embedding((idl - block * n).clamp(0, n - 1), local) * keep[..., None]
    out_pl = [Partial() if i in rows else p for i, p in enumerate(id_pl)]
    return from_local(got, mesh, out_pl, (*ids.shape, table.shape[1]))


# ==========================================================================
# shard_map
# ==========================================================================

def _tree_map(fn, tree, spec):
    """Map ``fn(leaf, spec)`` over a nest of dicts, lists and tuples whose
    spec tree has the same structure or is one spec for every leaf (a key
    the spec dict lacks maps with spec None)."""
    if isinstance(spec, PartitionSpec) or spec is None:
        if isinstance(tree, dict):
            return {k: _tree_map(fn, v, spec) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_tree_map(fn, v, spec) for v in tree)
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, spec.get(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, s) for v, s in zip(tree, spec))
    raise TypeError(f"spec {spec!r} does not fit {type(tree).__name__}")


def _moved_shard(have, want):
    """The mesh dimension whose split moves from one tensor dimension to
    another (``Shard(a)`` to ``Shard(b)``), where exactly one does and no
    other mesh dimension splits a or b; else None.  DTensor does this
    move by an all-gather on a CPU group (the dry run's), a device's
    whole tensor on the wire; the mesh paths' all-to-all moves a block."""
    from torch.distributed.tensor import Shard

    moves = [i for i, (h, w) in enumerate(zip(have, want))
             if isinstance(h, Shard) and isinstance(w, Shard) and h.dim != w.dim]
    if len(moves) != 1:
        return None
    i = moves[0]
    dims = (have[i].dim, want[i].dim)
    if any(isinstance(p, Shard) and p.dim in dims
           for j, p in enumerate([*have, *want]) if j % len(have) != i):
        return None
    return i


def local_block(x, spec, mesh):
    """This rank's block of ``x`` under ``spec``: a DTensor redistributed
    and its local tensor taken; a plain (global) tensor cut by the shard
    index."""
    if not isinstance(x, torch.Tensor):
        return x
    if is_dtensor(x):
        from torch.distributed.tensor import Partial, Replicate

        want = spec_to_placements(spec, mesh, x.ndim)
        moved = _moved_shard(x.placements, want)
        mid = list(want)
        if moved is not None:
            mid[moved] = x.placements[moved]
        x = x.redistribute(x.device_mesh, mid)
        grad = [Partial() if isinstance(p, Replicate) else p for p in mid]
        x = x.to_local(grad_placements=grad)
        if moved is None:
            return x
        # the blocks move from one dimension's split to another's: an
        # all-to-all over the axis (chunk s of the new dimension to shard s)
        a, b = mid[moved].dim, want[moved].dim
        axis = mesh.axis_names[moved]
        chunks = torch.stack(x.chunk(mesh.shape[axis], b))
        return torch.cat(all_to_all(chunks, axis, mesh).unbind(0), a)
    if x.requires_grad:
        # each rank's cotangent covers its block and its share of the work:
        # the global gradient is their sum over every rank
        x = _SumCotangents.apply(x, mesh.group(mesh.axis_names)[0])
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if axes:
            n = math.prod(mesh.shape[a] for a in axes)
            if x.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                                 f"split {n} ways ({spec})")
            x = x.chunk(n, d)[mesh.shard_index(axes)]
    return x


def global_from_block(y, spec, mesh, like=None):
    """The global tensor of this rank's block ``y`` under ``spec``: a
    DTensor on ``like``'s mesh when ``like`` is given, else gathered so
    that every rank holds the same plain tensor."""
    if not isinstance(y, torch.Tensor):
        return y
    if like is not None:
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(y, like.device_mesh,
                                  spec_to_placements(spec, mesh, y.ndim),
                                  run_check=False)
    for d in reversed(range(len(spec))):
        axes = entry_axes(spec[d])
        if axes:
            group, order = mesh.group(axes)
            y = y.movedim(d, 0)
            y = _GatherOut.apply(y, group, order, mesh.shard_index(axes))
            y = y.movedim(0, d)
    return y


def _first_dtensor(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            found = _first_dtensor(v)
            if found is not None:
                return found
        return None
    return tree if isinstance(tree, torch.Tensor) and is_dtensor(tree) else None


def shard_map(fn, mesh, in_specs, out_specs):
    """``jax.shard_map(fn, mesh, in_specs, out_specs)`` (with
    ``check_vma=False``): see the module docstring."""

    def run(*args):
        like = _first_dtensor(args)
        local = [_tree_map(lambda x, s: local_block(x, s, mesh), a, s)
                 for a, s in zip(args, in_specs)]
        with set_mesh(mesh):
            out = fn(*local)
        return _tree_map(lambda y, s: global_from_block(y, s, mesh, like), out,
                         out_specs)

    return run


def local_shape(shape, spec, mesh) -> tuple:
    """A global shape's block on one rank under ``spec``."""
    out = list(shape)
    for d, e in enumerate(spec):
        n = math.prod(axis_size(mesh, a) for a in entry_axes(e))
        out[d] //= n
    return tuple(out)


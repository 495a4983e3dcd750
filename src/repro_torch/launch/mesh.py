"""Meshes: one process per rank over ``torch.distributed``.

The JAX package runs one controller over a device mesh (GSPMD and
``shard_map``).  The port runs one process per rank instead, and every
split and every collective is explicit: this module's ``Mesh`` is the only
place that calls one (``psum``, ``pmax``, ``all_gather``,
``reduce_scatter``).  A serving mesh has one axis, ``("model",)``; a
training mesh two, ``("data", "model")``, ranks numbered row-major (rank
``d * model + m`` is data index ``d``, model index ``m``), as the devices
of a JAX mesh of that shape.

The backend is the caller's explicit choice, never picked by catching an
error:

  * ``gloo`` on the CPU (the tests), and for ranks that share one card
    (NCCL refuses two ranks on one device).  With CUDA tensors gloo copies
    through pinned host buffers: that is its transport; the compute stays
    on the card.
  * ``nccl`` where each rank owns a card (``device="cuda:{rank}"``).

Process groups are initialised from a file store in a temporary directory,
never a TCP port, so concurrent test workers cannot collide.
``spawn_ranks`` starts ``data x model`` ranks (``torch.multiprocessing``),
runs a function in each with its ``Mesh`` and gathers their results; a
rank that fails, or a run past its timeout, raises in the caller.

``make_production_mesh`` gives the JAX package's production meshes (16 x
16, 2 x 16 x 16) as placements only: a ``shape`` and no processes, what
the dry run (``launch/dryrun.py``) places each rank's share by.
"""
from __future__ import annotations

import datetime
import io
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["Mesh", "PlacementMesh", "make_serving_mesh", "make_host_mesh",
           "make_production_mesh", "spawn_ranks", "copy_to", "reduce_from",
           "all_reduce", "gather_from", "BACKENDS"]

BACKENDS = ("gloo", "nccl")
# a collective that waits longer than this fails the rank
COLLECTIVE_TIMEOUT_S = 300


class PlacementMesh:
    """A mesh as placements see it: axis names and extents, no processes
    (the production meshes of the dry run, and stand-ins in tests)."""

    def __init__(self, **axes: int):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)

    def __repr__(self) -> str:
        return f"PlacementMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> PlacementMesh:
    """The JAX package's production mesh, as placements: 16 x 16
    ``(data, model)``, or 2 x 16 x 16 ``(pod, data, model)``."""
    if multi_pod:
        return PlacementMesh(pod=2, data=16, model=16)
    return PlacementMesh(data=16, model=16)


class Mesh:
    """One rank's view of a ``("model",)`` or ``("data", "model")`` mesh.

    ``shape`` maps each axis to its extent, as a JAX mesh's does (what
    ``CacheConfig`` and ``launch/sharding.py`` read).  ``size`` and
    ``rank`` are this rank's ``model`` extent and index: the axis every
    collective of the forward runs over; ``data`` and ``data_rank`` the
    ``data`` axis's (1 and 0 on a serving mesh).  ``device`` is the device
    this rank's tensors live on.  A mesh of one rank has no process group
    and its collectives return their input.

    Each collective takes its ``axis``: ``"model"`` (the default),
    ``"data"``, or ``("data", "model")`` for every rank.  The float
    reductions gather every rank's tensor and sum them in rank order, so
    the result is the same bits on every rank and does not depend on the
    backend's reduction algorithm: replicated tensors stay bitwise equal
    across ranks, which greedy serving needs (ranks that picked different
    tokens would wait on each other in a collective), and so do the
    replicated leaves of a sharded train state.  Integer sums are exact in
    any order and reduce in place.
    """

    def __init__(self, size: int, rank: int = 0, *, backend: str = "gloo",
                 device="cuda", data: int = 1, data_rank: int = 0,
                 axis_names: tuple = ("model",), groups: dict | None = None,
                 host_group=None):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a mesh of {size}")
        if data < 1 or not 0 <= data_rank < data:
            raise ValueError(f"data rank {data_rank} of a data axis of "
                             f"{data}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if data > 1 and "data" not in axis_names:
            raise ValueError("a data axis of more than one rank needs "
                             "axis_names ('data', 'model')")
        self.size, self.rank, self.backend = size, rank, backend
        self.data, self.data_rank = data, data_rank
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        # {axis, or "world" for every rank of the mesh: process group};
        # an axis not given one spans the default group
        self._groups = groups or {}
        self._host_group = host_group

    @property
    def shape(self) -> dict[str, int]:
        ext = {"data": self.data, "model": self.size}
        return {a: ext[a] for a in self.axis_names}

    @property
    def world(self) -> int:
        return self.data * self.size

    @property
    def global_rank(self) -> int:
        return self.data_rank * self.size + self.rank

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}"
                f", rank={self.global_rank}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")

    # -- axes ---------------------------------------------------------------
    @staticmethod
    def _axes(axis) -> tuple[str, ...]:
        axes = axis if isinstance(axis, tuple) else (axis,)
        for a in axes:
            if a not in ("data", "model"):
                raise ValueError(f"unknown mesh axis {a!r}")
        return axes

    def extent(self, axis="model") -> int:
        """The number of ranks along ``axis`` (an axis or a tuple)."""
        n = 1
        for a in self._axes(axis):
            n *= self.data if a == "data" else self.size
        return n

    def index(self, axis="model") -> int:
        """This rank's index along ``axis``; along a tuple of axes,
        row-major (the first axis slowest), as a JAX spec's tuple entry."""
        i = 0
        for a in self._axes(axis):
            n, r = ((self.data, self.data_rank) if a == "data"
                    else (self.size, self.rank))
            i = i * n + r
        return i

    def _group(self, axis):
        axes = self._axes(axis)
        if len(axes) == 1 and axes[0] in self._groups:
            return self._groups[axes[0]]
        if self.extent(axes) == self.world:
            # the mesh's every rank: the default group unless given one
            return self._groups.get("world")
        raise ValueError(f"no process group for axes {axes}")

    # -- collectives ----------------------------------------------------------
    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   axis="model") -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` concatenated along ``dim`` in
        rank order."""
        if self.extent(axis) == 1:
            return x
        return torch.cat(self._gather(x, axis), dim=dim)

    def psum(self, x: torch.Tensor, axis="model") -> torch.Tensor:
        """The sum of every rank's ``x`` along ``axis``: in place for
        integers (exact), else in rank order over the gathered tensors (the
        same bits on every rank)."""
        if self.extent(axis) == 1:
            return x
        if not x.dtype.is_floating_point:
            out = x.clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM,
                            group=self._group(axis))
            return out
        parts = self._gather(x, axis)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def pmax(self, x: torch.Tensor, axis="model") -> torch.Tensor:
        """The elementwise maximum over the ranks (exact in any order)."""
        if self.extent(axis) == 1:
            return x
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self._group(axis))
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0,
                       axis="data") -> torch.Tensor:
        """This rank's equal slice along ``dim`` of the sum of every rank's
        ``x`` along ``axis``, summed in rank order (``psum``'s rule)."""
        n = self.extent(axis)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} ranks")
        per = x.shape[dim] // n
        parts = self._gather(x, axis)
        i = self.index(axis)
        out = parts[0].narrow(dim, i * per, per)
        for p in parts[1:]:
            out = out + p.narrow(dim, i * per, per)
        return out

    def gather_to_host(self, x: torch.Tensor) -> list[torch.Tensor] | None:
        """Every rank's ``x``, moved to the host, on global rank 0 (in
        global rank order); None on the others.  Through a host (gloo)
        group: nothing is gathered on the card."""
        host = x.detach().cpu().contiguous()
        if host.dtype == torch.bfloat16:
            host = host.float()
        if self.world == 1:
            return [host]
        parts = ([torch.empty_like(host) for _ in range(self.world)]
                 if self.global_rank == 0 else None)
        dist.gather(host, parts, dst=0, group=self._host_group)
        return parts

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self._host_group)

    def _gather(self, x: torch.Tensor, axis="model") -> list[torch.Tensor]:
        # gloo gathers bf16 only in recent builds: move it as f32 (exact)
        send = x.float() if x.dtype == torch.bfloat16 else x.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.extent(axis))]
        dist.all_gather(parts, send, group=self._group(axis))
        return [p.to(x.dtype) for p in parts]

    # -- helpers ------------------------------------------------------------
    def shard_bounds(self, n: int, axis="model") -> tuple[int, int]:
        """``[lo, hi)`` of this rank's equal slice of ``n`` along
        ``axis``."""
        m = self.extent(axis)
        if n % m:
            raise ValueError(f"{n} does not split over {m} ranks")
        per = n // m
        i = self.index(axis)
        return i * per, (i + 1) * per


# ---------------------------------------------------------------------------
# collectives with gradients (tensor parallelism over "model")
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    """Identity forward, ``psum`` backward: the input of column-parallel
    products, whose input gradients are each rank's share."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """``psum`` forward, identity backward: the output of row-parallel
    products (and of the vocab-parallel lookup and loss terms)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduce(torch.autograd.Function):
    """``psum`` forward and backward: a sum whose result feeds each rank's
    own work (the gated norm's sum of squares in ``models/ssm.py``), so
    each rank's gradient of it is a share of the whole one."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    """``all_gather`` forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        ctx.n = x.shape[dim]
        return mesh.all_gather(x, dim=dim, axis=axis)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


def _live(mesh, axis) -> bool:
    return mesh is not None and mesh.extent(axis) > 1


def copy_to(mesh, x: torch.Tensor, axis="model") -> torch.Tensor:
    """``x`` as it enters column-parallel products: itself, its gradient
    summed over ``axis`` (without grad, ``x`` itself)."""
    if _live(mesh, axis) and torch.is_grad_enabled():
        return _CopyTo.apply(x, mesh, axis)
    return x


def reduce_from(mesh, x: torch.Tensor, axis="model") -> torch.Tensor:
    """``psum`` of ``x`` over ``axis``, its gradient passed through to each
    rank's part."""
    return _ReduceFrom.apply(x, mesh, axis) if _live(mesh, axis) else x


def all_reduce(mesh, x: torch.Tensor, axis="model") -> torch.Tensor:
    """``psum`` of ``x`` over ``axis``, its gradient summed over ``axis``
    too (where the sum feeds rank-local work, unlike ``reduce_from``)."""
    return _AllReduce.apply(x, mesh, axis) if _live(mesh, axis) else x


def gather_from(mesh, x: torch.Tensor, dim: int = -1,
                axis="model") -> torch.Tensor:
    """``all_gather`` of ``x`` along ``dim``, each rank's gradient its own
    slice."""
    if not _live(mesh, axis):
        return x
    return _GatherFrom.apply(x, mesh, dim % x.dim(), axis)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------
def _join(world: int, backend: str, rank: int, init_method: str | None):
    if not dist.is_initialized():
        if init_method is None:
            raise ValueError("a mesh of more than one rank needs "
                             "init_method (file://...) or a process group")
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if dist.get_world_size() != world:
        raise ValueError(f"process group of {dist.get_world_size()} ranks, "
                         f"mesh of {world}")


def _set_device(dev: torch.device) -> None:
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)


def _host_group(backend: str, world: int):
    """The group that moves host tensors: the world group under gloo, a
    gloo group of its own under nccl (created by every rank)."""
    if world == 1 or backend == "gloo":
        return None
    return dist.new_group(backend="gloo")


def make_serving_mesh(model: int, *, backend: str, device, rank: int = 0,
                      init_method: str | None = None) -> Mesh:
    """This rank's ``("model",)`` mesh of ``model`` ranks: the shape the
    serving stack expects (``CacheConfig(mesh=...)``).

    ``model == 1`` needs no process group.  Otherwise the default process
    group is joined (or, if this process joined one already, reused) with
    ``init_method`` (``file://...``; ``spawn_ranks`` passes one), ``rank``
    and the world size ``model``; the ``backend`` is the caller's choice
    (module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = torch.device(device)
    if model == 1:
        return Mesh(1, 0, backend=backend, device=dev)
    _join(model, backend, rank, init_method)
    _set_device(dev)
    return Mesh(model, dist.get_rank(), backend=backend, device=dev,
                host_group=_host_group(backend, model))


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   backend: str = "gloo", device="cuda", rank: int = 0,
                   init_method: str | None = None) -> Mesh:
    """This rank's ``("data", "model")`` mesh of ``data x model`` ranks
    (the JAX package's host mesh; ``data`` defaults to 1 here, where the
    JAX package takes every device it sees).

    The default process group of ``data x model`` ranks is joined (or
    reused), and every rank creates one group for each ``model`` slice
    (the ranks of one data index) and one for each ``data`` slice (the
    ranks of one model index), in the same order."""
    data = data or 1
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = torch.device(device)
    world = data * model
    if world == 1:
        return Mesh(1, 0, backend=backend, device=dev,
                    axis_names=("data", "model"))
    _join(world, backend, rank, init_method)
    _set_device(dev)
    g = dist.get_rank()
    d, m = divmod(g, model)
    groups = {}
    for i in range(data):
        grp = dist.new_group([i * model + j for j in range(model)])
        if i == d:
            groups["model"] = grp
    for j in range(model):
        grp = dist.new_group([i * model + j for i in range(data)])
        if j == m:
            groups["data"] = grp
    return Mesh(model, m, data=data, data_rank=d, backend=backend,
                device=dev, axis_names=("data", "model"), groups=groups,
                host_group=_host_group(backend, world))


def _rank_main(rank, world, data, backend, device, init_method, fn, args,
               results):
    try:
        dev = device.format(rank=rank) if isinstance(device, str) else device
        if torch.device(dev).type == "cpu":
            # ranks share the host's cores with each other
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world // 2))
        if data == 1:
            mesh = make_serving_mesh(world, backend=backend, device=dev,
                                     rank=rank, init_method=init_method)
        else:
            mesh = make_host_mesh(data, world // data, backend=backend,
                                  device=dev, rank=rank,
                                  init_method=init_method)
        out = fn(mesh, *args)
        # as bytes: a tensor sent as itself would be shared through a file
        # descriptor that dies with this process
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except Exception:                               # reported to the caller
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *, backend: str, device, args=(),
                timeout: float = 120.0, data: int = 1) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new processes, one rank each,
    and return their results in rank order.

    With ``data == 1`` each rank's mesh is the serving mesh
    ``("model",)`` of ``world`` ranks; otherwise the ``("data",
    "model")`` mesh of ``data x (world // data)`` ranks.  ``fn`` must be
    importable by name (a module-level function) and its result picklable
    (CPU tensors, numpy arrays).  ``device`` is a string, formatted with
    ``{rank}`` (``"cuda:{rank}"`` for one card a rank, ``"cuda:0"`` for
    ranks sharing one).  A rank that raises, dies, or a run that takes more
    than ``timeout`` seconds raises here, after every rank has been
    stopped.
    """
    if data < 1 or world % data:
        raise ValueError(f"a data axis of {data} does not split {world} "
                         "ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, data, backend, device,
                                   init_method, fn, tuple(args), results),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        errors = []
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(errors) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world} ranks did not finish in {timeout:.0f} s "
                        f"(done: {sorted(got)})")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in got]
                    if dead and results.empty():
                        raise RuntimeError(
                            f"rank(s) {dead} died (exit codes "
                            f"{[procs[r].exitcode for r in dead]})")
                    continue
                if ok:
                    got[rank] = torch.load(io.BytesIO(out),
                                           weights_only=False)
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break            # the others may wait on it forever
            if errors:
                raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        finally:
            for p in procs:
                p.join(timeout=5 if not errors else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]

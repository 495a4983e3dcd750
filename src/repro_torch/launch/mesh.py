"""Serving meshes: one process per rank over ``torch.distributed``.

The JAX package runs one controller over a device mesh (GSPMD and
``shard_map``).  The port runs one process per rank of a single ``"model"``
axis instead, and every split and every collective is explicit: this
module's ``Mesh`` is the only place that calls one (``psum``, ``pmax``,
``all_gather``).

The backend is the caller's explicit choice, never picked by catching an
error:

  * ``gloo`` on the CPU (the tests), and for ranks that share one card
    (NCCL refuses two ranks on one device).  With CUDA tensors gloo copies
    through pinned host buffers: that is its transport; the compute stays
    on the card.
  * ``nccl`` where each rank owns a card (``device="cuda:{rank}"``).

Process groups are initialised from a file store in a temporary directory,
never a TCP port, so concurrent test workers cannot collide.
``spawn_ranks`` starts ``world`` ranks (``torch.multiprocessing``), runs a
function in each with its ``Mesh`` and gathers their results; a rank that
fails, or a run past its timeout, raises in the caller.

The JAX package's production meshes (16 x 16, 2 x 16 x 16) wait for the
dry-run slice (ROADMAP queue 1, item 19).
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

__all__ = ["Mesh", "make_serving_mesh", "make_host_mesh", "spawn_ranks",
           "BACKENDS"]

BACKENDS = ("gloo", "nccl")
# a collective that waits longer than this fails the rank
COLLECTIVE_TIMEOUT_S = 300


class Mesh:
    """One rank's view of a ``("model",)`` mesh of ``size`` ranks.

    ``shape`` maps each axis to its extent, as a JAX mesh's does (what
    ``CacheConfig`` and ``launch/sharding.py`` read); ``rank`` is this
    process's index on ``model`` and ``device`` the device its tensors live
    on.  A mesh of one rank has no process group and its collectives
    return their input.

    The float reductions gather every rank's tensor and sum them in rank
    order, so the result is the same bits on every rank and does not
    depend on the backend's reduction algorithm: replicated tensors stay
    bitwise equal across ranks, which greedy serving needs (ranks that
    picked different tokens would wait on each other in a collective).
    Integer sums are exact in any order and reduce in place.
    """

    axis_names = ("model",)

    def __init__(self, size: int, rank: int = 0, *, backend: str = "gloo",
                 device="cuda"):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a mesh of {size}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.size, self.rank, self.backend = size, rank, backend
        self.device = torch.device(device)

    @property
    def shape(self) -> dict[str, int]:
        return {"model": self.size}

    def __repr__(self) -> str:
        return (f"Mesh(model={self.size}, rank={self.rank}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")

    # -- collectives over "model" -----------------------------------------
    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return x
        parts = self._gather(x)
        return torch.cat(parts, dim=dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``: in place for integers (exact),
        else in rank order over the gathered tensors (the same bits on
        every rank)."""
        if self.size == 1:
            return x
        if not x.dtype.is_floating_point:
            out = x.clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM)
            return out
        parts = self._gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks (exact in any order)."""
        if self.size == 1:
            return x
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

    def _gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        # gloo gathers bf16 only in recent builds: move it as f32 (exact)
        send = x.float() if x.dtype == torch.bfloat16 else x.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send)
        return [p.to(x.dtype) for p in parts]

    # -- helpers ------------------------------------------------------------
    def shard_bounds(self, n: int) -> tuple[int, int]:
        """``[lo, hi)`` of this rank's equal slice of ``n``."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} ranks")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


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
    if not dist.is_initialized():
        if init_method is None:
            raise ValueError("a mesh of more than one rank needs "
                             "init_method (file://...) or a process group")
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=model,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if dist.get_world_size() != model:
        raise ValueError(f"process group of {dist.get_world_size()} ranks, "
                         f"mesh of {model}")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return Mesh(model, dist.get_rank(), backend=backend, device=dev)


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   backend: str = "gloo", device="cuda", rank: int = 0,
                   init_method: str | None = None) -> Mesh:
    """The JAX package's small ``(data, model)`` host mesh.  Serving uses
    ``model`` alone; a ``data`` axis of more than one rank belongs to
    sharded training (ROADMAP queue 1, item 13's training half) and
    raises."""
    if (data or 1) > 1:
        raise NotImplementedError(
            f"a data axis of {data}: data-parallel meshes come with sharded "
            "training (ROADMAP queue 1, item 13)")
    return make_serving_mesh(model, backend=backend, device=device,
                             rank=rank, init_method=init_method)


def _rank_main(rank, world, backend, device, init_method, fn, args, results):
    try:
        dev = device.format(rank=rank) if isinstance(device, str) else device
        if torch.device(dev).type == "cpu":
            # ranks share the host's cores with each other
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world // 2))
        mesh = make_serving_mesh(world, backend=backend, device=dev,
                                 rank=rank, init_method=init_method)
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
                timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new processes, one rank each,
    and return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable (CPU tensors, numpy arrays).  ``device`` is a string,
    formatted with ``{rank}`` (``"cuda:{rank}"`` for one card a rank,
    ``"cuda:0"`` for ranks sharing one).  A rank that raises, dies, or a
    run that takes more than ``timeout`` seconds raises here, after every
    rank has been stopped.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, device, init_method,
                                   fn, tuple(args), results), daemon=True)
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

"""Meshes for the port: stacked on one device, or one rank per process.

The counterpart of the JAX package's ``launch/mesh.py``.  Its
``make_host_mesh`` is ``make_host_mesh`` here (ranks stacked as lanes of
one device, ``core._axis.StackedMesh``); ``make_group_mesh`` builds the
process mesh (``GroupMesh``, one rank per process over
``torch.distributed``), for which ``init_world`` starts the process
group and ``spawn`` runs a function on every rank of a fresh world of
local processes.  ``make_production_mesh`` builds the JAX package's
production meshes (16 x 16, or 2 x 16 x 16 with a pod axis) as a
``GroupMesh`` over a fake world (``init_fake_world``): torch's ``"fake"``
process-group backend, whose collectives move nothing, so one process
can capture (``analysis.graph.capture``) what each of 256 or 512 ranks
would run, on fake tensors (``launch.dryrun``).

NCCL is the default backend and runs one rank per GPU: it refuses two
ranks on one card, so a world above the number of visible GPUs raises.
gloo runs on the CPU only, and its caller states ``device="cpu"``.
Nothing here reads a cluster's environment: the caller gives the rank,
the world and the rendezvous (``file://`` path, ``tcp://localhost`` or a
store).
"""
from __future__ import annotations

import datetime
import multiprocessing
import time
import traceback
import warnings
from multiprocessing import connection, resource_tracker

import torch
import torch.distributed as dist

from repro_torch.core._axis import GroupMesh, StackedMesh

#: the deprecation warnings torch 2.13 gives the two tensor collectives;
#: their new ``*_single`` names are not in torch 2.11, so the port keeps
#: the names both versions have
_OLD_NAMES = (r"`torch\.distributed\.(all_gather_into_tensor|"
              r"reduce_scatter_tensor)` is deprecated")


#: a collective that waits longer than this raises (the library's
#: default, 30 minutes, would let a hung rank hold a world that long)
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=5)


def init_world(backend: str = "nccl", *, rank: int, world: int,
               init_method: str | None = None, store=None) -> None:
    """Join the process group of ``world`` ranks as ``rank``.

    NCCL takes GPU ``rank`` (one rank per GPU: a world above the visible
    GPUs raises); gloo runs on the CPU.  The rendezvous is either
    ``init_method``, a ``file://`` path every rank can reach or
    ``tcp://localhost:<port>``, or ``store``, a ``torch.distributed``
    store every rank shares."""
    if (init_method is None) == (store is None):
        raise ValueError("give the rendezvous as init_method or store")
    if backend == "nccl":
        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > n_gpu:
            raise ValueError(
                f"NCCL runs one rank per GPU and refuses two ranks on one "
                f"card: world {world} needs {world} GPUs, {n_gpu} visible "
                "(run larger worlds on gloo with device='cpu')")
        torch.cuda.set_device(rank)
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    warnings.filterwarnings("ignore", message=_OLD_NAMES)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)


def init_fake_world(world: int, *, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake world of ``world`` ranks:
    torch's ``"fake"`` backend (``torch.testing._internal.distributed.
    fake_pg``), whose collectives return their outputs unfilled and wait
    for no one.  Only fake tensors should meet it (a capture); it raises
    if a default process group already exists
    (``dist.destroy_process_group`` ends the fake world)."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a default process group ({dist.get_backend()}, world "
            f"{dist.get_world_size()}) already exists: destroy it before "
            "making a fake world")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    warnings.filterwarnings("ignore", message=_OLD_NAMES)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


#: the JAX package's production meshes: a 16 x 16 (data, model) pod, and
#: two of them over a pod axis
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> GroupMesh:
    """The production mesh as a ``GroupMesh`` of the fake world
    (``init_fake_world(256)``, or ``512`` with ``multi_pod``); any other
    world raises.  ``device`` labels the fake tensors (default the
    CPU)."""
    shape, names = PRODUCTION_MESHES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_backend() != "fake" \
            or dist.get_world_size() != n:
        have = (f"{dist.get_backend()} world {dist.get_world_size()}"
                if dist.is_initialized() else "no process group")
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production "
                           f"mesh needs a fake world of {n} "
                           f"(init_fake_world({n})), not {have}")
    return GroupMesh(shape, names, device)


def make_host_mesh(shape, axes, device=None) -> StackedMesh:
    """A mesh whose ranks are stacked as lanes of one device."""
    return StackedMesh(shape, axes, device)


def make_group_mesh(shape, axes, device=None) -> GroupMesh:
    """A mesh over every process of the world (``init_world`` first); a
    one-name mesh's axis behaves as ``GroupAxis(device)``."""
    return GroupMesh(shape, axes, device)


# ---------------------------------------------------------------------------
# a world of local processes
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world, backend, port, conn, args):
    """One spawned rank: join the world through the parent's store on
    ``port``, run ``fn(*args)``, send ``(ok, result or traceback)`` back
    on ``conn``."""
    torch.set_num_threads(1)
    try:
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=COLLECTIVE_TIMEOUT)
        init_world(backend, rank=rank, world=world, store=store)
        try:
            conn.send((True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:           # reported to the parent, which raises
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()


def spawn(fn, world: int, *, backend: str = "gloo", args=(),
          timeout_s: float = 300.0) -> list:
    """Run ``fn(*args)`` on every rank of a new world of ``world`` local
    processes (``spawn`` start method) and return the results in rank
    order.  ``fn`` and its arguments are pickled by reference: ``fn`` is
    a module-level function.  The ranks meet at a ``TCPStore`` this
    process serves on a port the system picks, so worlds started side by
    side cannot collide.

    A rank that raises or dies fails the run, and so does a world that
    has not finished within ``timeout_s``: every process still running is
    killed and the error (the rank's traceback) raised here, so a hang
    fails rather than waits."""
    ctx = multiprocessing.get_context("spawn")
    got: dict[int, object] = {}
    server = dist.TCPStore("127.0.0.1", 0, is_master=True,
                           wait_for_workers=False,
                           timeout=COLLECTIVE_TIMEOUT)
    procs, readers = [], {}
    try:
        for r in range(world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(fn, r, world, backend, server.port,
                                  send, args))
            p.start()
            send.close()          # the child holds the write end
            procs.append(p)
            readers[recv] = r
        deadline = time.monotonic() + timeout_s
        while readers:
            left = deadline - time.monotonic()
            ready = connection.wait(list(readers), timeout=max(left, 0))
            if not ready:
                raise TimeoutError(
                    f"{world} ranks ran past {timeout_s:.0f} s; "
                    f"finished: {sorted(got)}")
            for conn in ready:
                rank = readers.pop(conn)
                try:
                    ok, res = conn.recv()
                except EOFError:
                    raise RuntimeError(f"rank {rank} of {world} exited "
                                       f"with {procs[rank].exitcode} "
                                       "and reported nothing") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} "
                                       f"failed:\n{res}")
                got[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for conn in readers:
            conn.close()
        # the spawn start method runs a resource-tracker process; stop
        # and reap it here, or it outlives the world (as a zombie where
        # nothing reaps orphans)
        resource_tracker._resource_tracker._stop()
    return [got[r] for r in range(world)]

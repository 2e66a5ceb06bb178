"""One process per rank: the port's distributed runtime (port of
lio_mapping_tpu.parallel.multihost) and its only collective helpers.

JAX runs one controller over a device mesh; here every rank is a process
of its own, and all ranks run the same program on the same inputs (every
rank reads the same log and runs the same host loop, as the reference's
multi-host design has every host ingest the same sweep stream). A 1-D
:class:`Mesh` carries the process group, the rank, the size, the device and
the backend; it is what the port's ``axis=`` / ``psum_axis=`` arguments take
in place of JAX's axis name.

    mesh = MH.initialize("127.0.0.1:29500", num_processes=2, process_id=rank,
                         device="cuda")
    step = lio_dist.make_sharded_lio_step(mesh, cfg)
    state, out = step(state, cloud, samples)     # the same on every rank

The collectives, each counted on the mesh (calls, payload bytes, bytes
copied through the host, and the host time inside them):

* ``psum``: ``lax.psum`` as ``all_reduce(SUM)``;
* ``ring_shift``: the ``ppermute`` ring, ``batch_isend_irecv`` to rank+1
  and from rank-1;
* ``all_gather_rows``: the tiled ``all_gather`` along rows,
  ``all_gather_into_tensor``;
* ``replicate``: a broadcast from rank 0 (see its docstring).

The backend is a rule (``choose_backend``): ``gloo`` on the CPU; on the
card ``nccl`` when there are at least as many cards as ranks, one rank per
card; else ``gloo``, with ranks sharing cards round-robin. A collective
that gloo refuses on CUDA tensors (``HOST_STAGED``, found by
``tools/probe_collectives.py``: its send/recv) copies through pinned host
buffers; the compute never leaves the card.

``launch`` starts the ranks of one command: spawned processes, a free local
port, and the worst exit code of the ranks.
"""

from __future__ import annotations

import dataclasses
import functools
import socket
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import tree_map

#: seconds a rank waits in a collective before it gives up (a rank that
#: died makes the others fail, not hang)
TIMEOUT_S = 300.0
#: seconds the other ranks get to end once one has failed
GRACE_S = 60.0

#: (backend, collective) pairs whose CUDA tensors travel through pinned
#: host buffers: the collectives gloo refuses on CUDA tensors. On an H100
#: with torch 2.11 (tools/probe_collectives.py), gloo takes CUDA tensors in
#: all_reduce, all_gather_into_tensor and broadcast, and its send/recv hands
#: the card's pointer to its TCP transport, which aborts the process.
HOST_STAGED = frozenset({("gloo", "batch_isend_irecv")})


@dataclasses.dataclass
class Mesh:
    """A 1-D mesh of ranks: one process per rank, one device per process.
    The counters add up every collective this rank took part in."""

    group: object            # the process group (the default group)
    rank: int
    size: int
    device: torch.device
    backend: str             # "gloo" or "nccl"
    collectives: int = 0     # collective calls
    bytes: int = 0           # payload bytes handed to them by this rank
    host_bytes: int = 0      # bytes copied device <-> pinned host for them
    seconds: float = 0.0     # host wall time inside them (waits for the peers included)

    def counters(self) -> dict:
        return {"collectives": self.collectives, "bytes": self.bytes,
                "host_bytes": self.host_bytes, "collective_s": self.seconds}


def choose_backend(device_type: str, world: int, n_cards: int) -> str:
    """The backend rule: gloo on the CPU; nccl with a card per rank; gloo
    when ranks must share cards (nccl refuses two ranks on one device)."""
    if device_type == "cuda" and n_cards >= world:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int, n_cards: int) -> torch.device:
    """Rank ``rank``'s device: card ``rank mod n_cards``, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % n_cards)
    return torch.device("cpu")


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device="cuda") -> Mesh:
    """Join the process group of ``num_processes`` ranks (``host:port`` of
    rank 0's rendezvous) on ``device``'s type and return the global mesh."""
    dev_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    if dev_type == "cuda" and n_cards == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    dev = rank_device(dev_type, process_id, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(choose_backend(dev_type, num_processes, n_cards),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=TIMEOUT_S))
    return global_mesh(dev_type)


def global_mesh(device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the joined process group, on
    ``device``'s type: rank r on card r mod the card count, or the CPU."""
    rank = dist.get_rank()
    dev_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    return Mesh(group=dist.group.WORLD, rank=rank, size=dist.get_world_size(),
                device=rank_device(dev_type, rank, n_cards), backend=dist.get_backend())


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(mesh: Mesh, op: str) -> bool:
    return mesh.device.type == "cuda" and (mesh.backend, op) in HOST_STAGED


def _to_host(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    mesh.host_bytes += host.nbytes
    return host


def _to_device(host: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    mesh.host_bytes += host.nbytes
    return host.to(mesh.device)


def _counted(fn):
    """Count a collective's call, payload bytes and host wall time on its
    mesh (``fn(t, mesh)``)."""
    @functools.wraps(fn)
    def run(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        t0 = time.perf_counter()
        mesh.collectives += 1
        mesh.bytes += t.nbytes
        try:
            return fn(t, mesh)
        finally:
            mesh.seconds += time.perf_counter() - t0
    return run


@_counted
def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over all ranks (``all_reduce(SUM)``), as a new
    tensor on the mesh's device; every rank gets the same bits."""
    out = t.clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def ring_shift(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Send ``t`` to rank+1 and return what rank-1 sent (the ``ppermute``
    ring, ``batch_isend_irecv``); every rank's ``t`` has the same shape."""
    if mesh.size == 1:
        return t
    return _ring_shift(t, mesh)


@_counted
def _ring_shift(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    staged = _staged(mesh, "batch_isend_irecv")
    send = _to_host(t, mesh) if staged else t.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (mesh.rank + 1) % mesh.size, group=mesh.group),
           dist.P2POp(dist.irecv, recv, (mesh.rank - 1) % mesh.size, group=mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _to_device(recv, mesh) if staged else recv


@_counted
def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` stacked along rows in rank order (the tiled
    ``all_gather``, ``all_gather_into_tensor``)."""
    # torch 2.13 renames all_gather_into_tensor (2.11 lacks the new name)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    out = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    gather(out, t.contiguous(), group=mesh.group)
    return out


@_counted
def _broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    out = t.clone()
    dist.broadcast(out, 0, group=mesh.group)
    return out


# ---------------------------------------------------------------------------
# host values <-> the mesh
# ---------------------------------------------------------------------------


def _as_tensor(a, mesh: Mesh) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(mesh.device)


def replicate(tree, mesh: Mesh):
    """A pytree of host or device values -> the same tree on every rank's
    device, as rank 0 holds it: rank 0 broadcasts each leaf (one broadcast
    per leaf). Unlike the reference's, whose every process must already
    hold the same value, a rank's own value is overwritten; every leaf must
    have the same shape and dtype on every rank."""
    return tree_map(lambda a: _broadcast(_as_tensor(a, mesh), mesh), tree)


def shard_rows(tree, mesh: Mesh):
    """A pytree of full-length host values (the same on every rank) -> this
    rank's slice of each leaf's leading axis, on its device (the rows past
    ``size * (n // size)`` belong to no rank, as in the reference)."""
    def one(a):
        a = _as_tensor(a, mesh)
        chunk = a.shape[0] // mesh.size
        return a[mesh.rank * chunk:(mesh.rank + 1) * chunk].contiguous()
    return tree_map(one, tree)


def fetch(tree):
    """Device values -> host numpy copies (the same on every rank for
    replicated values)."""
    return tree_map(lambda a: a.detach().cpu().numpy() if torch.is_tensor(a)
                    else np.asarray(a), tree)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(target, rank, world, address, args):
    sys.exit(int(target(rank, world, address, *args) or 0))


def _exit_code(code) -> int:
    """A process's exit code; killed by signal n -> 128 + n."""
    if code is None:
        return 1
    return code if code >= 0 else 128 - code


def launch(n_ranks: int, target, *args) -> int:
    """Run ``target(rank, n_ranks, address, *args)`` in ``n_ranks`` spawned
    processes that rendezvous at ``address`` (``127.0.0.1:<free port>``),
    and return the worst of their exit codes. Once a rank has failed, the
    others get ``GRACE_S`` seconds to end before they are terminated.
    ``target`` must be importable by name (the ranks start from a fresh
    interpreter)."""
    import multiprocessing as mp
    from multiprocessing.connection import wait

    ctx = mp.get_context("spawn")
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(target, r, n_ranks, address, args))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = None
    try:
        while any(p.is_alive() for p in procs):
            wait([p.sentinel for p in procs if p.is_alive()], timeout=1.0)
            if deadline is None and any(p.exitcode not in (None, 0) for p in procs):
                deadline = time.monotonic() + GRACE_S
            if deadline is not None and time.monotonic() > deadline:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                deadline = float("inf")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return max(_exit_code(p.exitcode) for p in procs)

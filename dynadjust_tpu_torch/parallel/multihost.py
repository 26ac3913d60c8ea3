"""Multi-device and multi-host distribution of the blocked adjustment.

The reference scales past one machine only by staging blocks to disk on a
single host (dnaadjust-stage.cpp:59, dnafile_mapping.hpp:48).  Here the
batched two-level (or nested) Schur elimination runs SPMD over a process
group, one process (rank) per device:

  * every rank holds the full logical system (as every process of the
    JAX package does) and keeps only the block shard
    [r·Bp/W, (r+1)·Bp/W) of the padded block batch on its device;
  * the junction terms are summed with ``all_reduce`` (psum), first
    within each host and then across hosts on a hierarchical mesh;
  * the reduced junction solve is replicated, and every rank ends with
    identical results (block shards gathered with ``broadcast``; the
    replicated parts computed alike on every rank from the same summed
    inputs, their scatters in a fixed order, check_replicated).

Port of the JAX package's ``parallel/multihost.py`` on
``torch.distributed``.  A ``Mesh`` here is a process group, not a device
array: one program per rank instead of one program over many devices.
Every collective is an ``all_reduce`` or a ``broadcast`` — the two that
``gloo`` runs on CUDA tensors as well as CPU ones — so several ranks can
share one card over ``gloo`` (NCCL refuses two ranks on one card), and
CPU tests run the same code over ``gloo``.  Gathers are broadcasts of
each rank's shard into its slot of a full buffer: exact, so every rank
holds bit-identical copies.

Processes are started by the caller: ``torch.multiprocessing`` (start
method spawn) for local ranks (``spawn_ranks``, the CLI's ``--devices
N``), or one process per card on each host joining through
DTA_COORDINATOR (host:port), DTA_NUM_PROCESSES (world size) and
DTA_PROCESS_ID (rank) (``init_distributed``).
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh", "init_distributed", "is_multiprocess", "global_block_mesh",
    "hierarchical_block_mesh", "psum", "gather_blocks", "shard_blocks",
    "gather_to_host", "psum_np", "gather_np",
    "check_replicated",
    "schur_solve_multihost", "placement", "spawn_ranks", "start_ranks",
    "join_ranks",
    "COUNTS", "reset_counts",
]

# collectives issued by this process since reset_counts(): calls and
# payload bytes (what chip_smoke.py reads per adjustment)
COUNTS = {"all_reduce": 0, "broadcast": 0, "bytes": 0}

# the device of the default (global) mesh, set by init_distributed
_DEFAULT = {"device": None}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _timeout() -> timedelta:
    """Process-group timeout: DTA_DIST_TIMEOUT seconds (600)."""
    return timedelta(seconds=float(os.environ.get("DTA_DIST_TIMEOUT", 600)))


class Mesh:
    """A layout of the block batch over the ranks of a process group.

    axis_names and shape read as a jax.sharding.Mesh's do (shape[axis]
    is the number of ranks along that axis); rank, size and device are
    this process's; groups are the reduction stages of a sum, innermost
    first (None: the whole world).  Block shards are rank-major: rank r
    holds blocks [r·L, (r+1)·L) of a batch padded to Bp = L·size."""

    def __init__(self, shape: dict, device, groups=(None,)):
        self.shape = {k: int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        if int(np.prod(list(self.shape.values()))) != self.size:
            raise ValueError(f"mesh shape {self.shape} does not cover the "
                             f"{self.size} ranks")
        self.device = torch.device(device)
        self.groups = tuple(groups)
        self.backend = dist.get_backend()
        # nccl moves CUDA tensors only; gloo takes host arrays as they are
        self.host_device = (self.device if self.backend == "nccl"
                            else torch.device("cpu"))

    def padded(self, B: int) -> int:
        """The block count padded to a multiple of the ranks."""
        return -(-int(B) // self.size) * self.size

    def shard(self, Bp: int) -> slice:
        """This rank's slice of a padded block batch."""
        L = Bp // self.size
        return slice(self.rank * L, (self.rank + 1) * L)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank}/{self.size}, "
                f"{self.device}, {self.backend})")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, cpu: bool = False,
                     backend: str | None = None,
                     init_method: str | None = None,
                     device=None) -> bool:
    """Join a process group as one rank.

    With no arguments, reads DTA_COORDINATOR (host:port, the rendezvous
    of rank 0 — becomes tcp://host:port), DTA_NUM_PROCESSES (world size)
    and DTA_PROCESS_ID (rank).  The backend is nccl on the card, its
    device cuda:<local rank> (DTA_LOCAL_RANK, else the rank modulo the
    visible cards), or gloo on the CPU when cpu is set; backend="gloo"
    with a card keeps CUDA tensors on gloo (several ranks on one card).
    init_method (e.g. file:///path/store) replaces the coordinator.
    Returns True when the world has more than one rank, False when
    nothing was asked for (single process).  The JAX package's
    TPU-pod auto-detection (TPU_WORKER_HOSTNAMES) has no counterpart:
    nothing on a GPU machine describes the cluster, so the three
    variables are required."""
    coordinator = coordinator or os.environ.get("DTA_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("DTA_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("DTA_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if init_method is None and coordinator is None and num_processes is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a distributed run needs DTA_NUM_PROCESSES and "
                         "DTA_PROCESS_ID beside DTA_COORDINATOR")
    if init_method is None:
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
    backend = backend or ("gloo" if cpu else "nccl")
    if device is None:
        if cpu:
            device = torch.device("cpu")
        else:
            local = os.environ.get("DTA_LOCAL_RANK")
            ncard = max(torch.cuda.device_count(), 1)
            device = torch.device("cuda", int(local) if local is not None
                                  else process_id % ncard)
    device = torch.device(device)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout(), **kw)
    _DEFAULT["device"] = device
    return dist.get_world_size() > 1


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_block_mesh(axis: str = "blocks", device=None) -> Mesh:
    """One axis over every rank of the world."""
    return Mesh({axis: dist.get_world_size()},
                device if device is not None else _DEFAULT["device"])


def hierarchical_block_mesh(local_size: int, host_axis: str = "hosts",
                            local_axis: str = "blocks",
                            device=None) -> Mesh:
    """(hosts, local) mesh of W = H·local_size ranks, hosts-major (ranks
    h·L .. h·L + L − 1 on host h).  A sum runs in two steps, as the JAX
    package's psum over (local, hosts): within each host's local group
    first, then across hosts among the ranks with the same local index —
    the cross-host stage carries already-reduced partials.  Every rank
    creates every group (torch.distributed requires it)."""
    W = dist.get_world_size()
    L = int(local_size)
    if L < 1 or W % L:
        raise ValueError(f"{L} ranks per host do not divide the {W} ranks")
    H = W // L
    rank = dist.get_rank()
    local = cross = None
    kw = {"timeout": _timeout()}
    for h in range(H):
        g = dist.new_group([h * L + i for i in range(L)], **kw)
        if rank // L == h:
            local = g
    for i in range(L):
        g = dist.new_group([h * L + i for h in range(H)], **kw)
        if rank % L == i:
            cross = g
    return Mesh({host_axis: H, local_axis: L},
                device if device is not None else _DEFAULT["device"],
                groups=(local, cross))


# ---------------------------------------------------------------------------
# collectives: all_reduce and broadcast only
# ---------------------------------------------------------------------------

def psum(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t summed (or reduced with op) over every rank of the mesh, in its
    reduction stages; returns the reduced tensor (t itself when it was
    contiguous)."""
    t = t.contiguous()
    for g in mesh.groups:
        dist.all_reduce(t, op=op, group=g)
        COUNTS["all_reduce"] += 1
        COUNTS["bytes"] += t.numel() * t.element_size()
    return t


def gather_blocks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full block batch (size·L, ...) on every rank from each rank's
    shard t (L, ...): one broadcast per rank into its slot — exact."""
    if mesh.size == 1:
        return t
    L = t.shape[0]
    full = torch.empty((mesh.size * L, *t.shape[1:]), dtype=t.dtype,
                       device=t.device)
    for src in range(mesh.size):
        buf = full[src * L:(src + 1) * L]
        if src == mesh.rank:
            buf.copy_(t)
        dist.broadcast(buf, src)
        COUNTS["broadcast"] += 1
        COUNTS["bytes"] += buf.numel() * buf.element_size()
    return full


def shard_blocks(full, mesh: Mesh, dtype=None) -> torch.Tensor:
    """This rank's slice of a padded block batch (numpy or tensor, leading
    dimension a multiple of the ranks) on the mesh device."""
    n = full.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} blocks does not shard over "
                         f"{mesh.size} ranks (pad it first)")
    if not isinstance(full, torch.Tensor):
        full = np.asarray(full)
    return torch.as_tensor(full[mesh.shard(n)], dtype=dtype,
                           device=mesh.device)


def gather_to_host(t: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """A block-sharded tensor as the full numpy batch on every rank."""
    return gather_blocks(t, mesh).cpu().numpy()


def psum_np(a: np.ndarray, mesh: Mesh) -> np.ndarray:
    """A host array summed over the ranks (through the device for nccl)."""
    t = torch.as_tensor(np.ascontiguousarray(a), device=mesh.host_device)
    return psum(t, mesh).cpu().numpy()


def gather_np(a: np.ndarray, mesh: Mesh,
              chunk_bytes: float = 2.0 ** 28) -> np.ndarray:
    """A host block shard (L, ...) gathered to the full host batch: one
    broadcast per rank into its slot, straight into host memory for
    gloo, through the device in pieces of at most chunk_bytes for nccl,
    so that the full batch never sits on the device."""
    a = np.ascontiguousarray(a)
    if mesh.size == 1:
        return a
    L = a.shape[0]
    full = np.empty((mesh.size * L, *a.shape[1:]), dtype=a.dtype)
    step = max(1, int(chunk_bytes // max(a[:1].nbytes, 1)))
    on_host = mesh.host_device.type == "cpu"
    for src in range(mesh.size):
        for k in range(0, L, step):
            dst = full[src * L + k:src * L + min(k + step, L)]
            if src == mesh.rank:
                dst[...] = a[k:k + step]
            t = (torch.from_numpy(dst) if on_host
                 else torch.as_tensor(dst, device=mesh.host_device))
            dist.broadcast(t, src)
            COUNTS["broadcast"] += 1
            COUNTS["bytes"] += t.numel() * t.element_size()
            if not on_host:
                dst[...] = t.cpu().numpy()
    return full


def check_replicated(a: np.ndarray, mesh: Mesh, what: str):
    """Raise unless every rank's copy of a is bitwise rank 0's: the mesh
    routes apply replicated sums on every rank, so ranks that drift
    apart are a fault, not noise."""
    if mesh.size == 1:
        return
    t = torch.as_tensor(np.ascontiguousarray(a), device=mesh.host_device)
    root = t.clone()
    dist.broadcast(root, 0)
    COUNTS["broadcast"] += 1
    COUNTS["bytes"] += root.numel() * root.element_size()
    same = torch.tensor([float(torch.equal(root, t))],
                        device=mesh.host_device)
    psum(same, mesh, op=dist.ReduceOp.MIN)
    if same.item() != 1.0:
        raise RuntimeError(f"{what} differs between ranks (rank "
                           f"{mesh.rank} of {mesh.size})")


def schur_solve_multihost(bs, mesh: Mesh | None = None, scale: bool = True):
    """The mesh-sharded two-level Schur solve on any mesh (flat or
    hierarchical): every rank passes the same logical BlockSystem and
    keeps only its block shard on its device.  Returns host-replicated
    (xi (B, ni), xj (nj_global,)) numpy on every rank — the same route as
    parallel/schur.py::schur_solve_sharded."""
    from .schur import schur_solve_sharded
    return schur_solve_sharded(bs, mesh or global_block_mesh(), scale=scale)


# ---------------------------------------------------------------------------
# local ranks: torch.multiprocessing with the spawn start method
# ---------------------------------------------------------------------------

def placement(world: int, backend: str | None = None, device=None):
    """(backend, device) of `world` local ranks: the card unless the
    caller asks for the CPU (device "cpu": gloo).  device None: rank r
    on cuda:r over nccl when every rank has a card of its own, else
    gloo with rank r on cuda:(r mod cards) (NCCL refuses two ranks on
    one card); a named card holds every rank (gloo past one rank).
    Raises when a card is asked for and none is present.  The device
    is a string, or None for cuda:<rank>."""
    if device is not None and torch.device(device).type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"ranks on the CPU run over gloo, not "
                             f"{backend}")
        return "gloo", "cpu"
    ncard = torch.cuda.device_count()
    if ncard == 0:
        raise RuntimeError("no CUDA card is present: pass device='cpu' "
                           "to run the ranks on the CPU")
    if device is None:
        own = world <= ncard
        return backend or ("nccl" if own else "gloo"), None
    return backend or ("nccl" if world == 1 else "gloo"), str(device)


def _rank_main(target, rank, world, init_method, backend, device, args,
               threads):
    """Body of one spawned rank: join the group, run target(mesh, *args),
    leave the group."""
    torch.set_num_threads(threads)
    if device is None:
        device = f"cuda:{rank % torch.cuda.device_count()}"
    init_distributed(num_processes=world, process_id=rank,
                     init_method=init_method, backend=backend,
                     device=device)
    try:
        target(global_block_mesh(), *args)
    finally:
        dist.destroy_process_group()


def start_ranks(target, ranks, world, init_method, backend=None,
                device=None, args=(), threads: int = 1):
    """Start the given ranks of a world as spawned processes, each running
    target(mesh, *args) (target and args must pickle).  backend and
    device as placement() resolves them: the card unless device="cpu".
    threads: each rank's torch CPU threads — ranks whose CPU work must
    agree bitwise with a rank in another process take that process's
    count (a reduction's order can follow the thread count)."""
    import torch.multiprocessing as mp
    backend, device = placement(world, backend, device)
    ctx = mp.get_context("spawn")
    procs = []
    for r in ranks:
        p = ctx.Process(target=_rank_main, daemon=True,
                        args=(target, r, world, init_method, backend,
                              device, args, threads))
        p.start()
        procs.append(p)
    return procs


def join_ranks(procs, timeout: float | None = None):
    """Wait for spawned ranks; kill every one still alive after timeout
    seconds (default: the process-group timeout, DTA_DIST_TIMEOUT).
    Raises RuntimeError naming the ranks that failed."""
    if timeout is None:
        timeout = _timeout().total_seconds()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(10)
    bad = [(i, p.exitcode) for i, p in enumerate(procs)
           if p.exitcode != 0]
    if late:
        raise RuntimeError(f"{len(late)} rank(s) still running after "
                           f"{timeout:.0f} s were killed")
    if bad:
        raise RuntimeError(f"rank processes failed (index, exit code): "
                           f"{bad}")


def spawn_ranks(target, world, init_method, backend=None, device=None,
                args=(), timeout: float = 600.0):
    """Run target(mesh, *args) on `world` spawned ranks and wait: on the
    card unless device="cpu" (placement())."""
    join_ranks(start_ranks(target, range(world), world, init_method,
                           backend, device, args), timeout)

"""Process groups: start-up, barrier, replica checks, and the collectives
the sharded modules build on.

The port of :mod:`edrgp_tpu.parallel.distributed` onto ``torch.distributed``.
The process group follows the device: NCCL for ranks on the card, gloo only
when the caller asks for ``device="cpu"``; nothing falls back from one to the
other.  Every group gets an explicit collective timeout, so a wedged rank
fails instead of hanging.  :func:`barrier` all-reduces ones and checks the
count; :func:`checksum` is the JAX package's digest of a tree of arrays, and
:func:`assert_replicas_agree` all-gathers it.

The collectives below (:func:`all_gather_cat`, :func:`broadcast_from`,
:func:`ordered_sum`, :func:`reduce_to`, :func:`ring_shift`) take ranks *in
the group* they are given.  :func:`ordered_sum` all-gathers and adds the
parts in rank order, so its result has the same bits on every rank: the
sharded optimizers need that, since ranks whose line searches see different
bits take different branches and then issue different collectives.

:func:`spawn` starts R ranks on this host (the ``spawn`` start method, a
file rendezvous, a join timeout) and returns what each rank's function
returned; the multi-rank CPU tests run through it.
"""

from __future__ import annotations

import datetime
import os
import queue as _queue
import shutil
import socket
import tempfile
import time
import traceback
import multiprocessing as mp
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._pytree import leaves
from ..config import resolve_device

__all__ = ["initialize", "barrier", "checksum", "assert_replicas_agree",
           "spawn"]

#: Seconds a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(device=None, init_method: Optional[str] = None,
               world_size: int = 1, rank: int = 0,
               timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and run a start-up barrier; returns this
    rank's device.

    ``device`` None or ``"cuda"`` means the card (NCCL; rank r takes card
    r mod the card count) and raises without one; ``"cpu"`` means gloo.
    ``init_method`` is the rendezvous (``tcp://127.0.0.1:<port>`` or
    ``file://<path>``); a one-rank group may leave it None for a free
    port on 127.0.0.1.  ``timeout`` bounds every collective, in seconds.
    """
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is None:
        if world_size != 1:
            raise ValueError("a group of more than one rank needs an "
                             "init_method that every rank is given")
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    kwargs = {}
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else rank % torch.cuda.device_count())
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        # NCCL's communicator is built now, so a failure raises here.
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kwargs)
    barrier()
    return device


def collective_device(group=None) -> torch.device:
    """The device the group's collectives take tensors on."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(group=None) -> None:
    """All-reduce a one from every rank and check the count."""
    if not dist.is_initialized():
        raise RuntimeError("barrier: no process group (call initialize)")
    n = dist.get_world_size(group)
    x = torch.ones(1, device=collective_device(group))
    dist.all_reduce(x, group=group)
    got = int(x.item())
    if got != n:
        raise RuntimeError(f"barrier counted {got} ranks, expected {n}: a "
                           "rank is missing or mis-wired")


def checksum(tree) -> float:
    """Order-independent scalar digest of a tree of tensors and arrays (the
    JAX package's formula)."""
    total = 0.0
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.asarray(leaf, dtype=np.float64)
        total += float(np.nansum(a)) + 1e-9 * float(np.nansum(np.abs(a)))
    return total


def assert_replicas_agree(tree, atol: float = 0.0, group=None) -> None:
    """Raise on every rank unless every rank holds the same digest of
    ``tree`` (state that should be replicated).  It synchronizes the
    ranks: call it sparingly."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    local = torch.tensor([checksum(tree)], dtype=torch.float64,
                         device=collective_device(group))
    gathered = all_gather_cat(local, group).cpu().numpy()
    if not np.allclose(gathered, gathered[0], atol=atol, rtol=0.0):
        raise RuntimeError(
            f"replicated state diverged across ranks: digests {gathered}")


# ---------------------------------------------------------------------------
# Collectives over a group, by rank in the group
# ---------------------------------------------------------------------------

def _global(group, rank: int) -> int:
    return dist.get_global_rank(group, rank) if group is not None else rank


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along dim 0 in rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def broadcast_from(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank; the others pass a buffer of the
    same shape and dtype."""
    x = x.contiguous()
    dist.broadcast(x, src=_global(group, src), group=group)
    return x


def ordered_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over ranks of ``x``, added in rank order after an all-gather: the
    same bits on every rank (see the module docstring)."""
    parts = all_gather_cat(x[None], group)
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


def reduce_to(x: torch.Tensor, dst: int, group=None) -> torch.Tensor:
    """Σ over ranks of ``x`` on rank ``dst`` (undefined elsewhere)."""
    x = x.contiguous().clone()
    dist.reduce(x, dst=_global(group, dst), group=group)
    return x


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``x`` to rank r − 1 and receive rank r + 1's (mod the group
    size), paired in one ``batch_isend_irecv`` so no rank blocks on its
    send."""
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _global(group, (r - 1) % p), group),
           dist.P2POp(dist.irecv, out, _global(group, (r + 1) % p), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# ---------------------------------------------------------------------------
# Starting ranks on this host
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, device, init_method, timeout, args,
               results):
    try:
        # One host: the ranks talk over the loopback interface.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        initialize(device, init_method, world_size, rank, timeout)
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *, device=None, args=(),
          timeout: float = 60.0, join_timeout: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (the ``spawn`` start method), each in one process group on ``device``
    with collective timeout ``timeout``; returns each rank's result, in
    rank order.

    ``device`` None means the card, as for :func:`initialize` (NCCL; rank
    r on card r mod the card count) and raises without one; ``"cpu"``
    means gloo ranks.

    ``fn`` must be importable by name in a fresh interpreter, and its
    result picklable.  The first rank that raises, or no result from every
    rank within ``join_timeout`` seconds, raises here; the ranks still
    running are then killed.
    """
    device = resolve_device(device)
    rendezvous = tempfile.mkdtemp(prefix="edrgp-ranks-")
    init_method = "file://" + os.path.join(rendezvous, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, str(device), init_method,
                               timeout, tuple(args), results), daemon=True)
             for r in range(world_size)]
    out = {}
    deadline = time.monotonic() + join_timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(out))} "
                    f"gave no result within {join_timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} "
                                   f"failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            if p.pid is None:       # never started
                continue
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return [out[r] for r in range(world_size)]

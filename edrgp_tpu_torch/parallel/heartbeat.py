"""Liveness monitoring for long-running multi-process runs.

The port of :mod:`edrgp_tpu.parallel.heartbeat`, which holds no JAX: the
same code.  The failure mode it guards against: one rank dies or wedges,
every other rank blocks inside the next collective, and the job burns its
allocation doing nothing.  The process group's collective timeout
(:func:`edrgp_tpu_torch.parallel.distributed.initialize`) bounds a wedged
collective; these pieces detect a stall *around* the device steps:

  * :class:`StallWatchdog` — a per-process watchdog thread.  The training /
    sampling loop calls :meth:`StallWatchdog.beat` after each completed
    step; if no beat arrives within the deadline (a hung collective, a
    stuck kernel build), the watchdog fires its ``on_stall`` callback — by
    default logging loudly and, with ``abort=True``, killing the process
    so the launcher can restart the job from the last checkpoint
    (:mod:`edrgp_tpu_torch.checkpoint`).

  * :func:`write_heartbeat` / :func:`stale_peers` — cross-host liveness
    through a shared directory: each rank stamps a JSON file every few
    steps from its loop; any rank can cheaply list peers whose stamps have
    gone stale WITHOUT entering a collective — the safe way to decide
    "peer is gone, abort now" while not already blocked.

Both pieces are plain host-side Python (threads + files): device code
cannot observe peer death.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["StallWatchdog", "write_heartbeat", "read_heartbeats",
           "stale_peers"]


class StallWatchdog:
    """Detect a wedged step loop and act before the allocation is wasted.

    Usage::

        with StallWatchdog(timeout_s=300, abort=True) as dog:
            for step in range(n_steps):
                state = train_step(state)          # device work
                torch.cuda.synchronize()
                dog.beat(step)

    The watchdog thread wakes every ``poll_s`` seconds; if the last beat is
    older than ``timeout_s`` it calls ``on_stall(seconds_since_beat,
    last_step)`` once.  The default handler writes a diagnostic to stderr;
    with ``abort=True`` it then sends ``signal`` (SIGTERM) to this process
    so a supervising launcher restarts it from the latest checkpoint.
    """

    def __init__(self, timeout_s: float, *, poll_s: Optional[float] = None,
                 on_stall: Optional[Callable[[float, int], None]] = None,
                 abort: bool = False, sig: int = signal.SIGTERM):
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s) if poll_s is not None else min(
            1.0, self.timeout_s / 4.0)
        self._on_stall = on_stall
        self._abort = bool(abort)
        self._sig = sig
        self._last_beat = time.monotonic()
        self._last_step = -1
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    # -- loop-side API -------------------------------------------------
    def beat(self, step: int = -1) -> None:
        """Mark progress (call after each completed, blocked-on step)."""
        self._last_beat = time.monotonic()
        if step >= 0:
            self._last_step = int(step)

    @property
    def fired(self) -> bool:
        return self._fired

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._last_beat = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="edrgp-stall-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 1.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- watchdog thread ---------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            silent = time.monotonic() - self._last_beat
            if silent < self.timeout_s:
                continue
            self._fired = True
            if self._on_stall is not None:
                self._on_stall(silent, self._last_step)
            else:
                print(f"[edrgp heartbeat] no step progress for "
                      f"{silent:.0f}s (last step {self._last_step}); "
                      f"likely a hung collective or dead peer",
                      file=sys.stderr, flush=True)
            if self._abort:
                os.kill(os.getpid(), self._sig)
            return  # fire once


def _hb_path(directory: str, process_id: int) -> str:
    return os.path.join(directory, f"heartbeat-{process_id:05d}.json")


def write_heartbeat(directory: str, process_id: int, step: int = -1,
                    payload: Optional[dict] = None) -> None:
    """Atomically stamp this host's liveness file (call every few steps)."""
    os.makedirs(directory, exist_ok=True)
    rec = {"process_id": int(process_id), "step": int(step),
           "time": time.time()}
    if payload:
        rec.update(payload)
    path = _hb_path(directory, process_id)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)


def read_heartbeats(directory: str) -> dict[int, dict]:
    """All peer records found in the heartbeat directory."""
    out: dict[int, dict] = {}
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not (name.startswith("heartbeat-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
            out[int(rec["process_id"])] = rec
        except (ValueError, KeyError, OSError, json.JSONDecodeError):
            continue  # torn write from a dying peer: treat as absent
    return out


def stale_peers(directory: str, timeout_s: float,
                expected: Optional[int] = None,
                now: Optional[float] = None) -> list[int]:
    """Process ids that have not stamped within ``timeout_s`` (or never).

    ``expected`` = total process count; ids with no file at all are
    reported stale (a peer that died before its first stamp).
    """
    now = time.time() if now is None else now
    seen = read_heartbeats(directory)
    stale = [pid for pid, rec in seen.items()
             if now - float(rec.get("time", 0.0)) > timeout_s]
    if expected is not None:
        stale += [pid for pid in range(expected) if pid not in seen]
    return sorted(set(stale))

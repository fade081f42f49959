"""A cell on ``chips`` ranks: one process of ``run.py`` for each card.

A cell whose ``chips`` is k > 1 runs as k processes of ``perfbench/run.py``.
The process started by the command is rank 0, so the run's start (``T0``) and
``setup_s`` are that process's.  It starts ranks 1 … k−1 as children of
the same script (``--rank r --world DIR``, :class:`Ranks`), and all of them
meet through a ``torch.distributed.FileStore`` in the temporary directory
``DIR`` (:func:`join`): NCCL on cards, rank r on ``cuda:r``; gloo on the
CPU.  Every group waits at most :data:`PG_TIMEOUT`.  The program finds the
world up: the ``sharded`` engine's mesh spans the k ranks.

Rank 0 alone decides when the window ends (:class:`Until`) and broadcasts
the decision over a gloo group on the host, so that every rank makes the
same number of calls and no collective is left waiting, and the decision
is no device work.  Once the window has closed each other rank reads its
peak and trace, frees its state, and sends those readings with the
modules it holds to rank 0, then leaves: rank 0 checks and prints alone.

A thread of rank 0 watches the children: a rank that exits nonzero, or a
run that passes its wall-clock limit (:data:`WALL_S`), kills every rank
and ends rank 0 with :data:`FAILED`, naming the rank and the end of its
standard error.  Each child asks the kernel to kill it when rank 0 dies,
so none outlives the run.

A one-chip cell uses nothing here but :class:`Until` without a group: it
starts no process and opens no process group.

The benchmark owns this launcher; it imports nothing of the program's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

#: the whole run of a k-rank cell, from rank 0's start: set-up with its
#: first build, the window and the check.  A cell's first run in a
#: checkout, which builds, is allowed 1,200 s and every later run 360 s;
#: this is the 1,200 s less 30 s in which to kill the ranks and name the
#: one at fault, so that a hung run ends here and not at the caller's
#: limit, and no run within its allowance is ended by it but a first run
#: in its last 30 s
WALL_S = 1170.0

#: a collective waits at most this long: no healthy rank times out before
#: the watcher ends the run at ``WALL_S``
PG_TIMEOUT = timedelta(seconds=WALL_S)

#: rank 0's exit code when a rank failed or the run passed ``WALL_S``
FAILED = 5

_PR_SET_PDEATHSIG = 1
_TAIL = 3000


class Until:
    """The window's end, asked after each call: ``done(t0)``.

    With no group (one rank) it is the host clock's comparison alone.  With
    a group, rank 0 compares and every rank takes rank 0's answer from a
    broadcast over it."""

    def __init__(self, seconds: float, group=None):
        self.seconds = seconds
        self.group = group
        self._flag = torch.zeros(1, dtype=torch.int32) if group is not None else None

    def __call__(self, t0: float) -> bool:
        over = time.perf_counter() - t0 >= self.seconds
        if self.group is None:
            return over
        self._flag[0] = int(over)  # what rank 0 sends; the others' is overwritten
        dist.broadcast(self._flag, src=0, group=self.group)
        return bool(self._flag[0])


@dataclasses.dataclass
class Member:
    """This process's place in a run's world of k ranks."""

    rank: int
    k: int
    device: str
    group: object  # gloo, on the host: the window's end, barriers, the readings

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def gather(self, item: dict) -> Optional[List[dict]]:
        """Every rank's ``item``, in rank order, on rank 0; ``None`` elsewhere."""
        out = [None] * self.k if self.rank == 0 else None
        dist.gather_object(item, out, dst=0, group=self.group)
        return out

    def leave(self) -> None:
        dist.destroy_process_group()


def _die_with(parent: int) -> None:
    """Ask the kernel to kill this process when ``parent`` (rank 0) ends."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong, ctypes.c_ulong,
                           ctypes.c_ulong]
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) refused")
    if os.getppid() != parent:  # rank 0 ended before the request was made
        os._exit(FAILED)


def join(rank: int, world_dir: str) -> Member:
    """Join the world that rank 0 described in ``world_dir``."""
    with open(os.path.join(world_dir, "world.json")) as f:
        w = json.load(f)
    if rank:
        _die_with(w["parent"])
    torch.set_num_threads(w["threads"])
    k = w["k"]
    kw = {}
    if w["device"] == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    else:
        dev = torch.device("cpu")
    store = dist.FileStore(os.path.join(world_dir, "store"), k)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store, rank=rank,
                            world_size=k, timeout=PG_TIMEOUT, **kw)
    group = dist.new_group(backend="gloo", timeout=PG_TIMEOUT)
    return Member(rank=rank, k=k, device=str(dev), group=group)


class Ranks:
    """Rank 0's side: ranks 1 … k−1 started as children of ``script`` with
    ``argv``, and the thread that ends the run when one fails or the run
    passes ``WALL_S`` (read when the ranks start), counted from ``t0``,
    rank 0's start."""

    def __init__(self, script: Path, argv: Sequence[str], k: int, device: str, t0: float):
        self.k, self.t0, self.wall_s = k, t0, WALL_S
        self.dir = tempfile.mkdtemp(prefix="perfbench_ranks_")
        threads = max(1, len(os.sched_getaffinity(0)) // k)
        with open(os.path.join(self.dir, "world.json"), "w") as f:
            json.dump({"k": k, "device": torch.device(device).type, "parent": os.getpid(),
                       "threads": threads}, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p),
                   OMP_NUM_THREADS=str(threads))
        self.procs: List[subprocess.Popen] = []
        for r in range(1, k):
            with open(self._file(r, "out"), "w") as out, open(self._file(r, "err"), "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(script), *argv, "--rank", str(r), "--world", self.dir],
                    stdout=out, stderr=err, env=env))
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watching, name="perfbench-ranks",
                                       daemon=True)
        self._watch.start()

    def _file(self, rank: int, what: str) -> str:
        return os.path.join(self.dir, f"rank{rank}.{what}")

    def _failed(self) -> List[int]:
        """The children that have ended nonzero."""
        return [r for r, p in enumerate(self.procs, start=1) if p.poll() not in (None, 0)]

    def _exited(self, rank: int) -> str:
        return f"rank {rank} of {self.k} exited with {self.procs[rank - 1].returncode}"

    def _watching(self) -> None:
        while not self._done.wait(0.1):
            bad = self._failed()
            if bad:
                self._end(self._exited(bad[0]), bad)
            if time.perf_counter() - self.t0 > self.wall_s:
                alive = [r for r, p in enumerate(self.procs, start=1) if p.poll() is None]
                self._end(f"the run passed its wall-clock limit of {self.wall_s} s; "
                          f"ranks still running: 0 {' '.join(map(str, alive))}", alive)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _report(self, why: str, ranks: Sequence[int]) -> None:
        for r in ranks:
            tail = Path(self._file(r, "err")).read_text(errors="replace")[-_TAIL:]
            print(f"--- rank {r} of {self.k}, the end of its standard error:\n{tail}",
                  file=sys.stderr)
        print(f"{why}: every rank killed, no result", file=sys.stderr, flush=True)

    def _end(self, why: str, ranks: Sequence[int], *, traceback: str = "") -> None:
        """Kill every rank, name ``ranks`` and ``why``, and end this process
        with ``FAILED``; the first caller does, any later one waits for it."""
        with self._lock:
            if self._done.is_set():
                return
            self._done.set()
            self._kill()
            print(traceback, file=sys.stderr, end="")
            self._report(why, ranks)
            shutil.rmtree(self.dir, ignore_errors=True)
            os._exit(FAILED)

    def fail(self, traceback: str) -> None:
        """Rank 0 raised (``traceback``): end the run.  Where a child ended
        nonzero first, and rank 0's collective failed with it, the child is
        the one named."""
        deadline = time.monotonic() + 2.0
        while not self._failed() and time.monotonic() < deadline:
            time.sleep(0.05)
        bad = self._failed()
        if bad:
            self._end(self._exited(bad[0]), bad, traceback=traceback)
        last = traceback.strip().splitlines()[-1] if traceback.strip() else "?"
        self._end(f"rank 0 of {self.k} raised {last}", [], traceback=traceback)

    def finish(self) -> None:
        """Wait for every child to end; any that ends nonzero ends the run."""
        for p in self.procs:
            p.wait()
        with self._lock:
            bad = self._failed()
            if not bad:
                self._done.set()
        if bad:
            self._end(self._exited(bad[0]), bad)
        self._watch.join()
        shutil.rmtree(self.dir, ignore_errors=True)

"""Run a function on k ranks of a fresh ``torch.distributed`` world.

:func:`run_ranks` starts k processes of ``python -m
repro_torch.parallel.launch``, one per rank, which meet through a
``FileStore`` in a temporary directory (gloo on the CPU, NCCL on cards:
rank r on ``cuda:r``), call ``target(payload)`` with the world up, and end
the world.  Rank 0 prints the function's JSON-able result on a ``RESULT``
line; :func:`run_ranks` returns it.  Every process group has an explicit
timeout and the whole run a wall-clock one, after which every rank is
killed and :func:`run_ranks` raises: a rank that waits forever cannot
hang its caller.  Each rank runs one intra-op thread.

``target`` is ``"package.module:function"`` or ``"path/to/file.py:function"``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Any, Dict

_SRC = str(Path(__file__).resolve().parents[2])


def run_ranks(
    target: str,
    k: int,
    payload: Dict[str, Any],
    *,
    device: str = "cpu",
    timeout: float = 300.0,
) -> Dict[str, Any]:
    """Run ``target(payload)`` on ``k`` ranks; return rank 0's result."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    env.update(
        WORLD_SIZE=str(k),
        REPRO_TORCH_STORE=os.path.join(tmp, "store"),
        REPRO_TORCH_DEVICE=device,
        OMP_NUM_THREADS="1",
    )
    procs = []
    try:
        for r in range(k):
            out = open(os.path.join(tmp, f"rank{r}.out"), "w")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w")
            procs.append(
                (
                    subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.parallel.launch", target,
                         json.dumps(payload)],
                        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                        stdout=out,
                        stderr=err,
                    ),
                    out,
                    err,
                )
            )
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p, _, _ in procs):
            if time.monotonic() > deadline:
                failed = (0, "timeout")
                break
            for r, (p, _, _) in enumerate(procs):
                if p.poll() not in (None, 0):
                    failed = (r, p.returncode)
                    break
            time.sleep(0.05)
        if failed is None:
            failed = next(((r, p.returncode) for r, (p, _, _) in enumerate(procs)
                           if p.returncode != 0), None)
        if failed is not None:
            for p, _, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            r, rc = failed
            tail = Path(tmp, f"rank{r}.err").read_text()[-3000:]
            raise RuntimeError(f"rank {r} of {k} ended with {rc} running {target}:\n{tail}")
        for line in reversed(Path(tmp, "rank0.out").read_text().splitlines()):
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
        raise RuntimeError(f"rank 0 printed no RESULT line running {target}")
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _resolve(target: str):
    mod, _, fn = target.rpartition(":")
    if mod.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(mod).stem, mod)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod)
    return getattr(module, fn)


def _main(target: str, payload: str) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.mesh import PG_TIMEOUT, backend_for

    torch.set_num_threads(1)
    rank, k = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(os.environ.get("REPRO_TORCH_DEVICE", "cpu"))
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.environ["REPRO_TORCH_STORE"], k)
    dist.init_process_group(
        backend_for(dev), store=store, rank=rank, world_size=k,
        timeout=min(PG_TIMEOUT, timedelta(seconds=120)),
    )
    try:
        result = _resolve(target)(json.loads(payload))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print("RESULT " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1], sys.argv[2]))

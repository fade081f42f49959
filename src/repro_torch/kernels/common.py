"""Shared kernel plumbing: block arithmetic, launch counters, the C build.

The CUDA kernels under ``repro_torch/csrc/`` have a plain C interface.
:func:`load_library` compiles one source with ``nvcc`` for ``sm_90a`` into
a shared library under ``<repo>/build/kernels/`` on first use (keyed by a
hash of the source, the ``csrc/`` headers it includes and the flags, so
an edited source or header never reuses a stale build) and opens it with
``ctypes``.  Nothing is compiled at import time: this module imports on
machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def widest_vector(elem: int, lengths, ptrs) -> int:
    """Elements per lane of the widest access of at most 16 bytes that
    every row length (in elements) and every address (in bytes) keep
    aligned: 4/2/1 in f32, 8/4/2/1 in bf16."""
    vec = 16 // elem
    while vec > 1 and (any(n % vec for n in lengths) or any(p % (vec * elem) for p in ptrs)):
        vec //= 2
    return vec


def pick_block(dim: int, preferred: int, align: int = 8) -> int:
    """Largest hardware-friendly block ≤ preferred that keeps the grid
    covering ``dim`` without a ragged tail when possible."""
    if dim <= preferred:
        return round_up(dim, align) if dim % align else dim
    b = preferred
    while b > align and dim % b:
        b -= align
    return b if dim % b == 0 else preferred


class LaunchCounter:
    """Counts the launches of one CUDA kernel (not its plain version)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


class BuiltLibrary:
    """One compiled kernel library plus what ``nvcc`` said building it."""

    def __init__(self, path: Path, log: str, seconds: float = 0.0):
        self.path = path
        self.log = log  # -Xptxas -v register / shared-memory report
        self.seconds = seconds  # this build's nvcc wall time (0: an earlier build's)
        self.cdll = ctypes.CDLL(str(path))


_LIBS: Dict[str, BuiltLibrary] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _local_headers(source: str) -> List[str]:
    """Every ``csrc/`` header that ``source`` includes, directly or not."""
    seen: List[str] = []
    todo = [source]
    while todo:
        text = (CSRC_DIR / todo.pop()).read_bytes()
        for name in _LOCAL_INCLUDE.findall(text):
            name = name.decode()
            if name not in seen and (CSRC_DIR / name).exists():
                seen.append(name)
                todo.append(name)
    return sorted(seen)


def _target(source: str) -> Path:
    """The build's path, keyed by the source, its local headers and flags."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for name in _local_headers(source):
        h.update(name.encode() + b"\0" + (CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def _nvcc_command(source: str, out: Path) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / source)]


def build_all(sources: List[str]) -> Dict[str, BuiltLibrary]:
    """Compile every source not built yet, one ``nvcc`` each, in parallel."""
    with _LOCK:
        todo = [s for s in sources if s not in _LIBS]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for src in todo:
            out = _target(src)
            if out.exists():
                log = out.with_suffix(".log")
                text = log.read_text() if log.exists() else ""
                _LIBS[src] = BuiltLibrary(out, text)
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            procs[src] = (
                subprocess.Popen(
                    _nvcc_command(src, tmp),
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp,
                out,
            )

        def finish(src):  # one thread per nvcc, so each build's own wall is timed
            log, _ = procs[src][0].communicate()
            return log, time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=max(1, len(procs))) as pool:
            done = dict(zip(procs, pool.map(finish, procs)))
        failed = []
        for src, (proc, tmp, out) in procs.items():
            log, seconds = done[src]
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            _LIBS[src] = BuiltLibrary(out, log, seconds)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return {s: _LIBS[s] for s in sources}


def load_library(source: str) -> BuiltLibrary:
    """The compiled library for one ``csrc/`` source (built on first use)."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = build_all([source])[source]
    return lib


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a C pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain-version route)."""
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda_operand(name: str, t, *, device, dtypes, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor the kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(name: str, err: int) -> None:
    """Raise if the C launcher reported a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


# int32 sizes and offsets inside the C launchers
MAX_INT32 = 2**31 - 1

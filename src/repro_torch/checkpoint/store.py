"""Atomic, resumable checkpointing of a tree of arrays.

Layout per step:
    <root>/step_<n>.tmp/          — written first
        leaf_00000.npy ...        — one file per tree leaf
        manifest.json             — treedef, leaf shapes, dtypes,
                                    step, wall-time, user metadata
    <root>/step_<n>/              — atomic rename after fsync

Guarantees:
  * a checkpoint directory either exists completely or not at all
    (rename is atomic; partial writes stay in ``.tmp``),
  * ``restore_latest`` skips corrupt/partial checkpoints,
  * ``keep_last`` garbage-collects old steps after a successful write,
  * async mode hands host copies of the arrays to a writer thread so the
    loop is not blocked by the filesystem; a tensor leaf is copied to the
    host on the caller's thread (never a view of live device state).

A tree is nested dicts (keys sorted, as the reference flattens them),
lists and tuples with array leaves (numpy arrays, torch tensors or
Python scalars); ``None`` is an empty subtree.  The manifest's treedef is
written in the reference's notation (``PyTreeDef({'F': *, ...})``), so
either package restores the other's steps.  Arrays are saved whole; on
restore, tensor leaves of the template go to ``device`` (default: the
template leaf's own), numpy leaves stay numpy, unless ``shardings`` (a
tree of :class:`repro_torch.parallel.mesh.MeshSharding` of the same
structure) places every leaf on a mesh as a ``DTensor``: each rank reads
the whole array and keeps its shard, so a step written on one device
restores onto any mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

_MANIFEST = "manifest.json"
_STOP = object()  # writer-thread shutdown sentinel (see close())


def _flatten(tree: PyTree) -> Tuple[List[Any], str]:
    """Leaves in the reference's order and the treedef in its notation."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in keys) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(x) for x in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(x) for x in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like: PyTree, leaves: List[Any]) -> PyTree:
    """``like``'s structure with its leaves replaced, in flatten order
    (dict keys come back sorted, as the reference's unflatten gives them)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(x) for x in node]
        if isinstance(node, tuple):
            return tuple(build(x) for x in node)
        return next(it)

    return build(like)


def _host(x) -> np.ndarray:
    """A host array for one leaf; a tensor is copied off its device (a
    ``DTensor`` gathered whole first: every rank of its mesh calls this)."""
    if isinstance(x, torch.Tensor):
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def _leaf_dtype(ref) -> np.dtype:
    if isinstance(ref, torch.Tensor):
        return torch.empty((), dtype=ref.dtype).numpy().dtype
    return np.dtype(getattr(ref, "dtype", None) or type(ref))


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep_last: int = 3
    async_write: bool = False

    def __post_init__(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._closed = False
        if self.async_write:
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True
            )
            self._writer.start()

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: PyTree,
             metadata: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot → (async) write.  Host copies happen on the caller's
        thread so the device buffers can be donated right after."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        leaves, treedef = _flatten(tree)
        host = [_host(x) for x in leaves]
        job = (step, host, treedef, metadata or {})
        if self.async_write:
            self._raise_pending()
            self._q.put(job)
        else:
            self._write(job)

    def wait(self) -> None:
        """Block until pending async writes are durable."""
        if self.async_write:
            self._q.join()
            self._raise_pending()

    def close(self) -> None:
        """Drain pending writes and join the writer thread.

        Without this the daemon writer dies with the interpreter and a
        queued snapshot may never hit disk.  Idempotent; ``save`` after
        close raises.  A write error queued before close is re-raised
        here, like ``wait``.
        """
        if self._closed:
            return
        self._closed = True
        if self._writer is not None:
            self._q.put(_STOP)
            self._writer.join()
            self._writer = None
        self._raise_pending()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _writer_loop(self) -> None:
        while True:
            job = self._q.get()
            if job is _STOP:
                self._q.task_done()
                return
            try:
                self._write(job)
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, job) -> None:
        step, host, treedef_str, metadata = job
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "treedef": treedef_str,
            "time": time.time(),
            "metadata": metadata,
            "leaves": [],
        }
        for i, arr in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"file": fname, "shape": list(arr.shape),
                 "dtype": str(arr.dtype)}
            )
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    # -------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name, _MANIFEST)):
                    try:
                        out.append(int(name.split("_", 1)[1]))
                    except ValueError:
                        continue
        return sorted(out)

    def manifest(self, step: int) -> Dict[str, Any]:
        """The parsed manifest of a step (leaves, treedef, metadata)."""
        with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
            return json.load(f)

    def restore(
        self,
        step: int,
        like: PyTree,
        device: Optional[Any] = None,
        *,
        cast: bool = False,
        shardings: Optional[PyTree] = None,
    ) -> PyTree:
        """Restore into the structure of ``like`` (treedef, shape and
        dtype all validated against the manifest).

        Tensor leaves of ``like`` come back as tensors on ``device`` (by
        default the template leaf's own), other leaves as numpy arrays.
        A dtype mismatch is an error — a checkpoint is a bit-exact record,
        not a conversion source; pass ``cast=True`` to opt into an
        explicit ``astype`` (e.g. restoring bf16 storage into f32).
        ``shardings`` (same structure as ``like``, ``MeshSharding``
        leaves) restores every leaf as a ``DTensor`` on its mesh instead;
        every rank of the mesh must call it.
        """
        d = self._step_dir(step)
        manifest = self.manifest(step)
        leaves_like, treedef = _flatten(like)
        if len(manifest["leaves"]) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"target structure has {len(leaves_like)}"
            )
        saved_treedef = manifest.get("treedef")
        if saved_treedef is not None and saved_treedef != treedef:
            raise ValueError(
                f"checkpoint treedef {saved_treedef} does not match "
                f"target structure {treedef}"
            )
        placed = [None] * len(leaves_like)
        if shardings is not None:
            placed, _ = _flatten(shardings)
            if len(placed) != len(leaves_like):
                raise ValueError(
                    f"shardings has {len(placed)} leaves, target structure has "
                    f"{len(leaves_like)}"
                )
        out = []
        for rec, ref, sharding in zip(manifest["leaves"], leaves_like, placed):
            arr = np.load(os.path.join(d, rec["file"]))
            if tuple(arr.shape) != tuple(np.shape(ref)):
                raise ValueError(
                    f"{rec['file']}: shape {arr.shape} != {tuple(np.shape(ref))}"
                )
            ref_dtype = _leaf_dtype(ref)
            if arr.dtype != ref_dtype:
                if not cast:
                    raise ValueError(
                        f"{rec['file']}: dtype {arr.dtype} != {ref_dtype} "
                        "(pass cast=True to convert explicitly)"
                    )
                arr = arr.astype(ref_dtype)
            if sharding is not None:
                from repro_torch.parallel.mesh import distribute

                arr = distribute(torch.from_numpy(arr), sharding)
            elif isinstance(ref, torch.Tensor):
                arr = torch.from_numpy(arr).to(
                    ref.device if device is None else device
                )
            out.append(arr)
        return _unflatten(like, out)

    def restore_latest(
        self,
        like: PyTree,
        device: Optional[Any] = None,
        *,
        cast: bool = False,
        shardings: Optional[PyTree] = None,
    ) -> Tuple[Optional[int], Optional[PyTree]]:
        for step in reversed(self.steps()):
            try:
                return step, self.restore(
                    step, like, device, cast=cast, shardings=shardings
                )
            except Exception:  # noqa: BLE001 — corrupt ckpt: try older
                continue
        return None, None

    def restore_flat(
        self, step: int
    ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """Restore a step as a flat leaf list + its user metadata.

        No ``like`` template: shapes/dtypes come from the manifest.  This
        is the path for snapshots whose geometry the reader cannot know up
        front (e.g. the serve tier's variable-size cache snapshot).
        """
        d = self._step_dir(step)
        manifest = self.manifest(step)
        leaves = [
            np.load(os.path.join(d, rec["file"]))
            for rec in manifest["leaves"]
        ]
        return leaves, manifest.get("metadata", {})

    def restore_latest_flat(
        self,
    ) -> Tuple[Optional[int], Optional[List[np.ndarray]], Dict[str, Any]]:
        for step in reversed(self.steps()):
            try:
                leaves, meta = self.restore_flat(step)
                return step, leaves, meta
            except Exception:  # noqa: BLE001 — corrupt ckpt: try older
                continue
        return None, None, {}

    # ------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

"""Checkpoint and restore for trees of torch tensors (the fault-tolerance
layer), in the reference package's file format.

* ``save_checkpoint``   — copies leaves to host numpy, writes one .npz
                          atomically (tmp + fsync + os.replace), records the
                          step, a JSON manifest (leaf dtypes and shapes, what
                          validation checks against the template tree) and
                          an optional pickled *runtime* payload (sampler RNG
                          boundary states, online-manager hotness, store
                          residency).
* ``restore_checkpoint``— validates the manifest against a template tree
                          (clear errors instead of a cryptic unflatten
                          failure), loads, and puts every leaf on its
                          template leaf's device with its dtype.
* ``latest_resumable_checkpoint`` — newest checkpoint that actually loads
                          and validates; torn or partial files (a crash mid-
                          write, a truncated copy) are skipped, not picked.
* ``AsyncCheckpointer`` — background-thread writer so the train loop never
                          blocks on persistence.  Write failures retry
                          (bounded), are tallied for telemetry
                          (``fault.checkpoint_write_errors`` /
                          ``recovery.checkpoint_retries``), and an exhausted
                          failure re-raises on ``close()``.

The file is the reference's, byte for byte in meaning: ``leaf_{i}`` in JAX's
flatten order (tuples and lists in order, dicts by sorted key, ``None`` an
empty subtree), ``__step``, ``__manifest`` (JSON, numpy dtype names) and
``__runtime`` (a pickle of plain dicts and numpy arrays), so a file written
by either package restores in the other.  A Python ``int`` leaf (AdamW's
step ``count``, a 0-d int32 array in the reference) is written as a 0-d
``int32`` and restored as an ``int``; a Python ``float`` as a 0-d
``float32``.  A leaf numpy cannot hold (bfloat16) raises
:class:`CheckpointError` naming it: it is never cast.
"""
from __future__ import annotations

import json
import os
import pickle
import queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_VERSION = 1

# torch dtypes numpy holds, by their numpy names (the manifest's names)
_NUMPY_NAME = {torch.float64: "float64", torch.float32: "float32",
               torch.float16: "float16", torch.int64: "int64",
               torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
               torch.uint8: "uint8", torch.bool: "bool"}


class CheckpointError(RuntimeError):
    """A checkpoint file is torn, truncated, or does not match the
    template tree it is being restored into."""


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's ``tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in _flatten(t, f"{path}[{i}]")]
    return [(path or "<root>", tree)]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def _leaf_spec(path: str, leaf) -> Tuple[str, list]:
    """The manifest's (numpy dtype name, shape) for a template leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NUMPY_NAME:
            raise CheckpointError(f"leaf {path}: dtype {leaf.dtype} has no "
                                  "numpy counterpart (it is never cast)")
        return _NUMPY_NAME[leaf.dtype], list(leaf.shape)
    return str(_host_leaf(path, leaf).dtype), list(np.shape(leaf))


def _host_leaf(path: str, leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own dtype; a tensor is copied,
    so the writer never shares memory with the caller's tensors."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NUMPY_NAME:
            raise CheckpointError(f"leaf {path}: dtype {leaf.dtype} has no "
                                  "numpy counterpart (it is never cast)")
        return leaf.detach().to("cpu", copy=True).numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, dtype=np.float32)
    return np.asarray(leaf)


def _to_host(tree: Any) -> Any:
    """``tree`` with every leaf a host numpy array (see ``_host_leaf``):
    the copy ``AsyncCheckpointer.save`` makes on the caller's thread, so
    its writer thread never touches a device."""
    it = iter([_host_leaf(p, x) for p, x in _flatten(tree)])
    return _unflatten(tree, it)


def _to_u8(payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, dtype=np.uint8)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    runtime: Optional[dict] = None,
                    fault_hook: Optional[Callable[[str], None]] = None) -> str:
    """Atomic write: tmp file + fsync + ``os.replace``, so a crash at any
    point leaves either the previous checkpoint or a complete new one —
    never a torn ``ckpt_*.npz``.  ``runtime`` is an arbitrary picklable
    dict stored alongside the leaves (``restore_checkpoint(...,
    with_runtime=True)`` returns it).  ``fault_hook`` runs after the tmp
    write, before the publish: the injection point that simulates a crash
    mid-save."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    arrays = {f"leaf_{i}": _host_leaf(p, x)
              for i, (p, x) in enumerate(_flatten(tree))}
    n = len(arrays)
    manifest = {"version": MANIFEST_VERSION, "step": int(step),
                "n_leaves": n,
                "leaves": [{"dtype": str(arrays[f"leaf_{i}"].dtype),
                            "shape": list(arrays[f"leaf_{i}"].shape)}
                           for i in range(n)]}
    arrays["__step"] = np.asarray(step)
    arrays["__manifest"] = _to_u8(json.dumps(manifest).encode())
    if runtime is not None:
        arrays["__runtime"] = _to_u8(pickle.dumps(runtime))
    path = ckpt_dir / f"ckpt_{step:08d}.npz"
    tmp = ckpt_dir / f".tmp_ckpt_{step:08d}.npz"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        if fault_hook is not None:
            fault_hook(str(tmp))
        os.replace(tmp, path)  # atomic publish
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return str(path)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    cands = sorted(d.glob("ckpt_*.npz"))
    return str(cands[-1]) if cands else None


def load_manifest(path: str) -> Optional[dict]:
    """The embedded manifest, or None for a pre-manifest checkpoint."""
    with np.load(path) as data:
        if "__manifest" not in data:
            return None
        return json.loads(bytes(data["__manifest"]).decode())


def validate_checkpoint(path: str, like: Any = None) -> dict:
    """Open and structurally check one checkpoint; returns its manifest
    (synthesized for pre-manifest files).  Raises :class:`CheckpointError`
    naming exactly what is wrong: unreadable or torn archive, missing
    leaves, step mismatch, or (with ``like``) leaf count, dtype or shape
    drift against the template tree (torch dtypes compared by their numpy
    names)."""
    try:
        with np.load(path) as data:
            keys = set(data.files)
            if "__step" not in keys:
                raise CheckpointError(f"{path}: no __step record "
                                      "(not a checkpoint or torn write)")
            step = int(data["__step"])
            n_leaves = sum(1 for k in keys if k.startswith("leaf_"))
            if "__manifest" in keys:
                manifest = json.loads(bytes(data["__manifest"]).decode())
            else:
                manifest = {"version": 0, "step": step, "n_leaves": n_leaves,
                            "leaves": None}
            if manifest["step"] != step:
                raise CheckpointError(
                    f"{path}: manifest step {manifest['step']} != stored "
                    f"step {step}")
            missing = [f"leaf_{i}" for i in range(manifest["n_leaves"])
                       if f"leaf_{i}" not in keys]
            if missing:
                raise CheckpointError(
                    f"{path}: missing leaves {missing} (partial write?)")
            if like is not None:
                leaves = _flatten(like)
                if manifest["n_leaves"] != len(leaves):
                    raise CheckpointError(
                        f"{path}: has {manifest['n_leaves']} leaves, "
                        f"template tree has {len(leaves)} — not the same "
                        "model/optimizer structure")
                if manifest["leaves"] is not None:
                    for i, (rec, (p, leaf)) in enumerate(
                            zip(manifest["leaves"], leaves)):
                        want_dtype, want_shape = _leaf_spec(p, leaf)
                        if rec["shape"] != want_shape \
                                or rec["dtype"] != want_dtype:
                            raise CheckpointError(
                                f"{path}: leaf {i} is "
                                f"{rec['dtype']}{rec['shape']}, template "
                                f"expects {want_dtype}{want_shape} ({p})")
            return manifest
    except CheckpointError:
        raise
    except Exception as e:  # zipfile/np.load errors on torn files
        raise CheckpointError(f"{path}: unreadable ({e})") from e


def latest_resumable_checkpoint(ckpt_dir: str,
                                like: Any = None) -> Optional[str]:
    """Newest checkpoint in ``ckpt_dir`` that validates (optionally
    against a template tree).  Torn, truncated or structurally mismatched
    files are skipped: resume picks the newest checkpoint that will
    actually load, not the newest filename."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    for p in sorted(d.glob("ckpt_*.npz"), reverse=True):
        try:
            validate_checkpoint(str(p), like=like)
        except CheckpointError:
            continue
        return str(p)
    return None


def _restore_leaf(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, bool):
        return bool(arr)
    if isinstance(leaf, int):
        return int(arr)
    if isinstance(leaf, float):
        return float(arr)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def restore_checkpoint(path: str, like: Any, *,
                       with_runtime: bool = False) -> tuple:
    """Returns ``(step, tree)``, or ``(step, tree, runtime)`` with
    ``with_runtime=True`` (``runtime`` is None when the checkpoint has no
    runtime payload), every tensor leaf on its template leaf's device with
    its dtype (``int``/``float`` leaves come back as Python numbers).  The
    manifest is validated first: a mismatched tree raises a clear
    :class:`CheckpointError`."""
    validate_checkpoint(path, like=like)
    with np.load(path) as data:
        step = int(data["__step"])
        leaves = [_restore_leaf(data[f"leaf_{i}"], leaf)
                  for i, (_, leaf) in enumerate(_flatten(like))]
        runtime = (pickle.loads(bytes(data["__runtime"]))
                   if with_runtime and "__runtime" in data.files else None)
    tree = _unflatten(like, iter(leaves))
    if not with_runtime:
        return step, tree
    return step, tree, runtime


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writer with a bounded queue (depth 1: a
    newer snapshot supersedes an unwritten older one).

    ``save()`` copies the tree to host numpy on the caller's thread (the
    reference's ``jax.device_get``), so the writer thread never touches a
    device.  A failed write retries in the worker (``retries`` extra
    attempts with a short backoff) and is tallied; if every attempt fails
    the exception is held and re-raised by ``close()``: background failures
    never vanish at shutdown.  ``fault_plan`` threads the chaos harness into
    the write path (site ``checkpoint_write``)."""

    def __init__(self, ckpt_dir: str, keep: int = 3, retries: int = 1,
                 fault_plan=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.retries = int(retries)
        self._fault_plan = fault_plan
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self.last_saved: Optional[str] = None
        # ---- monotonic tallies (publish_metrics mirrors these) ----
        self.saves = 0
        self.write_errors = 0
        self.retries_used = 0
        self._exc: Optional[BaseException] = None
        self._exc_raised = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def _fault_hook(self, step: int):
        if self._fault_plan is None:
            return None
        return lambda _tmp: self._fault_plan.raise_if("checkpoint_write",
                                                      step=step)

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, runtime = item
            for attempt in range(self.retries + 1):
                try:
                    self.last_saved = save_checkpoint(
                        self.ckpt_dir, step, tree, runtime=runtime,
                        fault_hook=self._fault_hook(step))
                    self._gc()
                    self.saves += 1
                    break
                except Exception as e:
                    self.write_errors += 1
                    if attempt < self.retries:
                        self.retries_used += 1
                        time.sleep(0.01 * (attempt + 1))
                        continue
                    # exhausted: hold for close() (a newer save may still
                    # succeed — last error wins, never silently dropped)
                    self._exc = e
                    self._exc_raised = False

    def _gc(self):
        cands = sorted(Path(self.ckpt_dir).glob("ckpt_*.npz"))
        for p in cands[: -self.keep]:
            p.unlink(missing_ok=True)

    def save(self, step: int, tree: Any, runtime: Optional[dict] = None):
        host_tree = _to_host(tree)
        try:
            self._q.put_nowait((step, host_tree, runtime))
        except queue.Full:
            try:
                self._q.get_nowait()  # drop the stale snapshot
            except queue.Empty:
                pass
            self._q.put_nowait((step, host_tree, runtime))

    def summary(self) -> dict:
        return {"saves": self.saves, "write_errors": self.write_errors,
                "retries_used": self.retries_used,
                "last_saved": self.last_saved}

    def publish_metrics(self, reg) -> None:
        reg.counter("checkpoint.saves").set_total(self.saves)
        reg.counter("fault.checkpoint_write_errors").set_total(
            self.write_errors)
        reg.counter("recovery.checkpoint_retries").set_total(
            self.retries_used)

    def close(self):
        """Drain and stop the worker.  Raises if the worker thread failed to
        join (a wedged write must not be silently abandoned) or if a write
        exhausted its retries and the failure was never surfaced."""
        self._q.put(None)
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError(
                "AsyncCheckpointer worker failed to stop within 30s "
                "(checkpoint write wedged?) — the last checkpoint may be "
                "stale")
        if self._exc is not None and not self._exc_raised:
            self._exc_raised = True
            raise self._exc

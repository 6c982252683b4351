"""Fault-tolerant checkpointing, ported from ``repro.checkpoint``.

* **Atomic**: leaves are written into ``step_<n>.tmp/`` and the directory is
  committed with a single ``rename`` after the manifest is fsynced: a crash
  mid-write never leaves a half checkpoint that restore would pick up.
* **Async**: ``CheckpointManager.save`` copies the tensors to host memory and
  hands serialization to a background thread; the train loop resumes at once.
* **Keep-k** retention, **auto-resume** from the newest valid manifest (a torn
  manifest is skipped).
* **Restore onto a device**: leaves are loaded on the host and moved to the
  given device, or to each target leaf's device, so a checkpoint taken on the
  card restores on the CPU and back.

Each leaf is one ``.npy`` file.  numpy has no bfloat16, so a bf16 tensor is
stored as its int16 bit pattern and the manifest records its dtype.  The
manifest's ``paths`` (the tree's leaf paths, in order) take the place of the
reference's serialized treedef.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_MANIFEST = "manifest.json"

#: dtypes a leaf may have (numpy holds each of them, bf16 as its int16 bits)
_DTYPES = frozenset({"float32", "float64", "bfloat16", "float16", "int32", "int64", "bool"})


def _path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(tree: Any) -> list[tuple[str, str, np.ndarray]]:
    """(path, dtype name, numpy array) per leaf: a host copy of every tensor."""
    out = []
    for path, leaf in T.leaves_with_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"checkpoint leaves are tensors; {_path_str(path)} is {type(leaf)}")
        if hasattr(leaf, "placements"):  # a DTensor: this rank's shard
            leaf = leaf.to_local()
        t = leaf.detach().to("cpu", copy=True)  # a snapshot, whatever later changes the leaf
        name = _dtype_name(t)
        if name not in _DTYPES:
            raise TypeError(f"no checkpoint format for {t.dtype} ({_path_str(path)})")
        a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        out.append((_path_str(path), name, a))
    return out


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the committed directory."""
    return _write(directory, step, _to_host(tree))


def _write(directory: str, step: int, host: list[tuple[str, str, np.ndarray]]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "paths": [p for p, _, _ in host]}
    for i, (p, dtype, a) in enumerate(host):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), a)
        manifest["leaves"].append(
            {"path": p, "file": fname, "shape": list(a.shape), "dtype": dtype}
        )
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # the commit point
    return final


def latest_step(directory: str) -> int | None:
    """Newest step with a committed (valid-manifest) checkpoint."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            mpath = os.path.join(directory, name, _MANIFEST)
            if os.path.exists(mpath):
                try:
                    with open(mpath) as f:
                        json.load(f)
                    steps.append(int(name[len("step_"):]))
                except (json.JSONDecodeError, ValueError):  # torn write: skip
                    continue
    return max(steps) if steps else None


def _load_leaf(d: str, entry: dict) -> torch.Tensor:
    a = np.load(os.path.join(d, entry["file"]))
    t = torch.from_numpy(a)
    if entry["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    if list(t.shape) != entry["shape"] or _dtype_name(t) != entry["dtype"]:
        raise ValueError(f"leaf {entry['path']} does not match its manifest entry")
    return t


def restore(
    directory: str,
    step: int | None = None,
    *,
    target: Any | None = None,
    device: str | torch.device | None = None,
) -> tuple[int, Any]:
    """Restore (step, tree).  ``target`` (a tree of tensors) gives the structure;
    each leaf goes to ``device``, or to the device of its target leaf."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    if target is None:
        raise ValueError("restore requires a target tree for structure")
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    targets = list(T.leaves_with_paths(target))
    paths = [_path_str(p) for p, _ in targets]
    if paths != manifest["paths"]:
        raise ValueError(f"checkpoint {d} holds another tree than the target")
    leaves = []
    for entry, (_, tgt) in zip(manifest["leaves"], targets):
        dev = device if device is not None else tgt.device
        t = _load_leaf(d, entry).to(dev)
        if hasattr(tgt, "placements"):  # a DTensor target: the file holds this rank's shard
            from torch.distributed.tensor import DTensor

            t = DTensor.from_local(t, tgt.device_mesh, tgt.placements, run_check=False,
                                   shape=tgt.shape, stride=tgt.stride())
        leaves.append(t)
    return step, T.unflatten(target, leaves)


class CheckpointManager:
    """Async save + keep-k retention + auto-resume."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        if self._error is not None:  # surface background failures
            raise self._error
        self.wait()  # at most one in-flight save
        host = _to_host(tree)

        def work():
            try:
                _write(self.directory, step, host)
                self._gc()
            except BaseException as e:  # pragma: no cover
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error

    def _gc(self) -> None:
        steps = sorted(
            int(n[len("step_"):])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore_latest(self, target: Any, device: str | torch.device | None = None):
        self.wait()
        return restore(self.directory, target=target, device=device)

    def has_checkpoint(self) -> bool:
        return latest_step(self.directory) is not None

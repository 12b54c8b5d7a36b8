"""Atomic, keep-K checkpointing with async saves (port of
``repro/checkpoint/manager.py``, one device).

The protocol is the reference's: a save writes ``step_<n>.tmp/`` and
renames it into place after a ``DONE`` marker, so a crash mid-save never
corrupts the latest checkpoint; ``latest_step`` finds the newest finished
one; the oldest beyond ``keep`` are removed; ``save(..., blocking=False)``
takes the host copy on the caller and hands the write to a thread; restore
checks each leaf's shape against a template tree.

The layout is the reference's too: ``arrays.npz`` keyed by the ``/``-joined
tree paths (``step``, ``master/segment0/sub0/attn/wq``, ...) and
``meta.json`` with ``step``, ``extra`` and a ``dtypes`` map of the leaves
stored as a same-width integer view (bf16 as uint16), so a checkpoint
restores across the two packages in both directions.  The template is a
tree of tensors, usually built on the ``meta`` device (shapes and dtypes,
nothing allocated).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_VIEWS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16)}


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in tree order; NamedTuples by field name, dicts by
    key, lists / tuples by index."""
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(tree, leaves):
    """A tree shaped as ``tree`` with leaves from the iterator ``leaves``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(t: torch.Tensor):
    """(array, dtype name for the map or None): a host copy on every device
    (``.cpu()`` of a CPU tensor would share its memory, which the next
    in-place optimizer step overwrites while an async save writes it)."""
    t = t.detach()
    if t.dtype in _VIEWS:
        name, view, np_view = _VIEWS[t.dtype]
        return t.view(view).to("cpu", copy=True).numpy().view(np_view), name
    return t.to("cpu", copy=True).numpy(), None


def _from_numpy(arr: np.ndarray, saved: Optional[str]) -> torch.Tensor:
    if saved == "bfloat16":
        return torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
    if saved is not None:
        raise ValueError(f"unknown stored dtype {saved!r}")
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- discovery ----------------------------------------------------------
    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "DONE")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        flat, dtypes = {}, {}
        for key, leaf in _flatten_with_paths(tree):      # host copy on the caller
            flat[key], name = _to_numpy(leaf)
            if name is not None:
                dtypes[key] = name

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "extra": extra or {}, "dtypes": dtypes}, f)
            with open(os.path.join(tmp, "DONE"), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        self.wait()
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, target_tree: Any, step: Optional[int] = None,
                device=None) -> tuple:
        """Restore into the structure, shapes and dtypes of ``target_tree``
        (tensors, usually on the ``meta`` device).  Each leaf lands on
        ``device``, or on its template leaf's device when that is not
        ``meta``, else on the card.  Returns (tree, meta)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        saved = meta.get("dtypes", {})
        leaves = []
        with np.load(os.path.join(d, "arrays.npz")) as payload:
            for key, ref in _flatten_with_paths(target_tree):
                t = _from_numpy(payload[key], saved.get(key))
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: {tuple(t.shape)} vs {tuple(ref.shape)}")
                dev = device if device is not None else (
                    "cuda" if ref.device.type == "meta" else ref.device)
                leaves.append(t.to(device=dev, dtype=ref.dtype))
        return _unflatten(target_tree, iter(leaves)), meta

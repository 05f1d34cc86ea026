"""Checkpointing: async, atomic, integrity-checked, in the reference's format.

Port of ``repro/checkpoint/ckpt.py``, file for file: a checkpoint written by
the JAX package restores here and the other way round.

* **Format** — ``step_<n>.npz`` holds one array per leaf of a tree of
  dicts under its ``/``-joined path (``params/blocks/b0/attn/wq``,
  ``opt/mu/...``, ``opt/step``); a dotted ``state_dict`` key counts as a path
  (``blocks.b0.attn.wq`` is ``blocks/b0/attn/wq``).  bf16 goes in as its
  bits, a ``uint16`` view tagged ``"bfloat16"`` in the manifest, as the
  reference stores ``ml_dtypes`` arrays; the bits are taken through
  ``torch.Tensor.view``, so no ``ml_dtypes`` is needed.
* **Atomicity** — writes go to ``step_<n>.tmp.*`` then ``os.replace`` to the
  final name; a crash mid-write never corrupts the latest checkpoint.
* **Integrity** — the JSON manifest records each array's shape, dtype and
  zlib crc32; ``load_checkpoint`` verifies before restoring and falls back to
  the previous step on a torn or corrupt file.
* **Writer election** — in multi-host jobs exactly one host writes; election
  runs on the paper's ALock via the port's own
  :class:`repro_torch.coord.CoordinationService`.
* **Async** — the device→host copy happens on the caller thread,
  serialization and fsync on a background thread.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy (bf16 as its ``uint16`` bits), and its
    dtype's name."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(np.array(arr.view(np.int16))).view(torch.bfloat16)
    if arr.dtype.name != dtype_name:
        raise ValueError(f"cannot restore an array tagged {dtype_name!r} stored as {arr.dtype}")
    return torch.from_numpy(np.array(arr))


def _path(prefix: str, key) -> str:
    key = str(key).replace(".", "/")
    return f"{prefix}/{key}" if prefix else key


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a tree of dicts under their ``/``-joined paths."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        out.update(_flatten(val, _path(prefix, key)))
    return out


def _unflatten(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``like``'s structure, with each leaf taken from ``flat`` by its path."""
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, _path(prefix, k)) for k, v in like.items()}
    if prefix not in flat:
        raise KeyError(f"checkpoint missing array {prefix}")
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(
            f"shape mismatch for {prefix}: ckpt {tuple(arr.shape)} vs model {tuple(like.shape)}")
    return arr


def save_checkpoint(
    directory: str,
    step: int,
    state: Any,
    *,
    extra: Optional[Dict] = None,
    _async: bool = False,
) -> Optional[threading.Thread]:
    """Write ``state`` (a tree of tensors) for ``step``.  Returns the writer
    thread when ``_async`` (join it before exiting the process)."""
    os.makedirs(directory, exist_ok=True)
    flat, dtypes = {}, {}
    for k, v in _flatten(state).items():
        flat[k], dtypes[k] = _encode(torch.as_tensor(v))
    manifest = {
        "step": int(step),
        "extra": extra or {},
        "arrays": {
            k: {
                "shape": list(v.shape),
                "dtype": dtypes[k],
                "crc": zlib.crc32(np.ascontiguousarray(v).tobytes()),
            }
            for k, v in flat.items()
        },
    }

    def write():
        tmp = os.path.join(directory, f"step_{step:08d}.tmp.npz")
        final = os.path.join(directory, f"step_{step:08d}.npz")
        mtmp = os.path.join(directory, f"step_{step:08d}.tmp.json")
        mfinal = os.path.join(directory, f"step_{step:08d}.json")
        np.savez(tmp, **flat)
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        os.replace(mtmp, mfinal)

    if _async:
        t = threading.Thread(target=write, daemon=False)
        t.start()
        return t
    write()
    return None


def _available_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.endswith(".json") and name.startswith("step_") and ".tmp" not in name:
            steps.append(int(name[len("step_"):-len(".json")]))
    return sorted(steps)


def load_checkpoint(
    directory: str,
    like: Any,
    *,
    step: Optional[int] = None,
) -> Tuple[Any, int, Dict]:
    """Restore the newest (or given) verified checkpoint.

    ``like`` gives the target tree (leaves with a ``shape``: tensors of the
    live state will do); the result has its structure, with CPU tensors in
    the dtypes the file records.  Falls back to older steps if integrity
    verification fails.
    """
    steps = _available_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    for s in reversed(steps):
        try:
            with open(os.path.join(directory, f"step_{s:08d}.json")) as f:
                manifest = json.load(f)
            flat = {}
            with np.load(os.path.join(directory, f"step_{s:08d}.npz")) as data:
                for k, meta in manifest["arrays"].items():
                    arr = data[k]
                    if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc"]:
                        raise IOError(f"checksum mismatch for {k} at step {s}")
                    flat[k] = _decode(arr, meta["dtype"])
        except Exception:
            if s == steps[0]:
                raise
            continue  # torn/corrupt: fall back to the previous step
        return _unflatten(like, flat), s, manifest.get("extra", {})
    raise IOError("no verifiable checkpoint found")


class CheckpointManager:
    """Periodic async checkpoints with writer election + retention."""

    def __init__(
        self,
        directory: str,
        every: int = 200,
        keep: int = 3,
        svc=None,            # repro_torch.coord.CoordinationService
        host: int = 0,
        writer_home: int = 0,
    ):
        self.directory = directory
        self.every = max(1, every)
        self.keep = keep
        self.svc = svc
        self.host = host
        self.writer_home = writer_home
        self._proc = svc.host_process(host) if svc is not None else None
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, state, extra: Optional[Dict] = None) -> bool:
        if step % self.every != 0:
            return False
        if self.svc is not None:
            # Exactly one host wins the epoch election (paper's ALock inside).
            if not self.svc.elect("ckpt-writer", self._proc, epoch=step,
                                  home_host=self.writer_home):
                return False
        self.wait()  # never two in-flight writes
        # Retention first: listed after the write starts, a write that has
        # already landed would count as an old one (the reference's order,
        # which can leave one checkpoint where ``keep`` are due).
        self._gc()
        # save_checkpoint copies every leaf to the host before it returns.
        self._pending = save_checkpoint(
            self.directory, step, state, extra=extra, _async=True
        )
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        # One write is about to start: keep `keep - 1` of the existing
        # checkpoints so `keep` remain once it lands.
        if not self.keep:
            return
        steps = _available_steps(self.directory)
        keep_existing = max(self.keep - 1, 0)
        doomed = steps[:-keep_existing] if keep_existing else steps
        for s in doomed:
            for suffix in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.directory, f"step_{s:08d}{suffix}"))
                except OSError:
                    pass

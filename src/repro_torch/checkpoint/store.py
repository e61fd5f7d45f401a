"""Async, atomic checkpointing in the reference's layout
(``repro/checkpoint/store.py``), numpy-based, for trees of tensors.

Layout (one directory per step):
    ckpt_dir/step_000123/
        shard_00000.npz     # the leaves, named by their tree path
        MANIFEST.json       # each leaf's shape, dtype and crc32
        COMMIT              # written last: marks the checkpoint valid

Guarantees, as the reference's:
  * atomic visibility: a step is written under ``step_XXXXXX.tmp`` and
    renamed once ``COMMIT`` is in it; a directory without ``COMMIT`` is
    ignored, so a failure mid-write never corrupts a restore;
  * async: `save` copies the tensors to host memory at once (training may
    then overwrite them) and writes in a background thread; a failure of
    that thread is raised by the next `wait` or `save`;
  * integrity: `restore` checks every leaf's crc32 against the manifest;
  * retention: the last ``keep_last`` committed steps are kept.

A bf16 leaf is stored as its uint16 bits with ``"dtype": "bfloat16"`` in the
manifest: the reference's ``np.savez`` of an ml_dtypes array stores the same
bytes, so each package reads the other's checkpoints bit for bit. Reading
one back goes through ``torch``'s bf16 view of those bits; ``ml_dtypes`` is
not needed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.obs.trace import Stopwatch
from repro_torch.plan.units import nbytes
from repro_torch.sharding import fsdp, rules

#: the numpy type a tensor's type is stored as (bf16 aside)
_NP_OF = {torch.float32: np.float32, torch.int32: np.int32,
          torch.int64: np.int64}
BF16 = "bfloat16"


def to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` as a numpy array and its manifest dtype name;
    bf16 as its uint16 bits."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    return t.numpy(), np.dtype(_NP_OF[t.dtype]).name


def from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor a stored array holds under its manifest ``dtype``: bf16
    from its 16-bit words (whatever numpy type they were stored as)."""
    shape = arr.shape
    arr = np.ascontiguousarray(arr)              # at least 1-d
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(arr.view(np.dtype(dtype))).reshape(shape)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        #: seconds of the last host copy, and (bytes, seconds) of the last
        #: write
        self.last_snapshot_s: float | None = None
        self.last_write: tuple[int, float] | None = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False, *,
             shardings: Any = None, parallel=None) -> None:
        """Copy the tree to host memory now; write it to disk in a
        background thread (at once where ``blocking``).

        ``shardings`` (a tree of specs over ``parallel``'s mesh, as
        `repro_torch.sharding.fsdp.held_specs` makes them): the tree holds
        this rank's shards. Every rank of the mesh calls `save`; each leaf
        is gathered whole (`fsdp.gather_leaf_global`), one leaf at a time,
        and rank 0 alone copies it to the host and writes, so that the
        checkpoint holds global leaves, as the reference's does."""
        with Stopwatch() as sw:
            flat = T.flatten_with_keys(tree)
            if shardings is None:
                host = {k: to_numpy(v) for k, v in flat.items()}
            else:
                writer = not any(parallel.mesh.get_coordinate())
                host = {}
                for k, v in flat.items():
                    whole = fsdp.gather_leaf_global(
                        v, rules._at(shardings, k), parallel, "checkpoint")
                    if writer:
                        host[k] = to_numpy(whole)
                    del whole
                if not writer:
                    return
        self.last_snapshot_s = sw.s
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the writer; raise what it raised, if anything."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _write_guarded(self, step: int, host: dict) -> None:
        try:
            self._write(step, host)
        except Exception as exc:          # raised again by wait()
            self._error = exc

    def _write(self, step: int, host: dict[str, tuple[np.ndarray, str]]
               ) -> None:
        with Stopwatch() as sw:
            path = self._step_dir(step)
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_00000.npz"),
                     **{k: a for k, (a, _) in host.items()})
            manifest = {
                "step": step,
                "leaves": {k: {"shape": list(a.shape), "dtype": dt,
                               "crc32": zlib.crc32(a.tobytes())}
                           for k, (a, dt) in host.items()},
            }
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
            shutil.rmtree(path, ignore_errors=True)
            os.rename(tmp, path)
        self.last_write = (sum(nbytes(a.size, a.dtype.itemsize)
                               for a, _ in host.values()), sw.s)
        self._gc()

    # -------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def valid_steps(self) -> list[int]:
        steps = []
        if not os.path.isdir(self.dir):
            return steps
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def restore(self, step: int, like: Any, device=None, *,
                shardings: Any = None, mesh=None) -> Any:
        """The checkpoint of ``step`` in the structure of ``like`` (a tree
        of tensors, or of anything with a ``shape``), each leaf in its
        manifest dtype on ``device``, or on the ``like`` leaf's device
        where that is a tensor (else the CPU). With ``shardings`` (a tree
        of specs over ``mesh``) ``like`` is this rank's shards: each global
        leaf is cut to its shard on the host (`rules.shard_of`) before it
        moves, so a checkpoint restores onto any mesh the specs fit (the
        elastic restart). Raises `FileNotFoundError` for a step without
        ``COMMIT``, `IOError` on a checksum mismatch, `KeyError` for a
        missing leaf, `ValueError` for another shape."""
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, "COMMIT")):
            raise FileNotFoundError(f"checkpoint step {step} not committed")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "shard_00000.npz")) as data:
            stored = {k: data[k] for k in data.files}
        for key, meta in manifest["leaves"].items():
            got = zlib.crc32(np.ascontiguousarray(stored[key]).tobytes())
            if got != meta["crc32"]:
                raise IOError(f"checksum mismatch for {key} at step {step}")
        flat_like = T.flatten_with_keys(like)
        missing = set(flat_like) - set(stored)
        if missing:
            raise KeyError(f"checkpoint lacks leaves: {sorted(missing)[:5]}")
        values = []
        for key, leaf in flat_like.items():
            t = from_numpy(stored[key], manifest["leaves"][key]["dtype"])
            if shardings is not None:
                t = rules.shard_of(t, rules._at(shardings, key),
                                   rules.logical_dims(key, t.dim()), mesh)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch {key}: ckpt "
                                 f"{tuple(stored[key].shape)} vs expected "
                                 f"{tuple(leaf.shape)}")
            where = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            values.append(t.to(where))
        return T.unflatten_like(like, values)

    # ------------------------------------------------------------------ gc
    def _gc(self) -> None:
        steps = self.valid_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:06d}")

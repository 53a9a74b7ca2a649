"""Checkpointing with async save, the port of ``repro.checkpoint``.

Layout:  <dir>/step_<n>/
            manifest.json        — leaf paths, shapes, dtypes
            arrays.npz           — one entry per flattened leaf path

The format is the reference's, file for file: the same ``manifest.json``
text and the same ``arrays.npz`` members (names, dtypes, shapes, bytes)
for the same state, so either package restores the other's checkpoints.
Leaves are keyed as the reference's ``jax.tree_util`` paths print: dict
keys in sorted order, list and tuple items by index, and a
``NamedTuple`` field as ``.field`` (``.params/embed/tok``, ``.opt/count``,
``.step``).  A ``bfloat16`` tensor is written as the reference writes
one, as raw 2-byte entries under a ``<V2`` header (what ``np.savez``
makes of ml_dtypes' bfloat16) with ``"bfloat16"`` in the manifest;
neither package can restore such a leaf (``restore_checkpoint`` raises
``TypeError``), and no train state holds one (parameters are float32).

  * save is a host copy plus a background thread: the train loop only
    blocks on the *previous* save (double-buffering).  The host copy is
    taken before ``AsyncCheckpointer.save`` returns, so an in-place update
    of the live tensors after it cannot reach the file (a CPU tensor's
    ``.cpu()`` is the tensor itself, so the copy is explicit);
  * restore places every leaf on ``device=`` (one card: the reference's
    ``shardings=`` re-partition has no counterpart here);
  * atomicity via write-to-tmp + rename; ``latest_step`` only sees
    complete checkpoints;
  * keep_last_k garbage collection.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import map_with_keys


def _flatten(tree) -> Dict[str, Any]:
    """{key: leaf} in the reference's flatten order."""
    out: Dict[str, Any] = {}
    map_with_keys(out.__setitem__, tree)
    return out


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """The leaf as a host numpy array, and its dtype's name for the
    manifest (a bfloat16 tensor's bits as int16, named "bfloat16").  A
    CPU tensor's array shares its memory."""
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _savez(path: Path, arrays: Dict[str, Tuple[np.ndarray, str]]):
    """``np.savez(path, **arrays)``: stored zip64 members ``<key>.npy``,
    save that a bfloat16 leaf's header says ``<V2``, as ml_dtypes'
    bfloat16 makes the reference's say."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype != "bfloat16":
                    np.lib.format.write_array(fid, arr)
                    continue
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": "<V2", "fortran_order": False,
                          "shape": arr.shape})
                fid.write(np.ascontiguousarray(arr).tobytes())


def _host_copy(leaf):
    """A host copy of a leaf that no later in-place update reaches."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_checkpoint(ckpt_dir, step: int, state, *, keep_last: int = 3):
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f".tmp_step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {key: _host_array(leaf) for key, leaf in _flatten(state).items()}
    manifest = {"step": step, "leaves": {
        key: {"shape": list(arr.shape), "dtype": dtype}
        for key, (arr, dtype) in arrays.items()}}
    _savez(tmp / "arrays.npz", arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: Path, keep_last: int):
    steps = sorted(int(p.name.split("_")[1])
                   for p in ckpt_dir.glob("step_*"))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, step: int, target_state, *,
                       device: DeviceLike = "cuda"):
    """Restore into the structure of ``target_state``, every leaf a new
    tensor on ``device`` in the file's dtype (not the target's), as the
    reference's.  A leaf whose shape differs from the target's raises
    ``ValueError``; one written from bfloat16 (``|V2`` bytes) raises
    ``TypeError``, as the reference's ``device_put`` does."""
    dev = resolve_device(device)
    path = Path(ckpt_dir) / f"step_{step}"
    with np.load(path / "arrays.npz") as data:
        def restore(key, tgt):
            arr = data[key]
            shape = tuple(tgt.shape) if torch.is_tensor(tgt) \
                else np.shape(tgt)
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs target {shape}")
            if arr.dtype.kind == "V":
                raise TypeError(f"restore_checkpoint: {key} holds raw "
                                f"{arr.dtype.str} entries (a bfloat16 leaf), "
                                "which is not a valid array dtype")
            return torch.from_numpy(arr).to(dev)
        return map_with_keys(restore, target_state)


class AsyncCheckpointer:
    """Double-buffered background saver: `save` returns once it holds a
    host copy of the state; the next `save`/`wait` blocks until the
    previous write finished."""

    def __init__(self, ckpt_dir, keep_last: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state):
        self.wait()
        host_state = map_with_keys(lambda _, x: _host_copy(x), state)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_state,
                                keep_last=self.keep_last)
            except BaseException as e:   # surfaced on next wait()
                self._error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

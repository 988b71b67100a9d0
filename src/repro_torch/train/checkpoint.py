"""Fault-tolerant checkpointing (counterpart of ``repro.train.checkpoint``,
in its on-disk format, so a checkpoint of either package restores in the
other).

* ATOMIC: a checkpoint directory appears only complete: it is written to
  ``<dir>/tmp.<step>``, its manifest fsynced, then renamed to
  ``<dir>/step_<step>``.
* SELF-DESCRIBING: ``leaves.npz`` holds leaf ``i`` of the flattened tree
  as ``leaf_{i:05d}``; ``manifest.json`` holds ``step``, ``n_leaves``,
  ``shapes``, ``dtypes`` and ``extra`` (the data iterator's state).
  Leaves are flattened in JAX's order (:mod:`repro_torch.utils.tree`):
  the port's ``TrainState`` and the JAX package's flatten to the same 11
  leaves.
* PLACED ON RESTORE: each leaf goes to the device, and takes the dtype, of
  the matching leaf of ``like``.  bfloat16 leaves are stored as JAX stores
  them: their bits as 2-byte void (``|V2``), named ``bfloat16`` in the
  manifest.
* ROLLING: ``keep_last`` checkpoints are kept; on resume the newest
  readable one wins (a torn directory is skipped, not fatal).
* ELASTIC: a sharded state (``DTensor`` leaves) is saved in the same
  format, whole: each leaf gathered in turn on every rank (one leaf in
  memory at a time) and written by rank 0 alone, then the manifest
  fsynced, the directory renamed, and a barrier, so that no rank reads
  the directory before it is complete.  ``restore(..., shardings=)`` lays
  each leaf out on the CURRENT mesh, whatever mesh (or device) saved it:
  every rank reads the file and keeps its own piece.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import zipfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.sharding import full_tensor, is_dtensor
from repro_torch.utils.tree import tree_flatten, tree_unflatten

__all__ = ["save", "all_steps", "latest_step", "restore", "restore_latest"]

_STEP_RE = re.compile(r"^step_(\d+)$")
# what a torn or foreign checkpoint directory raises on restore
_UNREADABLE = (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile)


def _key(i: int) -> str:
    return f"leaf_{i:05d}"


# JAX writes a bfloat16 leaf as 2-byte void (numpy has no bfloat16), and
# its manifest names the dtype "bfloat16"; the port writes the same
_BF16_STORED = np.dtype("V2")


def _to_numpy(leaf: Any) -> np.ndarray:
    leaf = full_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_STORED)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_STORED else str(arr.dtype)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A stored leaf as a tensor; 2-byte void leaves are bfloat16 bits."""
    if arr.dtype == _BF16_STORED:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: dict | None = None, keep_last: int = 3) -> str:
    """Atomically write ``<ckpt_dir>/step_<step>``; prune old ones.  Every
    rank of a sharded ``tree`` calls this (the leaves are gathered);
    rank 0 writes."""
    leaves, _ = tree_flatten(tree)
    sharded = any(map(is_dtensor, leaves))
    writer = not sharded or dist.get_rank() == 0
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    shapes, dtypes = {}, {}
    # np.savez's layout, one leaf at a time: a stored zip of .npy entries
    with contextlib.ExitStack() as stack:
        zf = (stack.enter_context(zipfile.ZipFile(
            os.path.join(tmp, "leaves.npz"), "w", zipfile.ZIP_STORED,
            allowZip64=True)) if writer else None)
        for i, v in enumerate(leaves):
            arr = _to_numpy(v)
            if zf is not None:
                with zf.open(_key(i) + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(arr),
                                              allow_pickle=False)
            shapes[_key(i)] = list(arr.shape)
            dtypes[_key(i)] = _dtype_name(arr)
            del arr
    if writer:
        _write_final(ckpt_dir, tmp, final, step, len(leaves), shapes,
                     dtypes, extra, keep_last)
    if sharded:
        dist.barrier()
    return final


def _write_final(ckpt_dir, tmp, final, step, n_leaves, shapes, dtypes,
                 extra, keep_last) -> None:
    manifest = {
        "step": step,
        "n_leaves": n_leaves,
        "shapes": shapes,
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):      # re-save after resume: overwrite
        shutil.rmtree(final)
    os.rename(tmp, final)

    for s in all_steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    """Steps of the complete checkpoints (those with a manifest), sorted."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any,
            shardings: Any | None = None) -> tuple[Any, dict]:
    """Load ``step_<step>`` into the structure of ``like``: each leaf in
    the dtype of ``like``'s leaf, on its device, or, with ``shardings``
    (a tree of ``NamedSharding`` like ``like``), laid out on the current
    mesh (this rank keeps its piece).  Returns ``(tree, manifest
    extra)``; raises if the stored leaves do not match ``like`` in number
    or shape."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    refs, treedef = tree_flatten(like)
    if len(refs) != manifest["n_leaves"]:
        raise ValueError(f"step_{step}: {manifest['n_leaves']} leaves, "
                         f"expected {len(refs)}")
    places = (tree_flatten(shardings)[0] if shardings is not None
              else [None] * len(refs))
    out = []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for i, (ref, place) in enumerate(zip(refs, places)):
            arr = data[_key(i)]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"step_{step}: {_key(i)} has shape "
                                 f"{arr.shape}, expected {tuple(ref.shape)}")
            t = _from_numpy(arr).to(ref.dtype)
            out.append(place.place(t) if place is not None
                       else t.to(ref.device))
    return tree_unflatten(treedef, out), manifest.get("extra", {})


def restore_latest(ckpt_dir: str, like: Any, shardings: Any | None = None
                   ) -> tuple[Any, dict, int] | None:
    """Newest readable checkpoint as ``(tree, extra, step)``, or None.
    Torn or corrupt directories are skipped."""
    for step in reversed(all_steps(ckpt_dir)):
        try:
            tree, extra = restore(ckpt_dir, step, like, shardings)
            return tree, extra, step
        except _UNREADABLE as e:
            print(f"[ckpt] step_{step} unreadable ({e}); falling back")
    return None

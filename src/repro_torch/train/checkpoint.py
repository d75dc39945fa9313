"""Checkpointing: the train state <-> .npz with path-flattened keys + JSON
metadata, in the reference's own file format, so a checkpoint written by
either package restores in the other.

Keys are the reference's (``src/repro/train/checkpoint.py`` ``_flatten`` of
a JAX ``TrainState``): a NamedTuple's fields and a dict's keys joined by
"/", so a train state gives ``step``, ``params/...``, ``opt_state/step``,
``opt_state/m/...`` and ``opt_state/v/...``. A list in the tree (the
Evoformer's per-block parameters and moments, a decoder stage's layers)
is stored stacked along a leading axis, the reference's layer axis, as
``weights.params_to_numpy`` stacks it. A list of such lists (a decoder's
stages, which the reference keeps as a Python list of stacked stages) is
stored entry by entry under the reference's ``[i]`` keys
(``params/stages/[0]/...``). npz has no bf16 or fp8 codec: such leaves
are stored as fp32 (bf16 -> fp32 -> bf16 round-trips exactly) and cast
back on restore.

Crash-safe: writes land in a temp file (``.tmp_ckpt_*``) that is fsynced
and atomically ``os.replace``d into place — a writer killed mid-write (the
``checkpoint.save`` fault site simulates exactly this) leaves only temp
debris and never a torn file at a checkpoint name. Readers are defensive
anyway: ``latest_checkpoint`` validates candidates newest-first, skipping
AND garbage-collecting truncated/corrupt files instead of crashing on them,
and ``restore_checkpoint`` raises a typed ``CorruptCheckpointError`` rather
than an opaque zipfile traceback. Keeps the last ``keep`` checkpoints.
Restores into the example tree's structure, dtypes and devices: the step
counters, 0-d int32 tensors on the CPU, stay there.

Each leaf comes to the host with one copy; call ``save_checkpoint`` between
steps, outside any timed region (a train state is 12 bytes a parameter:
fp32 parameters and two fp32 moments).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
from typing import Callable

import numpy as np
import torch

from repro_torch.resilience.errors import CorruptCheckpointError
from repro_torch.resilience.faults import fire

_TMP_PREFIX = ".tmp_ckpt_"
# npz has no codec for these (the reference's list): stored as fp32, cast
# back on restore.
_WIDENED = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    return list(tree.items())


def _is_list_of_lists(tree) -> bool:
    return isinstance(tree, list) and bool(tree) and isinstance(tree[0], list)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in _WIDENED:
        return t.to("cpu", torch.float32).numpy()
    return t.cpu().numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    """Leaf key ("" for a leaf itself) -> numpy array."""
    if isinstance(tree, torch.Tensor):
        return {"": _host(tree)}
    if _is_list_of_lists(tree):
        return {f"[{i}]/{k}" if k else f"[{i}]": arr
                for i, t in enumerate(tree) for k, arr in _flatten(t).items()}
    if isinstance(tree, (list, tuple)) and not _is_namedtuple(tree):
        per = [_flatten(t) for t in tree]
        return {k: np.stack([p[k] for p in per]) for k in per[0]}
    flat = {}
    for name, sub in _items(tree):
        for k, arr in _flatten(sub).items():
            flat[f"{name}/{k}" if k else str(name)] = arr
    return flat


def _restore_like(example, get: Callable[[str], np.ndarray], key: str = ""):
    """``example``'s structure with each leaf read through ``get`` and cast
    to the leaf's dtype on the leaf's device."""
    join = lambda name: f"{key}/{name}" if key else str(name)
    if isinstance(example, torch.Tensor):
        arr = get(key)
        if tuple(arr.shape) != tuple(example.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(arr.shape)}, the state "
                             f"{tuple(example.shape)}")
        return torch.from_numpy(arr).to(device=example.device,
                                        dtype=example.dtype)
    if _is_list_of_lists(example):
        return [_restore_like(t, get, join(f"[{i}]"))
                for i, t in enumerate(example)]
    if isinstance(example, (list, tuple)) and not _is_namedtuple(example):
        return [_restore_like(t, lambda k, i=i: get(k)[i], key)
                for i, t in enumerate(example)]
    if _is_namedtuple(example):
        return type(example)(*(_restore_like(v, get, join(f))
                               for f, v in _items(example)))
    return {k: _restore_like(v, get, join(k)) for k, v in _items(example)}


def _valid_checkpoint(path: str) -> bool:
    """True iff ``path`` is a structurally intact npz (zip) archive — a
    truncated/torn file from a crashed writer fails the central-directory
    walk or a member CRC check."""
    try:
        with zipfile.ZipFile(path) as z:
            return z.testzip() is None
    except (zipfile.BadZipFile, OSError, EOFError):
        return False


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3,
                    metadata: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=_TMP_PREFIX,
                               suffix=".npz")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    for fault in fire("checkpoint.save", step=step):
        # Simulate the writer dying mid-write: truncate the temp file the
        # way an interrupted write would and crash BEFORE the atomic
        # publish — the previous checkpoint must stay the restorable one,
        # and the debris is GC'd by the next successful save.
        with open(tmp, "r+b") as f:
            f.truncate(max(os.path.getsize(tmp) // 2, 1))
        raise fault
    os.replace(tmp, path)
    meta = {"step": step}
    meta.update(metadata or {})
    fd, mtmp = tempfile.mkstemp(dir=directory, prefix=_TMP_PREFIX,
                                suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, path + ".json")
    _gc(directory, keep)
    return path


def _gc(directory: str, keep: int):
    ckpts = sorted(
        f for f in os.listdir(directory)
        if re.fullmatch(r"ckpt_\d+\.npz", f)
    )
    for old in ckpts[:-keep]:
        os.remove(os.path.join(directory, old))
        meta = os.path.join(directory, old + ".json")
        if os.path.exists(meta):
            os.remove(meta)
    # Temp debris from crashed writers (see the checkpoint.save fault site).
    for f in os.listdir(directory):
        if f.startswith(_TMP_PREFIX):
            os.remove(os.path.join(directory, f))


def latest_checkpoint(directory: str) -> str | None:
    """Newest *intact* checkpoint. Truncated/corrupt files (a writer that
    died mid-write, a torn copy) are skipped — and GC'd along with their
    metadata — instead of being returned or crashing the restore."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(
        f for f in os.listdir(directory)
        if re.fullmatch(r"ckpt_\d+\.npz", f)
    )
    for name in reversed(ckpts):
        path = os.path.join(directory, name)
        if _valid_checkpoint(path):
            return path
        os.remove(path)
        meta = path + ".json"
        if os.path.exists(meta):
            os.remove(meta)
    return None


def restore_checkpoint(path: str, example_tree):
    """Restore into example_tree's structure, casting to its leaf dtypes on
    its leaf devices. Raises ``CorruptCheckpointError`` (typed) on a
    truncated/corrupt file — use ``latest_checkpoint`` to fall back to the
    newest intact one — and ValueError where a leaf's shape differs from
    the example's."""
    if not _valid_checkpoint(path):
        raise CorruptCheckpointError(
            f"checkpoint {path} is truncated or corrupt; "
            f"latest_checkpoint() skips such files")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}   # each member read once
    return _restore_like(example_tree, arrays.__getitem__)

"""Checkpointing with atomic publish and keep-k retention.

The port of src/repro/checkpoint/checkpoint.py, over trees of nested
dicts, lists and tuples whose leaves are tensors (a model's parameters
and the optimizer state).  The on-disk layout is the reference's:

  * a checkpoint is a directory `step_XXXXXXXX/`, written as
    `step_XXXXXXXX.tmp/` and then renamed, so a crashed writer never
    leaves a half-written checkpoint under a step's name; `.tmp`
    directories are ignored;
  * `arrays.npz` holds one array per leaf (`a0`, `a1`, ...), and
    `manifest.json` the step and, per leaf, its `key` (the path of dict
    keys and list indices, joined by "/"), `idx`, `shape` and `dtype`;
    dict keys are visited in sorted order, as the reference's tree
    flattening visits them;
  * leaves are stored whole on the host, so a checkpoint written under
    any layout restores onto any device and any other layout (elastic
    resume): `shardings`, a tree of `dist.sharding.Placement`s (or None
    per leaf) shaped as `like`, restores each placed leaf as its rank's
    block on the placement's device, the port's counterpart of the
    reference's `device_put` with a sharding tree.  numpy has no
    bfloat16: a bf16 tensor is stored as its uint16 bits, with
    "bfloat16" as its manifest dtype.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> list:
    """[(key, tensor)] of the leaves of `tree`, in the reference's order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}{i}/")
        return out
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a "
                        f"{type(tree).__name__}, not a tensor")
    return [(prefix[:-1], tree)]


def _placements(shardings, like, prefix: str = "") -> dict:
    """{key: Placement} for the leaves of `like` that `shardings` places
    (a tree of the same structure whose leaves are Placements or None;
    None for a whole subtree places none of it)."""
    if shardings is None:
        return {}
    if isinstance(like, dict):
        out = {}
        for k in like:
            out.update(_placements(shardings[k], like[k], f"{prefix}{k}/"))
        return out
    if isinstance(like, (list, tuple)):
        out = {}
        for i, v in enumerate(like):
            out.update(_placements(shardings[i], v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: shardings}


def _unflatten(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, f"{prefix}{k}/") for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def save_pytree(path: str, tree, step: int | None = None) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    arrays = {}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _to_numpy(leaf)
        arrays[f"a{i}"] = arr
        manifest["leaves"].append({"key": key, "idx": i,
                                   "shape": list(arr.shape), "dtype": dtype})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def restore_pytree(path: str, like, device=None, shardings=None):
    """The checkpoint at `path` in the structure of `like`: each leaf a new
    tensor of the stored dtype and shape, on `device`, or where `device`
    is None on the device of `like`'s leaf under the same key.  A leaf
    that `shardings` places (see the module docstring) is restored as its
    placement's block, on the placement's device."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {entry["key"]: entry for entry in manifest["leaves"]}
    placed = _placements(shardings, like)
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in _flatten(like):
            if key not in by_key:
                raise KeyError(f"{path}: no leaf {key!r} in the checkpoint")
            entry = by_key[key]
            t = _from_numpy(data[f"a{entry['idx']}"], entry["dtype"])
            if placed.get(key) is not None:
                leaves[key] = placed[key].block(t)
            else:
                leaves[key] = t.to(leaf.device if device is None else device)
    return _unflatten(like, leaves)


class CheckpointManager:
    """keep-k retention + latest discovery over a checkpoint directory."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dirs(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append((int(name[5:]), os.path.join(self.dir, name)))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def save(self, step: int, tree) -> str:
        path = os.path.join(self.dir, f"step_{step:08d}")
        save_pytree(path, tree, step=step)
        for _, p in self._step_dirs()[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
        return path

    def restore_latest(self, like, device=None, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step:08d}")
        return step, restore_pytree(path, like, device, shardings)

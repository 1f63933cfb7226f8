"""Numpy-backed tree checkpoints: atomic, resumable, integrity-checked
(port of ``repro.checkpoint.store``, its layout unchanged).

Layout:  <dir>/step_<N>/
             manifest.json    - leaf count, shapes, dtypes, sha256 prefixes
             leaf_<i>.npy     - one file per leaf
         <dir>/step_<N>.tmp-<pid> during a write, renamed when complete.

Leaves are numbered in the JAX package's flatten order (dict keys sorted,
NamedTuple fields in order; ``repro_torch.tree``), and bfloat16 is stored
as its uint16 bits with ``"bfloat16"`` in the manifest, so a tree either
package wrote loads into the other.  A crash mid-write leaves only a
``.tmp-`` directory, which ``latest_step`` ignores and the next save
removes; ``keep`` complete steps are kept.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch import tree as tree_util


def _to_numpy(leaf):
    """-> (numpy array, logical dtype name); bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":             # ml_dtypes' bfloat16
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree, meta: dict | None = None,
                    keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = tree_util.leaves(tree)
    manifest = {
        "step": step,
        "treedef": f"repro_torch tree of {len(flat)} leaves",
        "num_leaves": len(flat),
        "meta": meta or {},
        "leaves": [],
    }
    for i, leaf in enumerate(flat):
        arr, logical_dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({
            "shape": list(arr.shape),
            "dtype": logical_dtype,
            "sha256_16": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)               # atomic publish

    # GC old checkpoints and stale tmp dirs
    steps = sorted(_complete_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    for name in os.listdir(directory):
        if ".tmp-" in name and not name.endswith(f"-{os.getpid()}"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    return final


def _complete_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return out


def latest_step(directory: str):
    steps = _complete_steps(directory)
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, like_tree):
    """Restore into the structure of ``like_tree`` (shapes verified), each
    leaf on the device of ``like_tree``'s leaf.  -> (tree, meta)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = tree_util.leaves(like_tree)
    if manifest["num_leaves"] != len(flat):
        raise ValueError(f"tree structure changed: {manifest['num_leaves']} "
                         f"leaves stored, {len(flat)} expected")
    out = []
    for i, (leaf, spec) in enumerate(zip(flat, manifest["leaves"])):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        want = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: stored {arr.shape}, expected {want}")
        t = torch.from_numpy(arr)
        if spec["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out.append(t.to(dev))
    return tree_util.unflatten(like_tree, out), manifest["meta"]

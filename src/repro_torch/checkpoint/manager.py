"""Checksummed, async checkpointing of a training state: the reference's
``repro/checkpoint/manager.py`` layout and guarantees, for tensors.

    <dir>/step_000000100/
        meta.json            {step, n_shards, checksums, shapes, dtypes}
        shard_00000.npz      flat {leaf path: array}
        COMMIT               written last (atomic-rename publish)

* a state is a tree of dicts, ``nn.Module``s (their ``state_dict()``
  entries) and tensors; a leaf's path joins the keys with '/';
* ``save`` copies every tensor to the host before it returns (training
  updates its tensors in place right after), and writes the files on a
  background thread unless ``blocking``; ``wait()`` joins it, and a save
  waits for the one before it;
* bfloat16 leaves are stored as their uint16 bits (numpy has no bfloat16
  without ``ml_dtypes``), with every leaf's dtype in ``meta.json``;
* ``COMMIT`` and a sha256 per leaf make torn and corrupt checkpoints
  detectable: ``latest_step`` skips directories without ``COMMIT``, and
  ``restore`` raises ``IOError`` on a checksum that does not match;
* ``keep`` bounds the committed checkpoints kept (oldest removed first);
* ``restore(step, target)`` writes the saved values into ``target``'s
  tensors in place, on their devices and in their dtypes, and returns it.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a state in order: dict keys as given, a module's
    ``state_dict()`` entries."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict(keep_vars=True)
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` as numpy (bfloat16 as its uint16 bits) and the
    leaf's dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.cpu().numpy().copy()
        return (arr.view(np.uint16) if name == "bfloat16" else arr), name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state, blocking: bool = False):
        self.wait()
        flat, dtypes = {}, {}
        for key, leaf in _leaves(state):
            flat[key], dtypes[key] = _to_host(leaf)

        def write():
            tmp = self.dir / f".tmp_step_{step:09d}"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "shard_00000.npz", **flat)
            meta = {
                "step": step,
                "n_shards": 1,
                "checksums": {k: _sha(v) for k, v in flat.items()},
                "shapes": {k: list(v.shape) for k, v in flat.items()},
                "dtypes": dtypes,
            }
            (tmp / "meta.json").write_text(json.dumps(meta))
            (tmp / "COMMIT").write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self._committed())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def _committed(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists() and (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self._committed()
        return max(steps) if steps else None

    def restore(self, step: int, target):
        """Write checkpoint ``step`` into ``target`` (a state of the saved
        structure) in place and return it.  Raises ``IOError`` on a
        corrupt leaf, ``KeyError`` on a missing one, ``ValueError`` on a
        shape that differs."""
        d = self.dir / f"step_{step:09d}"
        meta = json.loads((d / "meta.json").read_text())
        with np.load(d / "shard_00000.npz") as z:
            flat: Dict[str, np.ndarray] = {k: z[k] for k in z.files}
        for k, v in flat.items():
            if _sha(v) != meta["checksums"][k]:
                raise IOError(f"checkpoint shard corrupt at leaf {k}")
        return _fill(target, flat, meta.get("dtypes", {}), "")


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


@torch.no_grad()
def _fill(tree, flat, dtypes, prefix: str):
    if isinstance(tree, nn.Module):
        for k, t in tree.state_dict(keep_vars=True).items():
            _fill(t, flat, dtypes, f"{prefix}{k}/")
        return tree
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = _fill(tree[k], flat, dtypes, f"{prefix}{k}/")
        return tree
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    shape = tuple(tree.shape) if hasattr(tree, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != {shape}")
    if isinstance(tree, torch.Tensor):
        tree.copy_(_from_host(arr, dtypes.get(key, str(arr.dtype))))
        return tree
    return arr.astype(np.asarray(tree).dtype)

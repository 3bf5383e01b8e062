"""Checkpointing in the reference's on-disk format
(``repro.checkpoint.checkpointer``): async save, manifest, atomic
commit, restore onto any device.

Layout (one directory per step):
    ckpt_dir/step_000123/
        manifest.json        # leaves' shapes and dtypes, config hash
        arrays.npz           # one entry per leaf, keyed by its path
        COMMITTED            # written last: a partial checkpoint never loads

Leaves are keyed by their "/"-joined dict path and listed in sorted-key
order, as ``jax.tree_util.tree_flatten_with_path`` lists the reference's
pytrees; bf16 leaves are stored as their raw bytes (uint8) with dtype
``"bfloat16"`` in the manifest, as the reference's ``_encode`` stores
them. bf16 is written and read through its 16-bit pattern, so no
``ml_dtypes`` is needed, and a checkpoint written by either package
restores in the other. A save copies every leaf to host memory before
it returns (training goes on updating the parameters in place) and
serialises on a background thread.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import sorted_items


def _to_host(t) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a leaf; bf16 as its uint16 bits."""
    if not isinstance(t, torch.Tensor):
        a = np.asarray(t)
        return a, str(a.dtype)
    t = t.detach().to("cpu", copy=True).contiguous()  # a snapshot
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _encode(a: np.ndarray, dtype: str) -> np.ndarray:
    """npz-safe encoding: bf16 goes as raw uint8 bytes."""
    if dtype == "bfloat16":
        return np.frombuffer(a.tobytes(), np.uint8)
    return a


def _decode(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.frombuffer(raw.tobytes(), np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if raw.dtype == np.uint8 and dtype != "uint8":
        raw = np.frombuffer(raw.tobytes(), np.dtype(dtype))
    return torch.from_numpy(np.array(raw).reshape(shape))


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 config_hash: Optional[str] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.config_hash = config_hash or ""
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: dict, *, blocking: bool = False):
        """Snapshot to host, then serialise (async unless blocking)."""
        host = [(_key(p), *_to_host(leaf)) for p, leaf in sorted_items(state)]
        self.wait()
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, host), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list):
        tmp = self.dir / f"tmp_{step:09d}_{time.time_ns()}"
        final = self.dir / f"step_{step:09d}"
        tmp.mkdir(parents=True, exist_ok=True)
        arrays, leaves = {}, {}
        for key, arr, dtype in host:
            arrays[key] = _encode(arr, dtype)
            leaves[key] = {"shape": list(arr.shape), "dtype": dtype}
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": step,
            "config_hash": self.config_hash,
            "leaves": leaves,
            "checksum": hashlib.sha256(
                b"".join(np.ascontiguousarray(arr).tobytes()[:4096]
                         for _, arr, _ in host)).hexdigest(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        (tmp / "COMMITTED").write_text("ok")       # atomic commit marker
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``: each leaf on ``like``'s
        leaf's device and in its dtype (a numpy leaf of ``like`` gives a
        CPU tensor of the saved dtype). Raises ValueError on a config hash
        or a shape that differs."""
        path = self.dir / f"step_{step:09d}"
        manifest = json.loads((path / "manifest.json").read_text())
        if self.config_hash and manifest["config_hash"] and \
                manifest["config_hash"] != self.config_hash:
            raise ValueError(
                f"checkpoint config hash {manifest['config_hash']} != "
                f"runtime {self.config_hash}")
        meta = manifest["leaves"]
        with np.load(path / "arrays.npz") as data:
            def leaf(p: tuple, like_leaf):
                key = _key(p)
                t = _decode(data[key], meta[key]["dtype"],
                            tuple(meta[key]["shape"]))
                want = tuple(np.shape(like_leaf))
                if tuple(t.shape) != want:
                    raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                                     f"{want}")
                if isinstance(like_leaf, torch.Tensor):
                    t = t.to(device=like_leaf.device, dtype=like_leaf.dtype)
                return t
            return _map_with_path(leaf, like)


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict, keeping empty dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)

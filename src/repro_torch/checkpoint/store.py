"""Checkpointing of tensor trees, in the reference's on-disk layout.

Layout (one directory per step), byte for byte the reference's
(``repro/checkpoint/store.py``), so either package restores what the other
wrote:
  step_00000123/
    MANIFEST.json     # {"step", "extra", "codec", "leaves": {key: {"file",
                      #  "shape", "dtype"}}}, keys "a/b/c" in sorted order
    leaf_00000.npz    # the leaf's raw bytes, compressed (zstd, or zlib
                      #  where ``zstandard`` does not import), one file per
                      #  leaf in sorted key order

numpy has no bfloat16: a bfloat16 leaf is written as its raw 2-byte words
under dtype "bfloat16" (the bytes the reference's ``ml_dtypes`` writes) and
read back through ``torch.frombuffer``.

Properties the fault-tolerant trainer relies on:
  * atomic publish: written to step_xxx.tmp, then renamed;
  * async save: the device->host copy happens synchronously, the
    compress+write runs on a background thread so training continues (the
    leaves compress in parallel threads: zlib and zstd release the GIL);
  * ``keep`` bounds how many steps stay on disk.
The reference's elastic restore onto a mesh (``shardings``) waits for the
port of sharding (ROADMAP queue 1, data-parallel and sharding).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

try:  # optional: zstd when available, zlib otherwise (codec recorded
    import zstandard  # in the manifest so mixed environments interop)
except ModuleNotFoundError:
    zstandard = None

_SEP = "/"
_THREADS = min(8, os.cpu_count() or 1)


def _flatten(tree) -> dict[str, Any]:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + [str(k)], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(prefix + [str(i)], v)
        else:
            flat[_SEP.join(prefix)] = node

    rec([], tree)
    return flat


def _unflatten(flat: dict[str, Any], template) -> Any:
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(prefix + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(prefix + [str(i)], v) for i, v in enumerate(node))
        return flat[_SEP.join(prefix)]

    return rec([], template)


def _to_host(t) -> tuple[bytes, list, str]:
    """(raw bytes, shape, dtype name) of a tensor or array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), list(t.shape), "bfloat16"
        t = t.numpy()
    a = np.asarray(t)
    return a.tobytes(), list(a.shape), str(a.dtype)


def _from_host(raw: bytes, shape: list, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy())


class CheckpointStore:
    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.is_dir() and (p / "MANIFEST.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None,
             async_: bool = False) -> None:
        """Snapshot ``tree`` (a tree of tensors or arrays) at ``step``."""
        # device -> host synchronously, so the caller may go on with the tensors
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}

        def write():
            tmp = self.root / f"step_{step:08d}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            if zstandard is not None:
                codec = "zstd"

                def compress(b):  # a compressor object is not shared across threads
                    return zstandard.ZstdCompressor(level=3).compress(b)
            else:
                codec, compress = "zlib", (lambda b: zlib.compress(b, 6))
            manifest = {"step": step, "extra": extra or {}, "codec": codec, "leaves": {}}
            items = sorted(host.items())
            with ThreadPoolExecutor(_THREADS) as pool:
                blobs = pool.map(compress, [raw for _, (raw, _, _) in items])
                for i, ((key, (_, shape, dtype)), blob) in enumerate(zip(items, blobs)):
                    fn = f"leaf_{i:05d}.npz"
                    manifest["leaves"][key] = {"file": fn, "shape": shape, "dtype": dtype}
                    (tmp / fn).write_bytes(blob)
            (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
            final = self._step_dir(step)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if async_:
            self.wait()

            def run():
                try:
                    write()
                except Exception as e:  # raised to the caller by wait()
                    self._error = e

            self._pending = threading.Thread(target=run, daemon=True)
            self._pending.start()
        else:
            write()

    def wait(self) -> None:
        """Block until an async save has been published; raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int], template, device="cuda"):
        """Restore into the structure of ``template`` (a tree whose leaves,
        tensors of any device including "meta", give the expected shapes),
        onto ``device``. Returns (tree, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        manifest = json.loads((d / "MANIFEST.json").read_text())
        codec = manifest.get("codec", "zstd")  # pre-codec manifests: zstd
        if codec == "zstd":
            if zstandard is None:
                raise RuntimeError(
                    f"checkpoint {d} is zstd-compressed but the 'zstandard' "
                    "package is not installed (new checkpoints fall back to zlib)")
            decompress = zstandard.ZstdDecompressor().decompress
        else:
            decompress = zlib.decompress
        want = _flatten(template)
        flat = {}
        for key, meta in manifest["leaves"].items():
            if key not in want:
                continue
            if list(want[key].shape) != meta["shape"]:
                raise ValueError(f"checkpoint leaf {key} has shape {meta['shape']}, "
                                 f"the template {list(want[key].shape)}")
            raw = decompress((d / meta["file"]).read_bytes())
            flat[key] = _from_host(raw, meta["shape"], meta["dtype"]).to(device)
        missing = sorted(set(want) - set(flat))
        if missing:
            raise KeyError(f"checkpoint {d} lacks leaves {missing}")
        return _unflatten(flat, template), manifest["extra"]

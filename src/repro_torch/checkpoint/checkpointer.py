"""Checkpointing with async save and an integrity manifest (port of
``repro.checkpoint.checkpointer``), in the reference's layout:

    <dir>/step_000100/
        manifest.json       # leaf names, shapes, dtypes, host count, crc32
        host_00000.npz      # the leaves, by name ("a/b/c" -> "a__b__c")
        _COMMITTED          # written last: torn checkpoints are never loaded

A tree is nested dicts / lists / tuples of tensors, numpy arrays or scalars;
a leaf is named by its path joined with "/" (the reference's names for the
same tree), so a checkpoint the JAX package wrote loads here and the other
way round. bf16 has no numpy dtype without ``ml_dtypes``: its bits go
through a ``uint16`` array and the manifest records ``"bfloat16"``.

The snapshot to host memory is synchronous and always a copy (a blocking
``.cpu()`` of a CUDA tensor, a clone of a CPU one): the in-place optimizer
overwrites the params and moments at the next step while the background
thread is still writing.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

_BF16 = "bfloat16"


def _named_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rebuild(template, leaves: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return leaves[prefix[:-1]]


@dataclasses.dataclass(frozen=True)
class _Host:
    """A leaf copied to the host: its array and the dtype to record."""
    arr: np.ndarray
    dtype: str


def _to_host(leaf) -> _Host:
    if isinstance(leaf, _Host):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _Host(t.view(torch.int16).numpy().view(np.uint16), _BF16)
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return _Host(arr, str(arr.dtype))


def save_pytree(tree, directory: str | pathlib.Path, step: int,
                host_id: int = 0, num_hosts: int = 1) -> pathlib.Path:
    d = pathlib.Path(directory) / f"step_{step:06d}"
    d.mkdir(parents=True, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "num_hosts": num_hosts, "leaves": {}}
    for name, leaf in _named_leaves(tree):
        host = _to_host(leaf)
        arrays[name] = host.arr
        manifest["leaves"][name] = {
            "shape": list(host.arr.shape), "dtype": host.dtype,
            "crc32": int(zlib.crc32(host.arr.tobytes())),
        }
    np.savez(d / f"host_{host_id:05d}.npz",
             **{k.replace("/", "__"): v for k, v in arrays.items()})
    if host_id == 0:
        (d / "manifest.json").write_text(json.dumps(manifest, indent=1))
    (d / "_COMMITTED").write_text(str(time.time()))
    return d


def _from_host(arr: np.ndarray, dtype: str, tmpl):
    """A loaded array as the template leaf wants it: a tensor on the
    template tensor's device and dtype, else a numpy array."""
    if isinstance(tmpl, torch.Tensor):
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if dtype == _BF16
             else torch.from_numpy(arr))
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    return arr


def load_pytree(template, directory: str | pathlib.Path, step: int,
                host_id: int = 0, verify: bool = True):
    """Load step ``step`` into the structure of ``template`` (leaves by
    name; a tensor leaf gives a tensor on its device and dtype). With
    ``template`` None the tree comes back as nested dicts of numpy arrays,
    by the names in the manifest (how a JAX-written parameter tree is read)."""
    d = pathlib.Path(directory) / f"step_{step:06d}"
    if not (d / "_COMMITTED").exists():
        raise FileNotFoundError(f"checkpoint {d} not committed")
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / f"host_{host_id:05d}.npz")
    names = (list(manifest["leaves"]) if template is None
             else [n for n, _ in _named_leaves(template)])
    tmpls = dict(_named_leaves(template)) if template is not None else {}
    leaves = {}
    for name in names:
        arr = data[name.replace("/", "__")]
        meta = manifest["leaves"][name]
        if verify and int(zlib.crc32(arr.tobytes())) != meta["crc32"]:
            raise IOError(f"checksum mismatch for {name} in {d}")
        tmpl = tmpls.get(name)
        want = tuple(getattr(tmpl, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: shape {arr.shape} != template {want}")
        leaves[name] = _from_host(arr, meta["dtype"], tmpl)
    if template is not None:
        return _rebuild(template, leaves)
    tree: dict = {}
    for name, arr in leaves.items():
        *path, last = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = arr
    return tree


def latest_step(directory: str | pathlib.Path) -> int | None:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.glob("step_*"):
        if (p / "_COMMITTED").exists():
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


class Checkpointer:
    """Async checkpointer: snapshot to host memory synchronously, write to
    disk on a background thread (training never blocks on IO). Keeps the
    last ``keep`` checkpoints."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3,
                 host_id: int = 0, num_hosts: int = 1):
        self.dir = pathlib.Path(directory)
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._thread: threading.Thread | None = None
        self.saves = 0

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, tree, step: int, blocking: bool = False):
        self.wait()
        snapshot = _rebuild(tree, {n: _to_host(l) for n, l in _named_leaves(tree)})

        def _write():
            save_pytree(snapshot, self.dir, step, self.host_id, self.num_hosts)
            self._gc()

        self.saves += 1
        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def restore(self, template, step: int | None = None):
        self.wait()
        step = latest_step(self.dir) if step is None else step
        if step is None:
            return None, None
        return load_pytree(template, self.dir, step, self.host_id), step

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if (p / "_COMMITTED").exists())
        for s in steps[:-self.keep]:
            target = self.dir / f"step_{s:06d}"
            for f in target.glob("*"):
                f.unlink()
            target.rmdir()

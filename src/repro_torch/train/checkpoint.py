"""Slice-shape-elastic checkpoints (port of ``repro/train/checkpoint.py``).

The on-disk format is the reference's format v2, unchanged, so a
checkpoint written by either package restores into the other:

  * ``step_{step:08d}/manifest.json`` — format version, step, ``extra``
    metadata, and per leaf its global ``shape``, ``dtype``, ``saved_dtype``
    and the ``spans`` (index ranges) each shard file holds;
  * ``step_{step:08d}/shard_NNN.npz`` — the leaf data; ``shards=N`` splits
    each leaf along its first axis into up to N spans, one file each;
  * ``LATEST`` — the newest step.

Leaves are keyed by the reference's ``jax.tree_util.keystr`` of their
path, which `flatten` reproduces: ``['params']['layers']['attn']['wq']`` for
dict keys, ``[0]`` for list and tuple positions and ``.mu`` for a
NamedTuple field (the optimizer state: ``['opt'].step``, ``['opt'].mu[...]``).
Dict keys are walked in sorted order, as JAX flattens them; empty dicts and
None hold no leaf.  bfloat16 leaves are stored as a lossless float32 upcast
with ``dtype: "bfloat16"`` (numpy has no bf16).  A host ``int`` leaf (the
port keeps ``OptState.step`` on the host) is written as the 0-d int32 array
the reference writes, and restores as an ``int``.

One device: every leaf is written whole (or split with ``shards=``), and
``restore`` assembles each leaf's spans on the host and moves it to
``device`` once.  Format v1 (one ``arrays.npz``) restores as well.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 2

# dtypes npz stores natively; anything else (bfloat16) is stored as a
# lossless float32 upcast and cast back on restore
_NATIVE_DTYPES = ("float64", "float32", "float16", "int64", "int32",
                  "int16", "int8", "uint8", "uint16", "uint32", "uint64",
                  "bool")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _unflatten(tree, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return leaves[prefix]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(host array in a dtype npz stores, the leaf's dtype name) of a
    tensor or a host int."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    t = leaf.detach()
    name = str(t.dtype).removeprefix("torch.")
    if name not in _NATIVE_DTYPES:
        t = t.float()
    return t.cpu().numpy(), name


def _leaf_spans(arr: np.ndarray, shards: int):
    """Break one leaf into (start, stop, data) spans: up to ``shards``
    along its first axis (a leaf of fewer than 2 rows is one span)."""
    ndim = arr.ndim
    if shards > 1 and ndim >= 1 and arr.shape[0] >= 2:
        n = min(shards, arr.shape[0])
        cuts = np.linspace(0, arr.shape[0], n + 1, dtype=int)
        spans = []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            if lo == hi:
                continue
            start = (int(lo),) + (0,) * (ndim - 1)
            stop = (int(hi),) + tuple(arr.shape[1:])
            spans.append((start, stop, arr[lo:hi]))
        return spans
    return [((0,) * ndim, tuple(arr.shape), arr)]


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict] = None,
         shards: int = 1, keep: Optional[int] = None) -> pathlib.Path:
    """Write one checkpoint of ``tree`` (nested dicts, lists, tuples and
    NamedTuples of tensors and host ints) as
    ``step_{step:08d}/``, then ``LATEST``; ``extra`` is JSON metadata kept
    in the manifest; ``shards`` splits each leaf along its first axis;
    ``keep`` prunes all but the newest ``keep`` v2 checkpoints after the
    save has landed (`gc`).  Returns the step directory."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, Any] = {"format": FORMAT_VERSION, "step": step,
                                "extra": extra or {}, "leaves": {}}
    files: List[Dict[str, np.ndarray]] = []      # shard file -> npz payload
    for k, v in flatten(tree):
        arr, dtype = _host(v)
        entry = {"shape": list(arr.shape), "dtype": dtype,
                 "saved_dtype": str(arr.dtype), "spans": []}
        for i, (start, stop, data) in enumerate(_leaf_spans(arr, shards)):
            while len(files) <= i:
                files.append({})
            # NB: ascontiguousarray would promote 0-d leaves to 1-d
            files[i][k] = (np.ascontiguousarray(data) if data.ndim
                           else np.asarray(data))
            entry["spans"].append({"file": f"shard_{i:03d}",
                                   "start": list(start),
                                   "stop": list(stop)})
        manifest["leaves"][k] = entry
    for i, payload in enumerate(files):
        np.savez(d / f"shard_{i:03d}.npz", **payload)
    (d / "manifest.json").write_text(json.dumps(manifest))
    (pathlib.Path(ckpt_dir) / "LATEST").write_text(str(step))
    if keep is not None:
        gc(ckpt_dir, keep)
    return d


def gc(ckpt_dir: str, keep: int) -> List[pathlib.Path]:
    """Prune old span-manifest checkpoints, keeping the newest ``keep``.

    A ``step_*`` directory is pruned only if its ``manifest.json`` says
    ``format >= 2`` and it holds no ``arrays.npz``: v1 checkpoints, torn
    directories without a manifest and unreadable manifests are never
    touched.  The step named by ``LATEST`` is always kept.  Returns the
    pruned directories."""
    assert keep >= 1, keep
    root = pathlib.Path(ckpt_dir)
    latest = latest_step(ckpt_dir)
    cands: List[Tuple[int, pathlib.Path]] = []
    for d in root.glob("step_*"):
        if not d.is_dir():
            continue
        try:
            step = int(d.name.split("_", 1)[1])
        except ValueError:
            continue
        mf = d / "manifest.json"
        if not mf.exists():
            continue                      # not ours (or torn) — keep
        try:
            fmt = json.loads(mf.read_text()).get("format", 1)
        except (json.JSONDecodeError, OSError):
            continue                      # unreadable — keep, never guess
        if fmt < 2 or (d / "arrays.npz").exists():
            continue                      # legacy v1 layout — never GC'd
        cands.append((step, d))
    cands.sort()
    prune = [d for step, d in cands[:-keep] if step != latest]
    for d in prune:
        for f in d.iterdir():
            f.unlink()
        d.rmdir()
    return prune


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Step number of the newest checkpoint under ``ckpt_dir`` (or None)."""
    p = pathlib.Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def read_manifest(ckpt_dir: str, step: Optional[int] = None
                  ) -> Dict[str, Any]:
    """Load a checkpoint's manifest (latest step when ``step`` is None)."""
    if step is None:
        step = latest_step(ckpt_dir)
        assert step is not None, f"no checkpoint under {ckpt_dir}"
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((d / "manifest.json").read_text())


def _shard(d: pathlib.Path, name: str, cache: Dict[str, Any]):
    if name not in cache:
        cache[name] = np.load(d / f"{name}.npz")
    return cache[name]


def _assemble(d: pathlib.Path, entry: Dict[str, Any], key: str,
              shard_cache: Dict[str, Any]) -> np.ndarray:
    """Rebuild one leaf's global host array from its manifest spans."""
    shape = tuple(entry["shape"])
    spans = entry["spans"]
    if (len(spans) == 1 and tuple(spans[0]["start"]) == (0,) * len(shape)
            and tuple(spans[0]["stop"]) == shape):
        data = _shard(d, spans[0]["file"], shard_cache)[key]
        return np.asarray(data).reshape(shape)
    out = np.empty(shape, dtype=np.dtype(entry["saved_dtype"]))
    covered = 0
    for sp in spans:
        sel = tuple(slice(a, b) for a, b in zip(sp["start"], sp["stop"]))
        out[sel] = _shard(d, sp["file"], shard_cache)[key]
        covered += int(np.prod([b - a for a, b in
                                zip(sp["start"], sp["stop"])]))
    assert covered == int(np.prod(shape)), \
        f"{key}: spans cover {covered} of {int(np.prod(shape))} elements"
    return out


def restore(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
            device="cpu") -> Tuple[Any, int, Dict]:
    """Restore a checkpoint into the structure of ``tree_like``.

    ``tree_like``'s leaves give each leaf's shape and dtype: tensors (a
    ``meta`` tensor will do) or host ints (restored as ints).  Shapes must
    equal the saved global shapes.  Each leaf is assembled from its spans
    on the host, cast there, and moved to ``device`` once.  ``step``: the
    step to restore (default: the latest).  Returns ``(tree, step, extra)``.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        assert step is not None, f"no checkpoint under {ckpt_dir}"
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    shard_cache: Dict[str, Any] = {}
    legacy = (np.load(d / "arrays.npz") if manifest.get("format", 1) < 2
              else None)
    out: Dict[str, Any] = {}
    for k, like in flatten(tree_like):
        if legacy is not None:
            arr = legacy[k]
        else:
            arr = _assemble(d, manifest["leaves"][k], k, shard_cache)
        if isinstance(like, int):
            assert arr.shape == (), (k, arr.shape)
            out[k] = int(arr)
            continue
        want = tuple(like.shape)
        assert tuple(arr.shape) == want, (k, arr.shape, want)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = arr.copy()
        out[k] = torch.from_numpy(arr).to(like.dtype).to(device)
    return _unflatten(tree_like, out), step, manifest.get("extra", {})

"""Step-atomic checkpointing, the reference package's
``train/checkpoint.py`` over trees of torch tensors, with the reference's
on-disk layout: a checkpoint written by either package restores in the
other, leaf for leaf.

Layout: <dir>/step_<n>/ with one .npy per tree leaf (path-encoded name)
plus meta.json.  Writes go to a tmp dir then rename (atomic on POSIX), so a
preemption mid-write never corrupts the latest checkpoint.  ``restore``
loads host-side and moves each leaf to the device asked for.  Async saves
copy the tree to the host first, then write on a daemon thread (the
training loop never blocks on I/O).

Leaf names are the reference's flattened paths: dict keys in sorted order,
a NamedTuple field as ``.name`` (``AdamState``'s ``opt/.mu/...``,
``opt/.step``), a list or tuple entry as its index, a bare leaf as
``root``.  numpy has no bfloat16 or float8, so such a leaf is stored as a
same-width unsigned view and its real dtype is named in meta.json's
``dtypes``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

# the stored view of each dtype numpy cannot hold, by the reference's name
_EXOTIC = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
           "float8_e5m2": (np.uint8, torch.float8_e5m2)}
# the integer type of the same width that both numpy and torch hold
_BITS = {np.uint16: (np.int16, torch.int16), np.uint8: (np.uint8, torch.uint8)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path: tuple, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (str(k),), out)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            _walk(getattr(tree, name), path + ("." + name,), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, path + (str(i),), out)
    else:
        out.append(("/".join(path) or "root", tree))


def _flatten(tree) -> dict:
    """{path key: leaf} in the reference's order and spelling."""
    out: list = []
    _walk(tree, (), out)
    return dict(out)


def _unflatten(template, leaves: dict, path: tuple = ()):
    """``template``'s structure with each leaf replaced from ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, path + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten(getattr(template, n), leaves, path + ("." + n,))
            for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, path + (str(i),))
                              for i, v in enumerate(template))
    return leaves["/".join(path) or "root"]


def _sanitize(key: str) -> str:
    return re.sub(r"[^\w/.\-]", "_", key).replace("/", "__")


def _to_host(leaf):
    """A leaf as a host copy: a CPU tensor, or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _to_numpy(leaf):
    """(array to store, real dtype name or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        for name, (store, real) in _EXOTIC.items():
            if t.dtype == real:
                return t.view(_BITS[store][1]).numpy().view(store), name
        return t.numpy(), None
    return np.asarray(leaf), None


def save(tree, directory: str, step: int, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    flat = _flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    dtypes = {}
    for key, leaf in flat.items():
        arr, real = _to_numpy(leaf)
        if real is not None:
            dtypes[key] = real
        np.save(os.path.join(tmp, _sanitize(key) + ".npy"), arr)
    meta = {"step": step, "keys": list(flat.keys()), "dtypes": dtypes}
    if extra:
        meta["extra"] = extra
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def save_blocks(blocks: dict, directory: str, step: int, *, shapes: dict,
                indices: dict, write: dict, lead: bool, barrier,
                extra: Optional[dict] = None, keep: int = 3) -> str:
    """``save``'s checkpoint of a tree that ranks hold in blocks, written
    by the ranks together into the same files ``save`` writes: ``blocks``
    maps each key to this rank's block, ``shapes`` to the full leaf's
    shape, ``indices`` to the block's slices in it and ``write`` to
    whether this rank writes it (one rank per block).  The ``lead`` rank
    makes the files, then every rank writes its blocks through a memory
    map, then the lead writes ``meta.json`` and renames the directory;
    ``barrier()`` (every rank's) separates the three.  The ranks must
    share the directory's file system."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    host = {k: _to_numpy(v) for k, v in blocks.items()}
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for key, (arr, _) in host.items():
            np.lib.format.open_memmap(
                os.path.join(tmp, _sanitize(key) + ".npy"), mode="w+",
                dtype=arr.dtype, shape=tuple(shapes[key]))
    barrier()
    for key, (arr, _) in host.items():
        if write[key]:
            mm = np.load(os.path.join(tmp, _sanitize(key) + ".npy"),
                         mmap_mode="r+")
            mm[indices[key]] = arr
            del mm
    barrier()
    if lead:
        meta = {"step": step, "keys": list(blocks),
                "dtypes": {k: r for k, (_, r) in host.items()
                           if r is not None}}
        if extra:
            meta["extra"] = extra
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)
    barrier()
    return final


_pending: list = []


def save_async(tree, directory: str, step: int, extra: Optional[dict] = None,
               keep: int = 3) -> threading.Thread:
    """Non-blocking save; call wait_pending() before exit.  The tree is
    copied to the host before the writer thread starts, so the caller may
    go on updating its tensors."""
    snap = _unflatten(tree, {k: _to_host(v) for k, v in
                             _flatten(tree).items()})
    t = threading.Thread(target=save, args=(snap, directory, step),
                         kwargs=dict(extra=extra, keep=keep), daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    while _pending:
        _pending.pop().join()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _load(path: str, key: str, real: Optional[str], device,
          index=None) -> torch.Tensor:
    arr = np.load(os.path.join(path, _sanitize(key) + ".npy"),
                  mmap_mode="r" if index else None)
    if index:
        arr = np.ascontiguousarray(arr[index])
    if real is None:
        return torch.from_numpy(arr).to(device)
    store, dtype = _EXOTIC[real]
    return torch.from_numpy(arr.view(_BITS[store][0])).view(dtype).to(device)


def restore(template, directory: str, step: Optional[int] = None,
            device=None, blocks: Optional[dict] = None):
    """Restore into the structure of ``template`` (tensors, ``meta``
    tensors, arrays or scalars).  Each leaf is loaded onto ``device``, or
    onto its template leaf's device when that is a real one (the host
    otherwise): the reference's ``shardings`` role on one card.
    ``blocks`` maps a leaf's key to the slices of it to load (a rank's
    block, read from a memory-mapped file: the reference's elastic
    re-shard).  Returns (tree, meta)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    out = {}
    for key, leaf in _flatten(template).items():
        dev = device
        if dev is None:
            dev = (leaf.device if isinstance(leaf, torch.Tensor) and
                   leaf.device.type != "meta" else "cpu")
        out[key] = _load(path, key, dtypes.get(key), dev,
                         None if blocks is None else blocks.get(key))
    return _unflatten(template, out), meta


def _gc(directory: str, keep: int):
    steps = sorted(int(m.group(1)) for d in os.listdir(directory)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)

"""Memory-mapped on-disk storage of finalized eDAGs.

A million-vertex trace is ~100 MB of finalized arrays; re-tracing it per
process is minutes of host work.  This module stores a finalized eDAG as a
directory of raw ``.npy`` files so a later process can ``np.load(...,
mmap_mode="r")`` every array and adopt them zero-copy through
``EDag.from_arrays``: the trace is paged in on demand and never resident
twice on the host.  The format is the reference package's (format 1), so
either package opens what the other stored.

Layout of ``<path>/`` (format 1):

* ``meta.json`` — format version, vertex and edge counts and the trace
  digest (verified on load by default: a tampered or mixed-up directory
  is rejected).
* core arrays — ``cost``, ``is_mem``, ``nbytes``, ``src``, ``dst`` (in the
  canonical dst-sorted order ``_finalize`` produces).
* derived arrays (optional, ``include_derived=True``) — ``level``,
  ``indptr``, ``succ_dst``/``succ_indptr`` and the level partition
  (``esrc``, ``elevel_ptr``, ``run_starts``, ``run_dst``, ``run_lens``,
  ``run_ptr``); loading them skips every O(E) pass of ``_install``.

Labels are not stored: they enter no analysis and not the digest.  The
maps are read-only; whatever reaches the device is copied there once (the
level CSR's and the plans' device tensors).

Writes are atomic (tempdir + ``os.replace``).  ``put_trace`` /
``get_trace`` keep a digest-addressed store in ``$EDAN_TRACE_STORE``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from .graph import EDag, _check_index_limit

_FORMAT = 1

#: Core arrays every stored trace has.
_CORE = ("cost", "is_mem", "nbytes", "src", "dst")
#: Derived arrays adopted via ``EDag.from_arrays(derived=...)`` when
#: present; absence of any one of them simply means recomputation.
_DERIVED = ("level", "indptr", "succ_dst", "succ_indptr", "esrc",
            "elevel_ptr", "run_starts", "run_dst", "run_lens", "run_ptr")


def save_edag(g: EDag, path, *, include_derived: bool = True) -> Path:
    """Store a finalized eDAG at ``path`` (a directory; created/replaced
    atomically).  Returns the final path.

    ``include_derived=False`` stores only the core arrays — about 60% of
    the bytes — at the price of recomputing levels/CSRs on load."""
    g._finalize()
    path = Path(path)
    lv = g._level_csr()
    arrays = dict(cost=np.asarray(g.cost, dtype=np.float64),
                  is_mem=np.asarray(g.is_mem, dtype=bool),
                  nbytes=np.asarray(g.nbytes, dtype=np.float64),
                  src=np.asarray(g.src), dst=np.asarray(g.dst))
    if include_derived:
        arrays.update(level=np.asarray(g.level),
                      indptr=np.asarray(g._indptr),
                      succ_dst=np.asarray(g.succ_dst),
                      succ_indptr=np.asarray(g.succ_indptr),
                      esrc=np.asarray(lv.esrc),
                      elevel_ptr=np.asarray(lv.elevel_ptr),
                      run_starts=np.asarray(lv.run_starts),
                      run_dst=np.asarray(lv.run_dst),
                      run_lens=np.asarray(lv.run_lens),
                      run_ptr=np.asarray(lv.run_ptr))
    meta = dict(format=_FORMAT, n_vertices=g.n_vertices,
                n_edges=g.n_edges, digest=g.trace_digest(),
                derived=bool(include_derived))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=path.parent, suffix=".tmpdir")
    try:
        for name, arr in arrays.items():
            np.save(os.path.join(tmp, name + ".npy"), arr)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
        tmp = None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return path


def load_edag(path, *, mmap: bool = True, verify: bool = True) -> EDag:
    """Open a stored eDAG; arrays are memory-mapped by default (read-only,
    paged in on demand — adopting them via ``EDag.from_arrays`` keeps
    them lazy, so load time and resident memory are independent of trace
    size until an analysis touches the arrays).

    ``verify=True`` recomputes the trace digest from the loaded arrays
    and compares it against ``meta.json`` — a corrupted or mislabeled
    store raises instead of producing silently wrong analyses.  The
    verification reads the edge arrays once (it is the only part of a
    verified load that is O(E))."""
    path = Path(path)
    try:
        with open(path / "meta.json") as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable trace store at {path}: {e}") from e
    if int(meta.get("format", -1)) != _FORMAT:
        raise ValueError(
            f"trace store {path} has format {meta.get('format')!r}; this "
            f"reader understands format {_FORMAT}")
    mode = "r" if mmap else None
    try:
        core = {k: np.load(path / f"{k}.npy", mmap_mode=mode)
                for k in _CORE}
    except OSError as e:
        raise ValueError(f"trace store {path} is missing core arrays: "
                         f"{e}") from e
    n = len(core["cost"])
    _check_index_limit(n, "vertex")
    if n != int(meta.get("n_vertices", -1)) or \
            len(core["src"]) != int(meta.get("n_edges", -1)):
        raise ValueError(f"trace store {path}: array lengths disagree "
                         f"with meta.json")
    derived: Optional[dict] = None
    if meta.get("derived"):
        try:
            derived = {k: np.load(path / f"{k}.npy", mmap_mode=mode)
                       for k in _DERIVED}
        except OSError:
            derived = None             # recompute rather than fail
    g = EDag.from_arrays(core["cost"], core["is_mem"], core["nbytes"],
                         core["src"], core["dst"], derived=derived)
    if verify and g.trace_digest() != meta.get("digest"):
        raise ValueError(
            f"trace store {path}: digest mismatch (stored "
            f"{meta.get('digest')!r}, computed {g.trace_digest()!r}) — "
            f"the stored arrays do not describe the trace the store "
            f"claims")
    return g


def trace_store_dir() -> Optional[Path]:
    """Digest-addressed store root: ``$EDAN_TRACE_STORE`` if set (the
    values ``off`` / ``0`` / ``none`` disable it), else None (disabled —
    unlike the schedule cache there is no default location: traces are
    large and only benchmarks and explicit pipelines should persist
    them)."""
    env = os.environ.get("EDAN_TRACE_STORE", "").strip()
    if not env or env.lower() in ("off", "0", "none", "disabled"):
        return None
    return Path(env)


def put_trace(g: EDag, *, include_derived: bool = True) -> Optional[Path]:
    """Store ``g`` under its digest in ``$EDAN_TRACE_STORE``; returns the
    path, or None when the store is disabled."""
    d = trace_store_dir()
    if d is None:
        return None
    return save_edag(g, d / g.trace_digest()[:32],
                     include_derived=include_derived)


def get_trace(digest: str, *, mmap: bool = True,
              verify: bool = True) -> Optional[EDag]:
    """Open the stored trace for ``digest``, or None on a miss (store
    disabled or trace absent)."""
    d = trace_store_dir()
    if d is None:
        return None
    p = d / digest[:32]
    if not (p / "meta.json").exists():
        return None
    return load_edag(p, mmap=mmap, verify=verify)

"""Persistent on-disk cache of recorded §4 simulator schedules.

The batched simulator (``scheduler.simulate_batch``) pays one serial
recording run — the instrumented heapq event loop — per ``(trace, m,
compute_slots)`` combination, then replays the recorded issue orders for
every sweep point in one pass of the level kernel.  For short sweeps, and
for grids that touch many ``(m, compute_slots)`` pairs, that recording is
the dominant serial cost; this module persists it across processes.

The on-disk formats are byte for byte the reference package's, and the
port's ``trace_digest`` equals the reference's on the same trace, so the
two packages share one cache directory and each reads what the other
wrote.

* **Key** — ``(EDag.trace_digest(), m, compute_slots)``, refined by the
  ``unit`` cost (separate files per unit).  The digest covers exactly
  what the schedule depends on (vertex count, edge list, ``is_mem``), and
  every stored field is cross-checked against the requested key on load:
  a renamed or copied entry is never trusted.
* **Safety** — a cached schedule is only the optimistic first candidate:
  ``simulate_batch`` re-verifies its ``(R, E, vid)`` order for every sweep
  point and re-records where it does not certify, so the cache can only
  save time, never change results.
* **Location** — ``$EDAN_SCHEDULE_CACHE`` if set (``off`` / ``0`` /
  ``none`` / ``disabled`` turn persistence off), else
  ``$XDG_CACHE_HOME/edan/schedules``, else ``~/.cache/edan/schedules``.
* **Thresholds** — traces below ``$EDAN_SCHEDULE_CACHE_MIN`` vertices
  (default 4096) skip the disk.  The directory is pruned to
  ``$EDAN_SCHEDULE_CACHE_MAX`` entries (default 256) by mtime, LRU — loads
  touch mtime.  Unparseable or negative values fall back to the defaults.
* **Format 3** — an ``.npz`` of int32 *deltas* (``np.diff`` with a zero
  prepend) of the issue orders, the topological order and the augmented
  levels; decoding is one ``np.cumsum`` per array.
* **Format 4** — traces of at least ``$EDAN_SCHEDULE_CACHE_MMAP_MIN``
  vertices (default 2^19) store a ``<key>.d/`` directory holding a
  ``meta.npz`` and one raw int32 ``.npy`` per array, loaded with
  ``np.load(mmap_mode="r")``: the read-only maps are paged in by the
  replay-plan build, which copies them once into the plan's device
  tensors, so a million-vertex schedule is never decompressed into a
  second resident host copy.
* **Quarantine** — an entry at the key path that fails any check (old
  format, wrong dtype, wrong lengths, unreadable) is renamed to ``*.bad``
  with a warn-once log, so one re-recording warms every later process.

Writes are atomic (tempfile or tempdir + ``os.replace``), so processes
sharing a directory race benignly.  ``fault_hook`` lets ``serve.faults``
inject IO errors at the three disk-IO points.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .counters import Stats

_log = logging.getLogger(__name__)

_FORMAT = 3
#: Directory entries (one raw int32 ``.npy`` per array, memory-mapped on
#: load) carry their own format number so a compressed-format reader
#: never half-understands one.
_DIR_FORMAT = 4
_DEFAULT_MAX_ENTRIES = 256
_DEFAULT_MIN_VERTICES = 4096
#: Vertex count at which entries switch to the memory-mapped directory
#: layout.  Below it the compressed single-file format wins (smaller,
#: one syscall); above it decompression would materialize a second
#: resident copy of arrays the replay-plan build only streams through.
_DEFAULT_MMAP_MIN = 1 << 19
#: Delta-encoded schedule arrays, stored int32: (archive key, load dtype).
_ARRAY_KEYS = ("topo_d", "O_mem_d", "O_alu_d", "level_d")
#: Raw per-array file names inside a format-4 directory entry.
_RAW_NAMES = ("topo", "O_mem", "O_alu", "level")


def _delta_encode(arr: np.ndarray) -> Optional[np.ndarray]:
    """int32 delta encoding of a 1-D nonnegative int array, or None when
    the array cannot be represented (wrong ndim, or values outside
    ``[0, 2^31)`` whose deltas would overflow int32)."""
    arr = np.asarray(arr)
    if arr.ndim != 1:
        return None
    if len(arr) and (arr.min() < 0 or arr.max() >= 2 ** 31):
        return None
    return np.diff(arr.astype(np.int64), prepend=np.int64(0)) \
        .astype(np.int32)


def _delta_decode(deltas: np.ndarray) -> Optional[np.ndarray]:
    """Inverse of ``_delta_encode``; None for malformed stored arrays
    (anything but 1-D int32, or decoded values outside ``[0, 2^31)`` —
    a corrupt or foreign entry either way).  Returns int32: decoded
    values are vertex ids / levels and feed straight into the int32
    replay-plan arrays, so handing back int64 here would force a
    second full-size copy at every adoption site."""
    if deltas.ndim != 1 or deltas.dtype != np.int32:
        return None
    arr = np.cumsum(deltas.astype(np.int64))
    if len(arr) and (arr.min() < 0 or arr.max() >= 2 ** 31):
        return None
    return arr.astype(np.int32)

#: Cumulative per-process counters, for benchmarks and tests:
#: ``memory_hits`` / ``disk_hits`` / ``misses`` count plan lookups in
#: ``simulate_batch``; ``record_runs`` counts instrumented event-loop
#: recordings (the cost the cache exists to amortize); ``stores`` counts
#: successful disk writes; ``quarantined`` counts corrupt entries moved
#: aside to ``*.bad`` on load; ``record_seconds`` accumulates wall-clock
#: seconds spent inside instrumented recordings — the quantity a warm
#: cache amortizes (benchmarks assert it is 0.0 in warm processes).
#: Thread-safe (``counters.Stats``): the analysis service warms this
#: cache from concurrent batches.
stats = Stats(memory_hits=0, disk_hits=0, misses=0, stores=0,
              record_runs=0, quarantined=0, record_seconds=0.0)

#: Fault-injection hook (``serve.faults``): when set, called with the
#: point name (``"cache-load"`` / ``"cache-store"``) before disk IO so
#: the fault layer can inject IO errors or corrupt entries
#: deterministically.  Never set outside tests/fault injection.
fault_hook = None

#: Corrupt entries are renamed aside with a warning exactly once per
#: process — a shared cache directory with a damaged entry would
#: otherwise log once per load forever.
_warned_quarantine = False


def reset_stats() -> None:
    """Zero the per-process counters (tests and benchmarks)."""
    stats.reset()


def cache_dir() -> Optional[Path]:
    """Resolve the cache directory, or None when persistence is disabled.

    Re-read from the environment on every call so tests and benchmark
    subprocesses can redirect it without reimporting."""
    env = os.environ.get("EDAN_SCHEDULE_CACHE", "").strip()
    if env.lower() in ("off", "0", "none", "disabled"):
        return None
    if env:
        return Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME", "").strip() or \
        os.path.join(os.path.expanduser("~"), ".cache")
    return Path(xdg) / "edan" / "schedules"


def min_vertices() -> int:
    """Smallest trace (vertex count) worth persisting to disk.

    ``$EDAN_SCHEDULE_CACHE_MIN`` values that are empty, unparseable or
    negative fall back to the default instead of raising mid-sweep
    (0 is valid: persist everything)."""
    try:
        env = int(os.environ.get("EDAN_SCHEDULE_CACHE_MIN", ""))
    except (TypeError, ValueError):
        return _DEFAULT_MIN_VERTICES
    return env if env >= 0 else _DEFAULT_MIN_VERTICES


def max_entries() -> int:
    """Prune cap for the cache directory (LRU by mtime).

    ``$EDAN_SCHEDULE_CACHE_MAX`` values that are empty, unparseable or
    negative fall back to the default instead of raising mid-sweep; an
    explicit ``0`` keeps its long-standing meaning of "smallest possible
    cache" and clamps to 1 entry."""
    try:
        env = int(os.environ.get("EDAN_SCHEDULE_CACHE_MAX", ""))
    except (TypeError, ValueError):
        return _DEFAULT_MAX_ENTRIES
    if env < 0:
        return _DEFAULT_MAX_ENTRIES
    return max(env, 1)


def mmap_min_vertices() -> int:
    """Vertex count at which entries use the memory-mapped directory
    layout (format 4) instead of a compressed ``.npz``.

    ``$EDAN_SCHEDULE_CACHE_MMAP_MIN`` values that are empty, unparseable
    or negative fall back to the default instead of raising mid-sweep
    (0 is valid: memory-map everything)."""
    try:
        env = int(os.environ.get("EDAN_SCHEDULE_CACHE_MMAP_MIN", ""))
    except (TypeError, ValueError):
        return _DEFAULT_MMAP_MIN
    return env if env >= 0 else _DEFAULT_MMAP_MIN


def _entry_path(d: Path, digest: str, m: int, cs: int,
                unit: float) -> Path:
    # unit is part of the name so workloads sweeping the same trace at
    # different unit costs get separate entries instead of evicting each
    # other on every run
    return d / f"{digest[:32]}_m{m}_cs{cs}_u{float(unit):g}.npz"


def _dir_entry_path(d: Path, digest: str, m: int, cs: int,
                    unit: float) -> Path:
    """Format-4 sibling of ``_entry_path``: same key, ``.d`` directory."""
    return d / f"{digest[:32]}_m{m}_cs{cs}_u{float(unit):g}.d"


def _quarantine(p: Path, reason: str) -> None:
    """Move a corrupt/foreign/old-format entry aside as ``<name>.bad``.

    Silently rejecting such an entry would leave it in place, so every
    process would re-validate, re-record and (for old formats, whose key
    path is taken) fail to overwrite it forever.  Renaming it frees the
    key for the fresh recording's store — corruption costs one recording
    run once, not one per process.  The rename is best-effort (a
    concurrent process may have quarantined or pruned it first) and
    warns once per process."""
    global _warned_quarantine
    try:
        # works for format-4 directory entries too: rename moves the
        # whole directory aside in one shot
        os.replace(p, p.with_name(p.name + ".bad"))
    except OSError:
        return                         # already gone / already quarantined
    stats.add("quarantined")
    if not _warned_quarantine:
        _warned_quarantine = True
        _log.warning(
            "quarantined corrupt schedule-cache entry %s (%s); further "
            "corrupt entries will be moved aside silently", p, reason)


def load(digest: str, m: int, cs: int, n: int,
         unit: float = 1.0) -> Optional[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]]:
    """Fetch a recorded schedule ``(topo, O_mem, O_alu, level)``.

    ``level`` is the persisted topological level assignment of the
    *order-augmented* replay graph (in pop-order vertex space) — it lets
    a warm process skip the O(E) serial ``levelize`` pass as well as the
    recording run, so plan reconstruction is pure vectorized numpy.

    Misses (returns None) on: persistence disabled, absent entry,
    format-version or ``unit`` mismatch, stored arrays that are not the
    format's int32 deltas, or an entry whose arrays do not describe
    ``n`` vertices (a truncated or foreign file — never trusted; the
    scheduler re-validates the arrays structurally before replaying
    them in any case).  A file that exists at the key path but fails any
    of these checks is *quarantined* — renamed to ``*.bad`` with a
    warn-once log — so the key frees up and the fresh recording that
    replaces it warms every later process, instead of every process
    silently re-recording against the same damaged file.  Entries
    written by older formats are quarantined the same way — there is no
    in-place migration."""
    d = cache_dir()
    if d is None:
        return None
    p = _entry_path(d, digest, m, cs, unit)
    try:
        if fault_hook is not None:
            # an injected cache-load fault behaves exactly like a real
            # unreadable entry: quarantine below, never a crash
            fault_hook("cache-load")
        with np.load(p) as z:
            if int(z["format"]) != _FORMAT or int(z["n"]) != n or \
                    float(z["unit"]) != float(unit) or \
                    int(z["m"]) != int(m) or \
                    int(z["compute_slots"]) != int(cs) or \
                    str(z["digest"]) != digest:
                # every stored field must corroborate the requested key —
                # a renamed/copied/old-format entry is never trusted
                _quarantine(p, "stored fields do not match the key")
                return None
            arrays = [_delta_decode(np.asarray(z[k])) for k in _ARRAY_KEYS]
    except FileNotFoundError:
        # no compressed entry at the key: large traces store the
        # memory-mapped directory layout instead
        return _load_dir(d, digest, m, cs, n, unit)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
        _quarantine(p, f"unreadable entry ({type(e).__name__})")
        return None
    if any(arr is None for arr in arrays):
        _quarantine(p, "stored arrays are not int32 deltas")
        return None
    topo, O_mem, O_alu, level = arrays
    if len(topo) != n or len(level) != n or len(O_mem) + len(O_alu) > n:
        _quarantine(p, "array lengths do not describe the keyed trace")
        return None
    try:
        os.utime(p)                    # touch: keep hot entries off the
    except OSError:                    # prune list
        pass
    return topo, O_mem, O_alu, level


def _load_dir(d: Path, digest: str, m: int, cs: int, n: int,
              unit: float) -> Optional[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]]:
    """Load a format-4 directory entry; arrays come back as read-only
    ``np.memmap`` views paged in on demand, so a million-vertex schedule
    is never decompressed into a second resident copy.  Same
    validate-or-quarantine contract as the compressed path."""
    p = _dir_entry_path(d, digest, m, cs, unit)
    if not p.is_dir():
        return None                    # a plain miss, nothing to quarantine
    try:
        with np.load(p / "meta.npz") as z:
            if int(z["format"]) != _DIR_FORMAT or int(z["n"]) != n or \
                    float(z["unit"]) != float(unit) or \
                    int(z["m"]) != int(m) or \
                    int(z["compute_slots"]) != int(cs) or \
                    str(z["digest"]) != digest:
                _quarantine(p, "stored fields do not match the key")
                return None
        # a vanished .npy inside an existing directory is a torn entry
        # (atomic writes never produce one): FileNotFoundError is an
        # OSError, so it quarantines below rather than reading as a miss
        arrays = [np.load(p / f"{name}.npy", mmap_mode="r")
                  for name in _RAW_NAMES]
    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
        _quarantine(p, f"unreadable entry ({type(e).__name__})")
        return None
    if any(a.ndim != 1 or a.dtype != np.int32 for a in arrays):
        _quarantine(p, "stored arrays are not 1-D int32")
        return None
    topo, O_mem, O_alu, level = arrays
    if len(topo) != n or len(level) != n or len(O_mem) + len(O_alu) > n:
        _quarantine(p, "array lengths do not describe the keyed trace")
        return None
    try:
        os.utime(p)                    # touch: keep hot entries off the
    except OSError:                    # prune list
        pass
    return topo, O_mem, O_alu, level


def store(digest: str, m: int, cs: int, n: int, unit: float,
          topo: np.ndarray, O_mem: np.ndarray, O_alu: np.ndarray,
          level: np.ndarray) -> bool:
    """Persist a recorded schedule; returns True on a successful write.

    Refuses (returns False) schedules whose arrays the int32 delta
    encoding cannot represent — anything not 1-D with values in
    ``[0, 2^31)`` (no real schedule is; refusing beats writing a lossy
    entry)."""
    d = cache_dir()
    if d is None or n < min_vertices():
        return False
    if n >= mmap_min_vertices():
        return _store_dir(d, digest, m, cs, n, unit,
                          topo, O_mem, O_alu, level)
    encoded = [_delta_encode(a) for a in (topo, O_mem, O_alu, level)]
    if any(e is None for e in encoded):
        return False
    tmp = None
    try:
        if fault_hook is not None:
            # an injected cache-store fault is a failed write: contained
            # by the best-effort store contract (returns False)
            fault_hook("cache-store")
        d.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, format=_FORMAT, digest=digest, n=n,
                                unit=float(unit), m=m, compute_slots=cs,
                                **dict(zip(_ARRAY_KEYS, encoded)))
        os.replace(tmp, _entry_path(d, digest, m, cs, unit))
        tmp = None
    except OSError:
        return False
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    stats.add("stores")
    prune()
    return True


def _store_dir(d: Path, digest: str, m: int, cs: int, n: int, unit: float,
               topo: np.ndarray, O_mem: np.ndarray, O_alu: np.ndarray,
               level: np.ndarray) -> bool:
    """Write a format-4 directory entry: ``meta.npz`` plus one raw int32
    ``.npy`` per array, built in a tempdir and published with a single
    ``os.replace`` so readers never see a torn entry.  Same refusal
    contract as the compressed path (1-D, values in ``[0, 2^31)``)."""
    arrays = []
    for a in (topo, O_mem, O_alu, level):
        arr = np.asarray(a)
        if arr.ndim != 1 or \
                (len(arr) and (arr.min() < 0 or arr.max() >= 2 ** 31)):
            return False
        arrays.append(np.ascontiguousarray(arr, dtype=np.int32))
    final = _dir_entry_path(d, digest, m, cs, unit)
    tmp = None
    try:
        if fault_hook is not None:
            # an injected cache-store fault is a failed write: contained
            # by the best-effort store contract (returns False)
            fault_hook("cache-store")
        d.mkdir(parents=True, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=d, suffix=".tmpdir")
        np.savez(os.path.join(tmp, "meta.npz"), format=_DIR_FORMAT,
                 digest=digest, n=n, unit=float(unit), m=m,
                 compute_slots=cs)
        for name, arr in zip(_RAW_NAMES, arrays):
            np.save(os.path.join(tmp, name + ".npy"), arr)
        if final.exists():
            # rename cannot replace a non-empty directory; last writer
            # wins, and a concurrent recreate between these two calls
            # just fails this store (best-effort contract)
            shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        tmp = None
    except OSError:
        return False
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    try:
        # a stale compressed sibling at the same key would shadow the
        # fresh directory entry on load
        os.unlink(_entry_path(d, digest, m, cs, unit))
    except OSError:
        pass
    stats.add("stores")
    prune()
    return True


def prune(cap: Optional[int] = None) -> int:
    """Drop the oldest entries beyond the cap; returns how many went.

    Concurrent processes sharing the directory store and prune at the
    same time, so every per-entry step tolerates the entry vanishing
    between the listing and the ``stat`` / ``unlink`` — an already-gone
    entry is simply skipped, never a crash and never an aborted prune
    (one vanished file must not leave the rest of an over-cap directory
    unpruned)."""
    d = cache_dir()
    if d is None or not d.is_dir():
        return 0
    cap = max_entries() if cap is None else max(int(cap), 0)
    try:
        # quarantined *.bad entries count against the cap too (they are
        # never touched, so as the coldest files they are pruned first —
        # corruption cannot grow the directory without bound); format-4
        # directory entries are listed alongside the compressed files
        names = (list(d.glob("*.npz")) + list(d.glob("*.npz.bad"))
                 + list(d.glob("*.d")) + list(d.glob("*.d.bad")))
    except OSError:
        return 0
    entries = []
    for p in names:
        try:
            entries.append((p.stat().st_mtime, p))
        except OSError:
            pass                  # deleted by a concurrent process
    entries.sort(key=lambda e: e[0])
    gone = 0
    for _, p in entries[:max(len(entries) - cap, 0)]:
        try:
            if p.is_dir():
                shutil.rmtree(p)
            else:
                p.unlink()
            gone += 1
        except OSError:
            pass                  # already gone: a concurrent pruner won
    return gone


def clear() -> int:
    """Remove every cached schedule; returns how many were removed."""
    return prune(cap=0)

"""Wisdom: persisted planner decisions (fftw's wisdom files, paper §2.1).

A wisdom store maps a problem signature (extents/precision/kind/batch)
plus the device kind to the candidate a MEASURE or PATIENT run chose.  It
is the reference package's schema v3, record for record: the same JSON
keys (``device_kind|signature[|scope]``), the same candidate records
(per-axis ``axes`` and mesh fields included), the ``measured_ms`` and
``rigor`` provenance, the demotion table, nearest-neighbor lookups and
the atomic merge-on-save.  A file written by either package reads the
same in the other.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import warnings
from typing import Optional

from .breaker import problem_class
from .candidates import BACKENDS, Candidate, backend_supports
from .client import Problem
from .costmodel import estimate_bytes_moved
from .extents import classify, parse_extents

#: Schema version stamped into every record this writer produces.  Loaders
#: keep records at or below their own version (missing ``v`` = version 1)
#: and skip-and-warn on anything newer or malformed.
WISDOM_SCHEMA_VERSION = 3

#: Store key holding backend demotions (known-bad picks), not a selection:
#: ``{f"{device_kind}|{problem_class}": [backend, ...]}``.
_DEMOTED_KEY = "__demoted__"

#: Knobs that encode a shape-specific tuning decision; a nearest-neighbor
#: warm start drops them when the extents differ.
_SHAPE_KNOBS = frozenset({"split_n1", "engine"})


def _candidate_to_record(cand: Candidate) -> dict:
    rec = {"v": WISDOM_SCHEMA_VERSION, "backend": cand.backend,
           "options": [list(kv) for kv in cand.options]}
    if cand.axes:
        rec["axes"] = [_candidate_to_record(a) for a in cand.axes]
    if cand.mesh:
        rec["mesh"] = list(cand.mesh)
    return rec


def _candidate_from_record(rec: dict) -> Candidate:
    return Candidate(rec["backend"],
                     tuple((k, v) for k, v in rec["options"]),
                     tuple(_candidate_from_record(a)
                           for a in rec.get("axes", ())),
                     tuple(int(s) for s in rec.get("mesh", ())))


def _strip_shape_knobs(cand: Candidate) -> Candidate:
    opts = tuple(kv for kv in cand.options if kv[0] not in _SHAPE_KNOBS)
    axes = tuple(_strip_shape_knobs(a) for a in cand.axes)
    return Candidate(cand.backend, opts, axes, cand.mesh)


def _feasibility_class(problem: Problem) -> frozenset:
    """The backends that support ``problem``: interpolation never crosses
    this boundary."""
    return frozenset(b for b in BACKENDS if backend_supports(b, problem))


class Wisdom:
    """A wisdom file and its in-memory map (guarded by a lock, so threads
    may look up, record and save concurrently)."""

    def __init__(self, path: str, device_kind: str = ""):
        self.path = path
        self.device_kind = device_kind
        self._lock = threading.RLock()
        self._store: dict[str, dict] = self._read_disk()

    def _read_disk(self) -> dict:
        """Best-effort load: a missing file is an empty store, and so is an
        unreadable one (with a warning); an invalid entry is skipped with a
        warning."""
        try:
            with open(self.path) as f:
                store = json.load(f)
            if not isinstance(store, dict):
                raise ValueError(f"wisdom root is {type(store).__name__}")
        except FileNotFoundError:
            return {}
        except (json.JSONDecodeError, OSError, ValueError) as e:
            warnings.warn(f"ignoring unreadable wisdom at {self.path}: {e}")
            return {}
        clean: dict[str, dict] = {}
        for key, rec in store.items():
            why = self._invalid_reason(key, rec)
            if why is None:
                clean[key] = rec
            else:
                warnings.warn(
                    f"skipping wisdom entry {key!r} in {self.path}: {why}")
        return clean

    @staticmethod
    def _invalid_reason(key: str, rec) -> Optional[str]:
        """None for a loadable entry, else the reason to skip it."""
        if key == _DEMOTED_KEY:
            if isinstance(rec, dict) and all(
                    isinstance(v, list) and all(isinstance(b, str) for b in v)
                    for v in rec.values()):
                return None
            return "malformed demotion table"
        if not isinstance(rec, dict):
            return f"record is {type(rec).__name__}, not an object"
        v = rec.get("v", 1)
        if not isinstance(v, int) or v < 1:
            return f"bad schema version {v!r}"
        if v > WISDOM_SCHEMA_VERSION:
            return (f"schema version {v} is newer than this reader "
                    f"(v{WISDOM_SCHEMA_VERSION})")
        if not isinstance(rec.get("backend"), str) \
                or not isinstance(rec.get("options"), list):
            return "missing/malformed backend or options"
        ms = rec.get("measured_ms")
        if ms is not None and not isinstance(ms, (int, float)):
            return f"malformed measured_ms {ms!r}"
        try:
            _candidate_from_record(rec)
        except Exception as e:
            return f"unparseable candidate ({type(e).__name__}: {e})"
        return None

    def _key(self, problem: Problem, scope: str = "") -> str:
        """Unscoped keys hold the open planner's choices; a ``scope`` (a
        pinned client's backend) namespaces per-library tuning."""
        base = f"{self.device_kind}|{problem.signature()}"
        return f"{base}|{scope}" if scope else base

    def _parse_key(self, key: str, scope: str = "") -> Optional[Problem]:
        """Invert :meth:`_key` for entries of this device kind and
        ``scope``; None for any other (or unparseable) key."""
        prefix = f"{self.device_kind}|"
        if not key.startswith(prefix):
            return None
        rest = key[len(prefix):]
        if scope:
            suffix = f"|{scope}"
            if not rest.endswith(suffix):
                return None
            rest = rest[:-len(suffix)]
        if "|" in rest:
            return None
        parts = rest.split("/")
        if len(parts) != 4 or not parts[3].startswith("b"):
            return None
        try:
            return Problem(parse_extents(parts[0]), parts[2], parts[1],
                           batch=int(parts[3][1:]))
        except Exception:
            return None

    def lookup(self, problem: Problem, scope: str = "") -> Optional[Candidate]:
        with self._lock:
            rec = self._store.get(self._key(problem, scope))
        if rec is None:
            return None
        return _candidate_from_record(rec)

    def lookup_near(self, problem: Problem, scope: str = ""
                    ) -> Optional[tuple[Candidate, str]]:
        """The selection persisted for the closest shape (Euclidean
        distance in log2 space over the extents and the batch) with the
        same rank, kind, precision, extent class and backend-support set,
        shape-specific knobs stripped; ``(candidate, neighbor_key)`` or
        None.  Mesh-shaped selections never transfer."""
        exts_q = problem.extents
        class_q = classify(exts_q)
        feas_q = None
        best: Optional[tuple[float, str, Candidate]] = None
        with self._lock:
            items = [(k, rec) for k, rec in self._store.items()
                     if k != _DEMOTED_KEY]
        for key, rec in items:
            neighbor = self._parse_key(key, scope)
            if neighbor is None or (neighbor.extents == exts_q
                                    and neighbor.batch == problem.batch):
                continue
            if (neighbor.rank != problem.rank
                    or neighbor.kind != problem.kind
                    or neighbor.precision != problem.precision
                    or classify(neighbor.extents) != class_q):
                continue
            if feas_q is None:
                feas_q = _feasibility_class(problem)
            if _feasibility_class(neighbor) != feas_q:
                continue
            try:
                cand = _candidate_from_record(rec)
            except Exception:
                continue
            if cand.mesh:
                continue
            if neighbor.extents != exts_q:
                cand = _strip_shape_knobs(cand)
            if cand.backend != "nd" and cand.backend not in feas_q:
                continue
            if estimate_bytes_moved(problem, cand) == float("inf"):
                continue
            d = sum((math.log2(a) - math.log2(b)) ** 2
                    for a, b in zip(exts_q, neighbor.extents))
            d += (math.log2(problem.batch) - math.log2(neighbor.batch)) ** 2
            if best is None or (d, key) < (best[0], best[1]):
                best = (d, key, cand)
        if best is None:
            return None
        return best[2], best[1]

    def record(self, problem: Problem, cand: Candidate, scope: str = "",
               measured_ms: Optional[float] = None,
               rigor: Optional[str] = None) -> None:
        """Persist a selection with the winner's measured time and the
        rigor that chose it (both optional)."""
        rec = _candidate_to_record(cand)
        if measured_ms is not None and measured_ms == measured_ms:
            rec["measured_ms"] = float(measured_ms)
        if rigor is not None:
            rec["rigor"] = str(rigor)
        with self._lock:
            self._store[self._key(problem, scope)] = rec

    def _demote_key(self, problem: Problem) -> str:
        return f"{self.device_kind}|{problem_class(problem)}"

    def record_demotion(self, problem: Problem, backend: str) -> None:
        """Quarantine ``backend`` for this problem class: the planner skips
        it."""
        with self._lock:
            table = self._store.setdefault(_DEMOTED_KEY, {})
            row = table.setdefault(self._demote_key(problem), [])
            if backend not in row:
                row.append(backend)

    def demoted(self, problem: Problem) -> frozenset:
        with self._lock:
            table = self._store.get(_DEMOTED_KEY, {})
            return frozenset(table.get(self._demote_key(problem), ()))

    def save(self) -> None:
        """Atomic, concurrent-tolerant write.  Entries another session
        persisted since our load are re-read and kept; a conflicting
        selection keeps ours, and the same selection unions the provenance
        fields; demotions union.  The file is written to a unique temporary
        name, synced and renamed over, so readers never see a torn
        write."""
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        with self._lock:
            merged = self._read_disk()
            disk_dem = merged.get(_DEMOTED_KEY, {})
            ours_dem = self._store.get(_DEMOTED_KEY, {})
            union = {k: list(v) for k, v in disk_dem.items()}
            for k, backends in ours_dem.items():
                row = union.setdefault(k, [])
                row += [b for b in backends if b not in row]
            for k, rec in self._store.items():
                if k == _DEMOTED_KEY:
                    continue
                disk_rec = merged.get(k)
                if isinstance(disk_rec, dict) and isinstance(rec, dict) \
                        and disk_rec.get("backend") == rec.get("backend") \
                        and disk_rec.get("options") == rec.get("options"):
                    merged[k] = {**disk_rec, **rec}
                else:
                    merged[k] = rec
            if union:
                merged[_DEMOTED_KEY] = union
            self._store = merged
            snapshot = dict(merged)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".wisdom-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(snapshot, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        with self._lock:
            return len(self._store) - (_DEMOTED_KEY in self._store)

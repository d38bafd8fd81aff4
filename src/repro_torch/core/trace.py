"""Workload traces: ``TuneContext.record`` as a first-class artifact.

A ``Trace`` captures the op mix a workload issues: every dispatch the api
records is aggregated into ``(OpCell, phase, impl) -> count`` cells, where
the cell carries the full communication problem (op, axis size, per-rank
payload bytes, dtype and, for fused ops, the GEMM dims and role).
``tuner.tune_trace`` consumes it and emits per-phase ``ProfileStore``s.

The on-disk form is JSONL, one aggregated cell per line, schema v2 (the
``v`` key; ``mm``/``role`` only on fused cells) — the same lines the JAX
package writes, so either package loads the other's traces:

    {"v": 2, "op": "matmul_reducescatter", "p": 8, "nbytes": 3145728,
     "dtype": "bfloat16", "mm": [384, 4096, 3072], "role": "scatter",
     "phase": "fwd", "impl": "default", "count": 1}

v1 lines (no ``v`` key) still load with defaulted geometry and one
``DeprecationWarning``.

Fleet shards: a ``ShardRecorder`` is one server's ``record=`` sink. It
flushes epoch-stamped ``shard-<server>-e<epoch>.jsonl`` files (a
``#@shard`` header with the body's sha256, trace lines, ``#@lat``
exploration samples), and ``Trace.merge_shards`` merges a directory of
them, quarantining what fails its checks. The files are byte-identical
to the JAX package's for one stream of records and one seed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import random
import re
import warnings
from typing import Iterable, Iterator

from repro_torch.core.cell import OpCell

SCHEMA_VERSION = 2


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One aggregated dispatch cell."""
    cell: OpCell
    phase: str = "fwd"
    impl: str = "default"
    count: int = 1

    @property
    def op(self) -> str:
        return self.cell.op

    @property
    def axis_size(self) -> int:
        return self.cell.p

    @property
    def nbytes(self) -> int:
        return self.cell.nbytes

    def key(self) -> tuple[OpCell, str, str]:
        return (self.cell, self.phase, self.impl)

    def to_json(self) -> str:
        d = _cell_dict(self.cell)
        d.update(phase=self.phase, impl=self.impl, count=self.count)
        return json.dumps(d)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEntry":
        """Build from a decoded JSONL object; v1 objects (no ``v`` key)
        load with defaulted geometry."""
        return cls(cell=_cell_from_dict(d), phase=d.get("phase", "fwd"),
                   impl=d.get("impl", "default"),
                   count=int(d.get("count", 1)))

    @classmethod
    def from_json(cls, line: str) -> "TraceEntry":
        return cls.from_dict(json.loads(line))


def _cell_dict(cell: OpCell) -> dict:
    """The schema-v2 JSON object for one cell."""
    d = {"v": SCHEMA_VERSION, "op": cell.op, "p": cell.p,
         "nbytes": cell.nbytes, "dtype": cell.dtype}
    if cell.fused:
        d["mm"] = [cell.mm_k, cell.mm_m, cell.mm_n]
        d["role"] = cell.mm_role
    if cell.p2:
        d["p2"] = cell.p2
    if cell.tier:
        d["tier"] = cell.tier
    return d


def _cell_from_dict(d: dict) -> OpCell:
    mm = d.get("mm") or (0, 0, 0)
    return OpCell(op=d["op"], p=int(d["p"]), nbytes=int(d["nbytes"]),
                  dtype=d.get("dtype", "float32"),
                  mm_k=int(mm[0]), mm_m=int(mm[1]), mm_n=int(mm[2]),
                  mm_role=d.get("role", ""), p2=int(d.get("p2", 0)),
                  tier=d.get("tier", ""))


class Trace:
    """An aggregated multiset of dispatch cells (order-independent)."""

    def __init__(self, entries: Iterable[TraceEntry] | None = None):
        self._cells: dict[tuple[OpCell, str, str], int] = {}
        for e in entries or ():
            self._add(e.key(), e.count)

    def _add(self, key: tuple[OpCell, str, str], count: int) -> None:
        if count <= 0:
            raise ValueError(f"non-positive count {count} for {key}")
        self._cells[key] = self._cells.get(key, 0) + count

    # -- construction --------------------------------------------------------
    @classmethod
    def from_record(cls, record) -> "Trace":
        """Build from ``TuneContext.record`` entries (``DispatchRecord``s;
        bare ``(op, p, nbytes, impl, phase)`` 5-tuples get defaulted
        geometry)."""
        t = cls()
        for r in record:
            if hasattr(r, "cell"):
                t._add((r.cell, r.phase, r.impl), 1)
            else:
                op, p, nbytes, impl, phase = r
                t._add((OpCell(op, p, nbytes), phase, impl), 1)
        return t

    @classmethod
    def from_context(cls, ctx) -> "Trace":
        return cls.from_record(ctx.record)

    # -- views ---------------------------------------------------------------
    @property
    def entries(self) -> list[TraceEntry]:
        return [TraceEntry(cell, phase, impl, count)
                for (cell, phase, impl), count in sorted(self._cells.items())]

    def __len__(self) -> int:
        return len(self._cells)

    def __iter__(self) -> Iterator[TraceEntry]:
        return iter(self.entries)

    def __eq__(self, other) -> bool:
        return isinstance(other, Trace) and self._cells == other._cells

    def total(self) -> int:
        """Total dispatch count across all cells."""
        return sum(self._cells.values())

    def phases(self) -> list[str]:
        return sorted({k[1] for k in self._cells})

    def ops(self) -> list[str]:
        return sorted({k[0].op for k in self._cells})

    def histogram(self) -> dict[tuple[OpCell, str], int]:
        """``(cell, phase) -> count`` summed over impls (the tuner
        re-decides the impl; the recorded one is provenance)."""
        out: dict[tuple[OpCell, str], int] = {}
        for (cell, phase, _impl), count in self._cells.items():
            k = (cell, phase)
            out[k] = out.get(k, 0) + count
        return out

    def cells(self, phase: str | None = None) -> dict[OpCell, int]:
        """``OpCell -> count`` for one phase (or all)."""
        out: dict[OpCell, int] = {}
        for (cell, ph, _impl), count in self._cells.items():
            if phase is not None and ph != phase:
                continue
            out[cell] = out.get(cell, 0) + count
        return out

    def filter(self, *, phase: str | None = None,
               op: str | None = None) -> "Trace":
        keep = [e for e in self.entries
                if (phase is None or e.phase == phase)
                and (op is None or e.op == op)]
        return Trace(keep)

    def merge(self, *others: "Trace") -> "Trace":
        """Sum counts cell-wise (traces from many steps/hosts)."""
        out = Trace(self.entries)
        for o in others:
            for e in o.entries:
                out._add(e.key(), e.count)
        return out

    @classmethod
    def merge_shards(cls, directory, *,
                     pattern: str = "shard-*.jsonl",
                     verify_digest: bool = True) -> "MergeReport":
        """Merge a fleet directory of per-server trace shards (the files
        ``ShardRecorder.flush`` writes) into one fleet trace, QUARANTINING
        anything a hostile fleet can produce instead of raising.

        Cells are deduplicated by key with count SUMMATION, so the merged
        trace preserves the total dispatch weight of the SURVIVING shards
        exactly: ``report.trace.total()`` equals the sum of the merged
        shards' totals.  Shards from mixed schema generations merge fine
        (v1-origin geometry-less fused cells stay distinct problems from
        their v2 geometry twins).

        A shard is quarantined — excluded whole from the merged trace,
        recorded in the report with a reason and its dropped dispatch
        weight — when it is unreadable, its ``#@shard`` header is corrupt
        or disagrees with its filename (meta skew), its header sha256
        does not match the body (torn write, bit rot, post-hoc
        tampering), or any trace line fails to parse.  Partial trust is
        deliberately refused: a shard that lies about one line may lie
        about any, so salvage weight is ACCOUNTED (``ShardNote.salvaged``)
        but never merged.

        An empty or absent directory returns an EMPTY report with a
        warning — a cold-started fleet's first epoch is a no-op merge,
        not a crash.
        """
        d = pathlib.Path(directory)
        paths = sorted(d.glob(pattern)) if d.is_dir() else []
        if not paths:
            warnings.warn(
                f"no trace shards matching {pattern!r} under {d} — "
                "empty fleet epoch (cold start?); merge is a no-op")
            return MergeReport(cls(), [])
        out = cls()
        notes: list[ShardNote] = []
        for p in paths:
            note, entries = _ingest_shard(cls, p,
                                          verify_digest=verify_digest)
            notes.append(note)
            if note.status == "merged":
                for e in entries:
                    out._add(e.key(), e.count)
        bad = [n for n in notes if n.status != "merged"]
        if bad:
            warnings.warn(
                f"merge_shards: quarantined {len(bad)}/{len(notes)} "
                f"shard(s) under {d}: "
                + "; ".join(f"{n.path.name} ({n.reason})" for n in bad))
        return MergeReport(out, notes)

    def summary(self) -> str:
        lines = [f"trace: {len(self)} cells, {self.total()} dispatches"]
        for ph in self.phases():
            cells = self.cells(phase=ph)
            n = sum(cells.values())
            ops = sorted({c.op for c in cells})
            lines.append(f"  {ph}: {n} dispatches over {len(cells)} cells "
                         f"({', '.join(ops)})")
        return "\n".join(lines)

    # -- disk ----------------------------------------------------------------
    def to_jsonl(self) -> str:
        return "".join(e.to_json() + "\n" for e in self.entries)

    @classmethod
    def from_jsonl(cls, text: str, *, source: str | None = None) -> "Trace":
        """Parse JSONL (``#`` lines are comments); any v1 line (no ``v``
        key in the decoded object) triggers ONE ``DeprecationWarning``
        naming ``source``."""
        objs = [json.loads(ln) for ln in text.splitlines()
                if ln.strip() and not ln.lstrip().startswith("#")]
        n_v1 = sum(1 for d in objs if "v" not in d)
        if n_v1:
            warnings.warn(
                f"trace {source or '<string>'} carries {n_v1} schema-v1 "
                "line(s) (no 'v' key); v1 parse paths are deprecated — "
                "re-record with the current dispatcher",
                DeprecationWarning, stacklevel=2)
        return cls([TraceEntry.from_dict(d) for d in objs])

    def save(self, path: str | pathlib.Path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_jsonl())

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "Trace":
        p = pathlib.Path(path)
        return cls.from_jsonl(p.read_text(), source=str(p))


# ---------------------------------------------------------------------------
# fleet shards: per-server sampled recording + epoch-stamped shard files
# ---------------------------------------------------------------------------

SHARD_HEADER = "#@shard "
LAT_PREFIX = "#@lat "

_SHARD_NAME_RE = re.compile(r"^shard-(.+)-e(\d+)\.jsonl$")


def _shard_name_parts(name: str) -> tuple[str, int] | None:
    """``(server, epoch)`` encoded in a shard filename, or None."""
    m = _SHARD_NAME_RE.match(name)
    return (m.group(1), int(m.group(2))) if m else None


def _body_digest(body: str) -> str:
    """sha256 over a shard's body text (everything after the header
    line) — written into the ``#@shard`` header, verified at merge."""
    return "sha256:" + hashlib.sha256(body.encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class ShardNote:
    """One shard's fate in a ``merge_shards`` pass."""
    path: pathlib.Path
    server: str | None          # from the #@shard header (None: no header)
    epoch: int | None
    status: str                 # "merged" | "quarantined"
    reason: str = ""            # quarantine cause ("" when merged)
    dispatches: int = 0         # weight merged into the fleet trace
    claimed: int | None = None  # header-claimed dispatch weight
    salvaged: int = 0           # parseable weight in a quarantined shard

    @property
    def dropped(self) -> int:
        """Dispatch weight this shard failed to contribute: the header's
        claim when it survived corruption, else whatever still parsed."""
        if self.status == "merged":
            return 0
        return self.claimed if self.claimed is not None else self.salvaged


@dataclasses.dataclass
class MergeReport:
    """The structured result of ``Trace.merge_shards``: the merged trace
    of every healthy shard plus per-shard accounting — what merged, what
    was quarantined and why, and how much dispatch weight was dropped.
    Nothing is silent: a fleet tune sees exactly what it is tuning from.
    """
    trace: Trace
    shards: list[ShardNote]

    @property
    def merged(self) -> list[ShardNote]:
        return [n for n in self.shards if n.status == "merged"]

    @property
    def quarantined(self) -> list[ShardNote]:
        return [n for n in self.shards if n.status == "quarantined"]

    @property
    def dropped_weight(self) -> int:
        """Best-effort dispatch weight lost to quarantine (header claims
        where readable, parseable-prefix weight otherwise)."""
        return sum(n.dropped for n in self.quarantined)

    def total(self) -> int:
        return self.trace.total()

    def __len__(self) -> int:
        return len(self.trace)

    def summary(self) -> str:
        lines = [f"merge: {len(self.merged)} shard(s) merged "
                 f"({self.trace.total()} dispatches), "
                 f"{len(self.quarantined)} quarantined "
                 f"({self.dropped_weight} dispatches dropped)"]
        for n in self.quarantined:
            lines.append(f"  quarantined {n.path.name}: {n.reason} "
                         f"(claimed={n.claimed}, salvaged={n.salvaged})")
        return "\n".join(lines)


def _ingest_shard(trace_cls, path: pathlib.Path, *, verify_digest: bool) \
        -> tuple[ShardNote, list[TraceEntry]]:
    """Read one shard defensively: returns its ``ShardNote`` and (when
    healthy) its parsed entries.  Every failure mode quarantines the
    whole shard — weight accounting over partial parses is kept, but
    partially-trusted data never reaches the merged trace."""
    server = epoch = claimed = None
    try:
        text = path.read_text()
    except OSError as e:
        return ShardNote(path, None, None, "quarantined",
                         f"unreadable: {e}"), []
    head, sep, body = text.partition("\n")
    meta = None
    if head.startswith(SHARD_HEADER):
        try:
            meta = json.loads(head[len(SHARD_HEADER):])
        except ValueError:
            return ShardNote(path, None, None, "quarantined",
                             "header-corrupt"), []
    if meta is not None:
        server, epoch = meta.get("server"), meta.get("epoch")
        claimed = meta.get("dispatches")
        if not isinstance(claimed, int) or claimed < 0:
            claimed = None
        named = _shard_name_parts(path.name)
        if named is not None and (server, epoch) != named:
            return ShardNote(path, server, epoch, "quarantined",
                             f"meta-skew: header says "
                             f"({server!r}, e{epoch}), filename says "
                             f"({named[0]!r}, e{named[1]})",
                             claimed=claimed), []
        want = meta.get("sha256")
        if verify_digest and want is not None:
            if not sep or _body_digest(body) != want:
                # count what still parses, for the accounting only
                salvaged = _salvage_weight(body)
                return ShardNote(path, server, epoch, "quarantined",
                                 "digest-mismatch (torn write or "
                                 "tampering)", claimed=claimed,
                                 salvaged=salvaged), []
    else:
        body = text                       # headerless legacy trace file
    entries: list[TraceEntry] = []
    salvaged = 0
    objs: list[dict] = []
    for i, ln in enumerate(body.splitlines()):
        if not ln.strip() or ln.lstrip().startswith("#"):
            continue
        try:
            d = json.loads(ln)
            e = TraceEntry.from_dict(d)
            if e.count <= 0:
                raise ValueError(f"non-positive count {e.count}")
        except Exception as exc:
            return ShardNote(path, server, epoch, "quarantined",
                             f"parse-error at line {i + 2}: "
                             f"{type(exc).__name__}", claimed=claimed,
                             salvaged=salvaged), []
        objs.append(d)
        entries.append(e)
        salvaged += e.count
    n_v1 = sum(1 for d in objs if "v" not in d)
    if n_v1:
        warnings.warn(
            f"trace {path} carries {n_v1} schema-v1 line(s) (no 'v' "
            "key); v1 parse paths are deprecated — re-record with the "
            "current dispatcher",
            DeprecationWarning, stacklevel=2)
    return ShardNote(path, server, epoch, "merged", dispatches=salvaged,
                     claimed=claimed), entries


def _salvage_weight(body: str) -> int:
    """Dispatch weight of the lines in a corrupt shard body that still
    parse — accounting for the merge report, never merged."""
    total = 0
    for ln in body.splitlines():
        if not ln.strip() or ln.lstrip().startswith("#"):
            continue
        try:
            total += max(0, TraceEntry.from_dict(json.loads(ln)).count)
        except Exception:
            continue
    return total


class ShardRecorder:
    """A ``record=`` sink for ``api.tuned`` that samples dispatches across
    calls into a bounded cell multiset and flushes epoch-stamped
    per-server shard files — one fleet server's contribution to the next
    tuning generation.

    A plain ``record=[]`` list grows with every dispatch (the port records
    every call) for the life of a serving process; the recorder
    instead aggregates ``(cell, phase, impl) -> count`` with two bounds:

    * counts for admitted cells are exact (an int per cell is cheap);
    * DISTINCT cells are admitted by reservoir sampling (Algorithm R over
      the stream of first-seen cells): once ``max_cells`` are held, the
      ``i``-th new cell replaces a uniformly random incumbent with
      probability ``max_cells / i``, so under shape churn the shard is a
      uniform sample of the cell population and memory stays bounded.
      Evicted/undrawn dispatch weight is accounted in the shard header's
      ``dropped`` field — sampling is explicit, never silent.

    Exploration measurements (``observe``) keep at most ``reservoir``
    latency samples per (cell, impl), also via Algorithm R; they ride in
    the shard as ``#@lat`` comment lines (invisible to ``Trace`` parsers,
    read back by ``load_shard_latencies``) and feed the next epoch's
    tuning via ``tuner.FeedbackBackend``.

    ``flush(directory, epoch)`` writes ``shard-<server>-e<epoch>.jsonl``
    atomically (tmp + fsync + ``os.replace``, so a crash mid-flush leaves
    either the old file or the new one, never a torn hybrid) and RESETS
    the recorder — each shard is one epoch's window, not a cumulative
    history.  The ``#@shard`` header carries a sha256 over the shard BODY
    (everything after the header line), which ``Trace.merge_shards``
    verifies — a truncated or bit-rotted shard is quarantined, not merged.
    """

    def __init__(self, server: str, *, max_cells: int = 4096,
                 reservoir: int = 32, seed: int = 0):
        self.server = str(server)
        self.max_cells = int(max_cells)
        self.reservoir = int(reservoir)
        self._rng = random.Random(seed)
        self._reset()

    def _reset(self) -> None:
        self._counts: dict[tuple[OpCell, str, str], int] = {}
        self._keys: list[tuple[OpCell, str, str]] = []
        self._seen_keys = 0
        self.dropped = 0
        self._lat: dict[tuple[OpCell, str], list[float]] = {}
        self._lat_n: dict[tuple[OpCell, str], int] = {}

    # -- the api.tuned record sink -------------------------------------------
    def append(self, rec) -> None:
        """Record one dispatch (``DispatchRecord`` or legacy 5-tuple)."""
        if hasattr(rec, "cell"):
            key = (rec.cell, rec.phase, rec.impl)
        else:
            op, p, nbytes, impl, phase = rec
            key = (OpCell(op, p, nbytes), phase, impl)
        if key in self._counts:
            self._counts[key] += 1
            return
        self._seen_keys += 1
        if len(self._counts) < self.max_cells:
            self._counts[key] = 1
            self._keys.append(key)
            return
        j = self._rng.randrange(self._seen_keys)
        if j < self.max_cells:
            victim = self._keys[j]
            self.dropped += self._counts.pop(victim)
            self._keys[j] = key
            self._counts[key] = 1
        else:
            self.dropped += 1

    # -- exploration feedback ------------------------------------------------
    def observe(self, cell: OpCell, impl: str, latency_s: float) -> None:
        """Feed one live latency measurement for (cell, impl) — the
        exploration budget's signal back into the next epoch."""
        key = (cell, impl)
        n = self._lat_n.get(key, 0) + 1
        self._lat_n[key] = n
        buf = self._lat.setdefault(key, [])
        if len(buf) < self.reservoir:
            buf.append(float(latency_s))
            return
        j = self._rng.randrange(n)
        if j < self.reservoir:
            buf[j] = float(latency_s)

    # -- views ---------------------------------------------------------------
    def trace(self) -> Trace:
        return Trace(TraceEntry(c, ph, im, n)
                     for (c, ph, im), n in self._counts.items())

    def total(self) -> int:
        return sum(self._counts.values())

    def __len__(self) -> int:
        return len(self._counts)

    # -- disk ----------------------------------------------------------------
    def flush(self, directory: str | pathlib.Path,
              epoch: int) -> pathlib.Path:
        """Write this window's epoch-stamped shard file and reset."""
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"shard-{self.server}-e{int(epoch):06d}.jsonl"
        body_lines = [e.to_json() for e in self.trace().entries]
        for (cell, impl), buf in sorted(self._lat.items(),
                                        key=lambda kv: (kv[0][0], kv[0][1])):
            m = _cell_dict(cell)
            m.update(impl=impl, lat_s=buf,
                     observed=self._lat_n[(cell, impl)])
            body_lines.append(LAT_PREFIX + json.dumps(m))
        body = "".join(ln + "\n" for ln in body_lines)
        header = {"server": self.server, "epoch": int(epoch),
                  "cells": len(self._counts), "dispatches": self.total(),
                  "dropped": self.dropped,
                  "sha256": _body_digest(body)}
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "w") as f:
            f.write(SHARD_HEADER + json.dumps(header) + "\n")
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._reset()
        return path


def shard_meta(path: str | pathlib.Path) -> dict | None:
    """The ``#@shard`` header of one shard file, or None."""
    with open(path) as f:
        first = f.readline()
    if not first.startswith(SHARD_HEADER):
        return None
    try:
        return json.loads(first[len(SHARD_HEADER):])
    except ValueError:
        return None


def shard_digest(directory: str | pathlib.Path, *,
                 pattern: str = "shard-*.jsonl") -> str:
    """Content digest over the shard set (sorted by filename) — the
    provenance a profile generation's MANIFEST records as ``source``."""
    d = pathlib.Path(directory)
    h = hashlib.sha256()
    for p in sorted(d.glob(pattern)):
        h.update(p.name.encode())
        h.update(b"\0")
        h.update(p.read_bytes())
    return "sha256:" + h.hexdigest()


def load_shard_latencies(directory: str | pathlib.Path, *,
                         pattern: str = "shard-*.jsonl",
                         skip: "Iterable[str | pathlib.Path]" = ()) \
        -> dict[tuple[OpCell, str], list[float]]:
    """All exploration measurements across a fleet's shard files:
    ``(cell, impl) -> [latency_s, ...]`` (samples concatenated across
    servers; feed to ``tuner.FeedbackBackend``).

    Malformed ``#@lat`` lines are skipped with one warning per file — a
    corrupt shard must not take the feedback loop down.  ``skip`` names
    shards to exclude entirely (pass the quarantined paths from a
    ``MergeReport`` so a quarantined shard's measurements are not
    trusted either).
    """
    out: dict[tuple[OpCell, str], list[float]] = {}
    d = pathlib.Path(directory)
    skipped = {pathlib.Path(s).name for s in skip}
    for p in sorted(d.glob(pattern)):
        if p.name in skipped:
            continue
        try:
            text = p.read_text()
        except OSError:
            continue
        bad = 0
        for ln in text.splitlines():
            if not ln.startswith(LAT_PREFIX):
                continue
            try:
                m = json.loads(ln[len(LAT_PREFIX):])
                key = (_cell_from_dict(m), m["impl"])
                samples = [float(t) for t in m["lat_s"]]
            except Exception:
                bad += 1
                continue
            out.setdefault(key, []).extend(samples)
        if bad:
            warnings.warn(f"load_shard_latencies: skipped {bad} "
                          f"malformed #@lat line(s) in {p}")
    return out

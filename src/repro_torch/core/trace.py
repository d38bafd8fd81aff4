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
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
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

"""Performance-guideline registry (paper §3.1, Table 1).

Three guideline classes from the paper (and its predecessor [6]):

* ``pattern``          — MPI_A(n) ≤ MPI_B(n) between semantically equivalent
                         operations: GL1..GL22 (+ ⊕ extensions).
* ``monotony``         — T_op(n1) ≤ T_op(n2) for n1 ≤ n2.
* ``split_robustness`` — running the op once on n is not slower than k times
                         on n/k.

Pattern guidelines are 1:1 with mock-up implementations in
``collectives.REGISTRY`` (an Impl with ``guideline=="GL<k>"`` *is* the
right-hand side of that guideline); the listing is derived from it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.collectives import REGISTRY, Impl


@dataclasses.dataclass(frozen=True)
class Guideline:
    gl_id: str            # "GL1".."GL22" or "EXT:<name>"
    op: str               # LHS collective
    mockup: str           # RHS mock-up impl name in REGISTRY[op]
    statement: str        # human-readable A <= B

    @property
    def impl(self) -> Impl:
        return REGISTRY[self.op][self.mockup]

    def extra_bytes(self, payload_bytes: int, p: int) -> int:
        """Table-1 additional memory requirement of the mock-up."""
        return int(self.impl.extra_bytes(payload_bytes, p))


def _collect() -> list[Guideline]:
    gls: list[Guideline] = []
    for op, impls in REGISTRY.items():
        for name, impl in impls.items():
            if name == "default" or impl.guideline is None:
                continue
            gl_id = impl.guideline
            if gl_id == "EXT":
                # qualify with the op when the mock-up name alone is not
                # unique ("fused_ring")
                gl_id = (f"EXT:{name}" if "_as_" in name
                         else f"EXT:{op}.{name}")
            if impl.hier:
                stmt = (f"{op}@(inter x intra)(n) <= {name}(n)  "
                        "[per-tier decomposition must not lose to one flat "
                        "collective over the joint group when a ring step "
                        "crosses the slow tier]")
            elif name.startswith("fused_ring"):
                stmt = (f"{op}(n) <= {name}(n)  "
                        "[fused overlap must not lose to collective+matmul]")
            elif name.startswith("wire_"):
                stmt = (f"{op}(n) <= {name}(n) | err <= tol({impl.wire_dtype})"
                        "  [quantized wire must win AND hold its per-dtype "
                        "error bound — accuracy-conditional admissibility]")
            else:
                stmt = f"{op}(n) <= {name.replace('_as_', ' -> ')}(n)"
            gls.append(Guideline(gl_id=gl_id, op=op, mockup=name,
                                 statement=stmt))

    def key(g: Guideline):
        if g.gl_id.startswith("GL"):
            return (0, int(g.gl_id[2:]))
        return (1, g.gl_id)

    return sorted(gls, key=key)


GUIDELINES: list[Guideline] = _collect()

PAPER_GUIDELINES: list[Guideline] = [
    g for g in GUIDELINES if g.gl_id.startswith("GL")]

EXTENSION_GUIDELINES: list[Guideline] = [
    g for g in GUIDELINES if g.gl_id.startswith("EXT")]


def by_id(gl_id: str) -> Guideline:
    for g in GUIDELINES:
        if g.gl_id == gl_id:
            return g
    raise KeyError(gl_id)


def for_op(op: str) -> list[Guideline]:
    return [g for g in GUIDELINES if g.op == op]


def paper_coverage() -> dict[str, str]:
    """GL id -> mock-up name; asserts the full GL1..GL22 catalog is
    present."""
    cov = {g.gl_id: g.mockup for g in PAPER_GUIDELINES}
    missing = [f"GL{k}" for k in range(1, 23) if f"GL{k}" not in cov]
    if missing:
        raise AssertionError(f"guideline catalog incomplete: {missing}")
    return cov

"""Performance profiles (paper §3.2.2, Listing 1) + O(log M) lookup.

A profile is valid for ONE collective and ONE axis size — and, for the
fused collective-matmul ops, ONE matmul geometry (``cell.Geom``).  It maps
message-size ranges (bytes) to a replacement mock-up.  The text format is
the paper's Listing 1 (MPI op names, numbered algorithm table, ``lo hi
alg`` range lines) with geometry on a ``#@geom`` header and the tier on a
``#@tier`` header, both comment lines to a v1 parser; the JSON form (v2)
carries provenance.  Files are byte-compatible with the JAX package's, so
either package loads what the other wrote.

Lookup is O(1) to find the (op, p, geom, tier) profile + O(log M) bisect
over the sorted ranges.  ``lookup_cell`` resolves geometry: exact >
nearest tuned geometry (same role + dtype + p2 + tier, log-space shape
distance) > the geometry-less (op, p) profile.

Across processes (``publish``) rank 0 writes what every rank tuned, a
barrier follows, every rank loads it back, and the digests of every
rank's picks, gathered over the axis, must agree.

Fleet retuning adds an EPOCH to a saved profile directory: ``save(epoch=)``
writes a ``MANIFEST.json`` (generation number, source-shard digest,
geometry census, the demotion ledger) LAST, so a watcher that sees a new
manifest sees complete profiles.  ``resolve_stores(watch=True)`` returns a
``StoreRef``, the swappable reference ``api.tuned(store_ref=)`` contexts
read through: ``poll()`` re-reads the manifest (content-hash stamp) and
swaps the stores in place, refusing stale epochs, poisoned (rolled-back)
epochs and manifest/profile skew; ``rollback()`` reverts to a retained
generation.  Manifests are the JAX package's, byte for byte.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import warnings

import torch

from repro_torch.core import collectives as _C
from repro_torch.core.cell import Geom, OpCell

PROFILE_JSON_VERSION = 2

#: the profile-directory manifest of a fleet generation; not a profile,
#: so ``load`` skips it
MANIFEST_NAME = "MANIFEST.json"

OP_TO_MPI = {
    "allgather": "MPI_Allgather",
    "allreduce": "MPI_Allreduce",
    "alltoall": "MPI_Alltoall",
    "bcast": "MPI_Bcast",
    "gather": "MPI_Gather",
    "reduce": "MPI_Reduce",
    "reducescatter": "MPI_Reduce_scatter_block",
    "scan": "MPI_Scan",
    "exscan": "MPI_Exscan",
    "scatter": "MPI_Scatter",
    # fused collective-matmul extension ops (no MPI counterpart; MPIX_ names
    # keep the Listing-1 text profiles round-trippable)
    "allgather_matmul": "MPIX_Allgather_matmul",
    "matmul_reducescatter": "MPIX_Matmul_reduce_scatter",
    "matmul_accumulate": "MPIX_Matmul_accumulate",
    "matmul_reducescatter_2d": "MPIX_Matmul_reduce_scatter_2d",
}
MPI_TO_OP = {v: k for k, v in OP_TO_MPI.items()}


@dataclasses.dataclass(frozen=True)
class Range:
    lo: int          # bytes, inclusive
    hi: int          # bytes, inclusive
    impl: str        # mock-up name


@dataclasses.dataclass
class Profile:
    op: str
    axis_size: int
    ranges: list[Range] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)
    geom: Geom | None = None    # fused-op matmul geometry partition
    tier: str = ""              # interconnect-tier token ("" = flat)

    def __post_init__(self):
        self.ranges = sorted(self.ranges, key=lambda r: r.lo)
        self._los = [r.lo for r in self.ranges]
        for a, b in zip(self.ranges, self.ranges[1:]):
            if b.lo <= a.hi:
                raise ValueError(f"overlapping ranges {a} / {b}")

    # -- lookup ------------------------------------------------------------
    def lookup(self, nbytes: int) -> str | None:
        """Replacement impl for ``nbytes``, or None (use the default)."""
        i = bisect.bisect_right(self._los, nbytes) - 1
        if i >= 0 and self.ranges[i].lo <= nbytes <= self.ranges[i].hi:
            return self.ranges[i].impl
        return None

    def lookup_nearest(self, nbytes: int) -> str | None:
        """``lookup`` that falls back to the CLOSEST range when ``nbytes``
        misses every range (nearest-geometry resolution)."""
        hit = self.lookup(nbytes)
        if hit is not None or not self.ranges:
            return hit
        best = min(self.ranges,
                   key=lambda r: min(abs(nbytes - r.lo), abs(nbytes - r.hi)))
        return best.impl

    # -- Listing-1 text format ----------------------------------------------
    def to_text(self) -> str:
        impls = sorted({r.impl for r in self.ranges})
        ids = {name: i + 2 for i, name in enumerate(impls)}  # 1 = default
        lines = [
            "# pgtune profile v2",
            OP_TO_MPI.get(self.op, self.op),
            f"{self.axis_size} # nb. of. processes",
            f"{len(impls)} # nb. of mock-up impl.",
        ]
        if self.tier:
            lines.insert(1, f"#@tier {self.tier}")
        if self.geom is not None:
            g = self.geom
            line = (f"#@geom {g.dtype} {g.mm_k} {g.mm_m} {g.mm_n} "
                    f"{g.mm_role}")
            if g.p2:
                line += f" {g.p2}"
            lines.insert(1, line)
        lines += [f"{ids[name]} {name}" for name in impls]
        lines.append(f"{len(self.ranges)} # nb. of ranges")
        lines += [f"{r.lo} {r.hi} {ids[r.impl]}" for r in self.ranges]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_text(cls, text: str) -> "Profile":
        geom = None
        tier = ""
        for ln in text.splitlines():
            if ln.startswith("#@tier"):
                tier = ln.split(None, 1)[1].strip() if " " in ln else ""
            if ln.startswith("#@geom"):
                parts = ln.split()
                _, dt, k, m, n, role = parts[:6]
                p2 = int(parts[6]) if len(parts) > 6 else 0
                geom = Geom(dt, int(k), int(m), int(n), role, p2)
        raw = [ln.split("#")[0].strip() for ln in text.splitlines()]
        rows = [ln for ln in raw if ln]
        opname = rows[0]
        op = MPI_TO_OP.get(opname, opname)
        axis_size = int(rows[1])
        n_impl = int(rows[2])
        table: dict[int, str] = {}
        for ln in rows[3:3 + n_impl]:
            num, name = ln.split(None, 1)
            table[int(num)] = name.strip()
        n_ranges = int(rows[3 + n_impl])
        ranges = []
        for ln in rows[4 + n_impl:4 + n_impl + n_ranges]:
            lo, hi, alg = ln.split()
            ranges.append(Range(int(lo), int(hi), table[int(alg)]))
        return cls(op=op, axis_size=axis_size, ranges=ranges, geom=geom,
                   tier=tier)

    # -- JSON ----------------------------------------------------------------
    def to_json(self) -> str:
        d = {
            "version": PROFILE_JSON_VERSION,
            "op": self.op, "axis_size": self.axis_size,
            "ranges": [dataclasses.asdict(r) for r in self.ranges],
            "meta": self.meta,
        }
        if self.geom is not None:
            d["geom"] = dataclasses.asdict(self.geom)
        if self.tier:
            d["tier"] = self.tier
        return json.dumps(d, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "Profile":
        d = json.loads(text)
        geom = Geom(**d["geom"]) if d.get("geom") else None
        return cls(op=d["op"], axis_size=d["axis_size"],
                   ranges=[Range(**r) for r in d["ranges"]],
                   meta=d.get("meta", {}), geom=geom,
                   tier=d.get("tier", ""))


def _geom_tag(geom: Geom) -> str:
    """Filesystem-safe geometry suffix for profile filenames."""
    tag = (f"{geom.dtype}_k{geom.mm_k}m{geom.mm_m}n{geom.mm_n}"
           f"_{geom.mm_role}")
    if geom.p2:
        tag += f"_q{geom.p2}"
    return tag


def _tier_tag(tier: str) -> str:
    """Filesystem-safe tier suffix (the token may carry '/' and '@')."""
    return tier.replace("/", "--").replace("@", "-")


class ProfileStore:
    """All loaded profiles; the PGMPITuneD in-memory state."""

    def __init__(self, profiles: list[Profile] | None = None):
        self._by_key: dict[
            tuple[str, int, Geom | None, str], Profile] = {}
        for p in profiles or []:
            self.add(p)

    def add(self, p: Profile) -> None:
        self._by_key[(p.op, p.axis_size, p.geom, p.tier)] = p

    def get(self, op: str, axis_size: int, geom: Geom | None = None,
            tier: str = "") -> Profile | None:
        return self._by_key.get((op, axis_size, geom, tier))

    def lookup(self, op: str, axis_size: int, nbytes: int,
               tier: str = "") -> str | None:
        """Geometry-less lookup (plain collectives)."""
        p = self.get(op, axis_size, tier=tier)
        return p.lookup(nbytes) if p else None

    def lookup_cell(self, cell: OpCell) -> str | None:
        """Resolve a dispatch cell: the exact geometry profile first; on an
        exact miss (no profile for this geometry, or its ranges miss
        ``cell.nbytes``) the nearest other tuned geometry (same role +
        dtype + p2 + tier, least log-space shape distance); then the
        geometry-less (op, axis_size, tier) profile.  Every step is
        pinned to ``cell.profile_tier()``."""
        t = cell.profile_tier()
        g = cell.geom()
        if g is not None:
            prof = self._by_key.get((cell.op, cell.p, g, t))
            if prof is not None:
                hit = prof.lookup(cell.nbytes)
                if hit is not None:
                    return hit
            near = [(geom, p)
                    for (op, ax, geom, tr), p in self._by_key.items()
                    if op == cell.op and ax == cell.p and geom is not None
                    and geom != g
                    and tr == t
                    and geom.mm_role == g.mm_role
                    and geom.dtype == g.dtype
                    and geom.p2 == g.p2]
            if near:
                _, nprof = min(near,
                               key=lambda kv: (g.distance(kv[0]), kv[0]))
                hit = nprof.lookup_nearest(cell.nbytes)
                if hit is not None:
                    return hit
        return self.lookup(cell.op, cell.p, cell.nbytes, t)

    def __len__(self) -> int:
        return len(self._by_key)

    def __iter__(self):
        return iter(self._by_key.values())

    # -- disk ----------------------------------------------------------------
    def save(self, directory: str | pathlib.Path, *, fmt: str = "text",
             epoch: int | None = None,
             source_digest: str | None = None) -> None:
        """Write one file per profile (Listing-1 text or JSON v2); with
        ``epoch=`` also stamp the directory as that fleet generation by
        writing ``MANIFEST.json`` LAST (see ``write_manifest``) so
        watchers never observe a new epoch before its profiles are
        complete."""
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        for (op, p_size, geom, tier), prof in sorted(
                self._by_key.items(),
                key=lambda kv: (kv[0][0], kv[0][1], str(kv[0][2]),
                                kv[0][3])):
            stem = f"{op}_p{p_size}"
            if geom is not None:
                stem += "_" + _geom_tag(geom)
            if tier:
                stem += "_t" + _tier_tag(tier)
            if fmt == "text":
                (d / f"{stem}.pgtune").write_text(prof.to_text())
            else:
                (d / f"{stem}.json").write_text(prof.to_json())
        if epoch is not None:
            write_manifest(d, epoch, source_digest=source_digest, base=self)

    @classmethod
    def load(cls, directory: str | pathlib.Path) -> "ProfileStore":
        d = pathlib.Path(directory)
        store = cls()
        for f in sorted(d.glob("*.pgtune")):
            text = f.read_text()
            if not text.lstrip().startswith("# pgtune profile v2"):
                warnings.warn(
                    f"profile file {f} is schema v1 (no 'pgtune profile v2' "
                    "header); v1 parse paths are deprecated — re-save with "
                    "the current tuner", DeprecationWarning, stacklevel=2)
            store.add(Profile.from_text(text))
        for f in sorted(d.glob("*.json")):
            if f.name == MANIFEST_NAME:
                continue
            text = f.read_text()
            if "version" not in json.loads(text):
                warnings.warn(
                    f"profile file {f} is schema v1 (no 'version' field); "
                    "v1 parse paths are deprecated — re-save with the "
                    "current tuner", DeprecationWarning, stacklevel=2)
            store.add(Profile.from_json(text))
        return store


def _census(stores) -> dict:
    """Per-op profile/geometry counts across the given stores — the
    manifest's quick sanity view of what a generation covers."""
    out: dict[str, dict[str, int]] = {}
    geoms: dict[str, set] = {}
    for store in stores:
        if store is None:
            continue
        for prof in store:
            c = out.setdefault(prof.op, {"profiles": 0, "geometries": 0})
            c["profiles"] += 1
            if prof.geom is not None:
                geoms.setdefault(prof.op, set()).add(prof.geom)
    for op, gs in geoms.items():
        out[op]["geometries"] = len(gs)
    return out


def profiles_digest(directory: str | pathlib.Path) -> str:
    """sha256 over every profile file under ``directory`` (recursive:
    base files + phase subdirectories; the manifest itself and tmp files
    excluded) — the manifest records this at publish time and
    ``StoreRef.poll`` recomputes it at adoption, so manifest↔profile
    skew (a manifest paired with profiles it was not written for) is
    detected instead of served."""
    d = pathlib.Path(directory)
    h = hashlib.sha256()
    for p in sorted(d.rglob("*")):
        if (not p.is_file() or p.suffix not in (".pgtune", ".json")
                or p.name == MANIFEST_NAME
                or p.name.endswith(".tmp")):
            continue
        h.update(str(p.relative_to(d)).encode())
        h.update(b"\0")
        h.update(p.read_bytes())
        h.update(b"\0")
    return "sha256:" + h.hexdigest()


def write_manifest(directory: str | pathlib.Path, epoch: int, *,
                   source_digest: str | None = None,
                   base: "ProfileStore | None" = None,
                   phases: "dict[str, ProfileStore] | None" = None,
                   demotions: "dict[tuple[str, str], str] | None" = None) \
        -> pathlib.Path:
    """Stamp a profile directory as fleet generation ``epoch``.

    The manifest is the hot-swap unit: ``StoreRef.poll`` re-reads THIS
    file and reloads only when its content changes.  Callers must write
    all profile files first and the manifest last (this function writes
    via tmp + ``os.replace``, so the manifest itself appears atomically).
    ``source_digest`` records provenance — the digest of the trace shards
    the generation was tuned from (``trace.shard_digest``) — and
    ``profiles_digest`` is computed HERE, over the already-written
    profile files, so an adopting reader can verify the manifest and the
    profiles belong to the same generation.

    The publishing process's DEMOTION ledger rides along: a tuning run
    that demoted a wire impl (tolerance breach in selfcheck) must not
    publish profiles that a fresh serving process — whose own ledger is
    empty — would happily route back onto the demoted impl.  Pass
    ``demotions=`` to override; the default snapshots
    ``collectives.demotions()``.  ``StoreRef.poll`` re-applies the list
    on adoption.
    """
    if demotions is None:
        demotions = _C.demotions()
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    man = {
        "manifest_version": 1,
        "epoch": int(epoch),
        "source": source_digest,
        "profiles_digest": profiles_digest(d),
        "base_profiles": len(base) if base is not None else 0,
        "phases": {ph: len(st) for ph, st in sorted((phases or {}).items())},
        "geometry_census": _census([base, *(phases or {}).values()]),
        "demotions": [[op, name, reason] for (op, name), reason
                      in sorted(demotions.items())],
    }
    path = d / MANIFEST_NAME
    tmp = d / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(man, indent=1) + "\n")
    os.replace(tmp, path)
    return path


def _apply_demotions(man: dict) -> int:
    """Re-apply a manifest's demotion ledger to this process's
    ``collectives`` registry (the adoption half of the persistence
    round-trip).  Unknown impls — e.g. a manifest published by a newer
    build — are skipped with a warning, never fatal.  Returns the number
    of newly applied demotions."""
    rows = man.get("demotions") or []
    if not rows:
        return 0
    applied = 0
    for row in rows:
        try:
            op, name, reason = row
            if not _C.is_demoted(op, name):
                _C.demote(op, name, reason=f"manifest: {reason}")
                applied += 1
        except Exception as e:
            warnings.warn(
                f"manifest demotion entry {row!r} not applied "
                f"({type(e).__name__}: {e})")
    return applied


def read_manifest(directory: str | pathlib.Path) -> dict | None:
    """The directory's manifest dict, or None (absent / unreadable —
    legacy pre-epoch profile directories have no manifest)."""
    path = pathlib.Path(directory) / MANIFEST_NAME
    try:
        man = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return man if isinstance(man, dict) and "epoch" in man else None


class StoreRef:
    """A mutable, atomically-swappable reference to resolved profile
    stores plus their epoch — the hot-swap unit of fleet retuning.

    ``api.tuned(store_ref=ref)`` contexts read impl choices through the
    ref at dispatch time, and ``api.Plan.vector(ref)`` re-derives runtime
    dispatch plans from it — so swapping in a new generation changes what
    a running server serves without rebuilding its steps.  State is one
    tuple attribute assigned in a single store, so readers never observe
    a half-swapped generation.  ``swap`` refuses epochs older than the live
    one (the staleness rule: a delayed writer must not roll a fleet
    back); ``poll`` re-reads ``MANIFEST.json`` in the watched directory
    and swaps when a newer epoch has landed.

    Fault tolerance: the last ``history`` adopted generations are
    RETAINED in memory, so ``rollback()`` can revert a regressing epoch
    without touching disk (the ``api.EpochTripwire`` path).  A rolled-
    back epoch is POISONED — ``poll``/``swap`` refuse to re-adopt it even
    though its manifest is still the newest on disk — and adoption
    verifies the manifest's ``profiles_digest`` against the profile
    files actually present, refusing manifest↔profile skew.
    """

    def __init__(self, base: "ProfileStore | None" = None,
                 phases: "dict[str, ProfileStore] | None" = None,
                 epoch: int = -1,
                 directory: str | pathlib.Path | None = None,
                 history: int = 4):
        self._state = (int(epoch), base, dict(phases or {}))
        self.directory = pathlib.Path(directory) if directory else None
        self._stamp: str | None = None
        self.history = int(history)
        self._history: list[tuple] = []      # prior (epoch, base, phases)
        self._poisoned: set[int] = set()

    # -- reads (each reads the state tuple once; no torn views) -------------
    @property
    def epoch(self) -> int:
        return self._state[0]

    @property
    def base(self) -> "ProfileStore | None":
        return self._state[1]

    @property
    def phases(self) -> "dict[str, ProfileStore]":
        return self._state[2]

    def lookup(self, cell: OpCell, phase: str) -> str | None:
        """One consistent-generation resolution: the phase store for
        ``phase`` first, then the base store (same precedence as
        ``api.tuned(phase_profiles=..., profiles=...)``)."""
        _epoch, base, phases = self._state
        store = phases.get(phase)
        name = store.lookup_cell(cell) if store is not None else None
        if name is None and base is not None:
            name = base.lookup_cell(cell)
        return name

    # -- writes --------------------------------------------------------------
    def swap(self, base: "ProfileStore | None",
             phases: "dict[str, ProfileStore] | None",
             epoch: int) -> bool:
        """Atomically install a new generation; refuse stale,
        already-live, or poisoned (rolled-back) epochs (returns False,
        live state unchanged).  The outgoing generation is pushed onto
        the retained history so ``rollback`` can revert to it."""
        live = self.epoch
        if int(epoch) < live:
            warnings.warn(
                f"StoreRef.swap: refusing stale epoch {epoch} "
                f"(live epoch is {live})")
            return False
        if int(epoch) == live:
            return False
        if int(epoch) in self._poisoned:
            warnings.warn(
                f"StoreRef.swap: refusing poisoned epoch {epoch} "
                "(rolled back earlier; publish a fresh epoch instead)")
            return False
        if live >= 0:
            self._history.append(self._state)
            del self._history[:-self.history]
        self._state = (int(epoch), base, dict(phases or {}))
        return True

    def rollback(self) -> int | None:
        """Revert to the most recently retained generation — the
        auto-rollback path when a freshly adopted epoch regresses in the
        field.  The abandoned epoch is POISONED (never re-adopted by
        ``poll`` even though its manifest still looks newest) and the
        previous generation's stores become live again in one atomic
        assignment: readers and ``Plan.vector`` re-derivation see the
        reverted generation immediately, with no step rebuilt.  Returns the
        restored epoch, or None when no history is retained."""
        if not self._history:
            warnings.warn("StoreRef.rollback: no retained generation to "
                          "roll back to; keeping the live epoch")
            return None
        bad = self.epoch
        if bad >= 0:
            self._poisoned.add(bad)
        self._state = self._history.pop()
        warnings.warn(f"StoreRef.rollback: epoch {bad} rolled back; "
                      f"serving epoch {self.epoch} again (epoch {bad} "
                      "poisoned)")
        return self.epoch

    def poll(self) -> bool:
        """Re-read the watched directory's manifest; reload + swap when a
        NEWER epoch has landed.  Returns True iff a swap happened.  All
        failures (no directory, no/bad manifest, profile load errors,
        manifest↔profile digest skew, a poisoned epoch) leave the live
        generation serving and return False — a broken push must not
        take a fleet down.

        The staleness stamp is CONTENT-based (a hash of the manifest
        text): a same-size, same-mtime manifest replacement — which a
        ``(st_mtime_ns, st_size)`` stat stamp provably misses, since
        consecutive epochs usually serialize to the same byte length —
        still triggers adoption.  The manifest is a few hundred bytes,
        so the read-per-poll costs less than the bug did."""
        if self.directory is None:
            return False
        man_path = self.directory / MANIFEST_NAME
        try:
            text = man_path.read_text()
        except OSError:
            # legacy manifest-less directory: adopt it once as epoch 0
            if self.epoch < 0 and self.directory.is_dir():
                try:
                    base, phases = load_stores(self.directory)
                except Exception:
                    return False
                if base is None and not phases:
                    return False
                return self.swap(base, phases, 0)
            return False
        stamp = hashlib.sha256(text.encode()).hexdigest()
        if stamp == self._stamp:
            return False
        self._stamp = stamp
        try:
            man = json.loads(text)
        except ValueError:
            man = None
        if not isinstance(man, dict) or "epoch" not in man:
            return False
        epoch = int(man["epoch"])
        if epoch in self._poisoned:
            warnings.warn(
                f"StoreRef.poll: manifest at {man_path} still carries "
                f"poisoned epoch {epoch}; keeping epoch {self.epoch} "
                "(publish a fresh epoch to recover)")
            return False
        if epoch <= self.epoch:
            if epoch < self.epoch:
                warnings.warn(
                    f"StoreRef.poll: {man_path} regressed to epoch "
                    f"{epoch} (live epoch is {self.epoch}); refusing "
                    "the stale generation")
            return False
        want = man.get("profiles_digest")
        if want is not None:
            have = profiles_digest(self.directory)
            if have != want:
                # clear the stamp: the PROFILES may be repaired without
                # the manifest changing, and an unchanged-stamp
                # short-circuit would never look again (re-warning each
                # poll until the skew is fixed is the point)
                self._stamp = None
                warnings.warn(
                    f"StoreRef.poll: epoch {epoch} at {self.directory} "
                    f"has manifest/profile skew (manifest records "
                    f"{want[:18]}…, files hash to {have[:18]}…); "
                    f"keeping epoch {self.epoch}")
                return False
        try:
            base, phases = load_stores(self.directory)
        except Exception as e:
            self._stamp = None     # same repair-without-manifest logic
            warnings.warn(f"StoreRef.poll: epoch {epoch} at "
                          f"{self.directory} failed to load "
                          f"({type(e).__name__}: {e}); keeping epoch "
                          f"{self.epoch}")
            return False
        if not self.swap(base, phases, epoch):
            return False
        # the adopted generation's demotion ledger applies to THIS
        # process too — its profiles were tuned with those impls excluded
        _apply_demotions(man)
        return True


def load_stores(directory: str | pathlib.Path) \
        -> tuple["ProfileStore | None", dict[str, "ProfileStore"]]:
    """Load ``(base_store, phase_stores)`` from a profile directory: files
    at the top level form the base store, each subdirectory holding
    profiles a phase store keyed by its name (the layout
    ``tuner.TraceTuneReport.save`` writes)."""
    d = pathlib.Path(directory)
    if not d.is_dir():
        raise FileNotFoundError(f"profile directory {d} does not exist")
    base = ProfileStore.load(d)
    phases: dict[str, ProfileStore] = {}
    for sub in sorted(p for p in d.iterdir() if p.is_dir()):
        store = ProfileStore.load(sub)
        if len(store):
            phases[sub.name] = store
    return (base if len(base) else None), phases


PROFILE_DIR_ENV = "PGTUNE_PROFILE_DIR"


def resolve_stores(directory: str | pathlib.Path | None = None, *,
                   watch: bool = False):
    """Profile-loading precedence: explicit ``directory`` argument >
    ``$PGTUNE_PROFILE_DIR`` > none (returns ``(None, {})``).

    An explicit directory that is missing or malformed raises (the caller
    asked for it); a stale or broken env var only warns and serves untuned
    — it must not crash (or half-initialize profiles in) processes that
    never asked for them.  The env path is all-or-nothing: any load
    failure, including a parse error in one phase subdirectory, falls back
    to the full no-profile mode ``(None, {})``.

    With ``watch=True`` the return value is a ``StoreRef`` instead: the
    resolved directory's current generation (epoch from ``MANIFEST.json``;
    0 for a legacy manifest-less directory; -1 when nothing is loadable
    yet), watching the directory — call ``ref.poll()`` periodically to
    pick up new epochs, and hand the ref to ``api.tuned(store_ref=...)``
    / ``api.Plan.vector(ref)``.  A missing-or-empty directory is NOT an
    error in watch mode: the ref starts empty and the first poll after a
    push adopts it.
    """
    if watch:
        d = directory or os.environ.get(PROFILE_DIR_ENV, "")
        ref = StoreRef(directory=d or None)
        ref.poll()
        return ref
    if directory:
        return load_stores(directory)
    d = os.environ.get(PROFILE_DIR_ENV, "")
    if not d:
        return None, {}
    try:
        return load_stores(d)
    except FileNotFoundError:
        warnings.warn(f"${PROFILE_DIR_ENV}={d} does not exist; "
                      "serving untuned defaults")
        return None, {}
    except Exception as e:    # malformed profile text, ...: serve untuned
        warnings.warn(f"${PROFILE_DIR_ENV}={d} failed to load "
                      f"({type(e).__name__}: {e}); serving untuned "
                      "defaults")
        return None, {}


def stores_digest(base: "ProfileStore | None",
                  phases: dict[str, "ProfileStore"]) -> str:
    """sha256 of the picks of a base store and per-phase stores: every
    profile's Listing-1 text with its phase, in a fixed order."""
    lines = sorted((ph, prof.to_text())
                   for ph, store in [("", base), *sorted(phases.items())]
                   if store is not None for prof in store)
    return hashlib.sha256(json.dumps(lines).encode()).hexdigest()


def publish(report, directory: str | pathlib.Path, axis, *,
            fmt: str = "text") \
        -> tuple["ProfileStore | None", dict[str, "ProfileStore"]]:
    """Write once the profiles every rank of ``axis`` (a process axis
    over every rank that tuned) computed, and load them back on every
    rank: ``(base_store, phase_stores)``.

    ``report`` is a ``ProfileStore`` (the base store) or a
    ``tuner.TraceTuneReport`` (its per-phase stores).  The digests of
    the ranks' own picks are all-gathered and must agree; rank 0 then
    replaces ``directory`` with them, a barrier follows, and every rank
    loads the directory, whose digest must equal its own."""
    if isinstance(report, ProfileStore):
        own = stores_digest(report, {})
    else:
        own = stores_digest(None, report.phase_profiles)
    word = int.from_bytes(bytes.fromhex(own)[:8], "little", signed=True)
    got = axis.all_gather(torch.tensor([[word]], dtype=torch.int64,
                                       device=axis.device))
    words = got.flatten().tolist()
    if len(set(words)) != 1:
        raise RuntimeError(f"ranks tuned different picks: digests "
                           f"{words} (rank {axis.rank}: {word})")
    d = pathlib.Path(directory)
    if axis.rank == 0:
        shutil.rmtree(d, ignore_errors=True)
        report.save(d, fmt=fmt)
    axis.barrier()
    base, phases = load_stores(d)
    if stores_digest(base, phases) != own:
        raise RuntimeError(f"rank {axis.rank} read back other picks from "
                           f"{d} than it tuned")
    return base, phases

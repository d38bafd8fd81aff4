"""Deterministic fault injection for the fleet retuning loop.

The fleet loop's failure modes are all FILE-shaped: a server dies holding
a half-written shard (torn write), bit rot or a buggy serializer corrupts
a JSONL line, a publisher races the manifest against its profiles
(manifest/profile skew), a server silently stops flushing (death
mid-epoch), and a latency reservoir picks up a network hiccup 100× the
true cost (spike outlier).  ``ChaosMonkey`` injects each of these
DETERMINISTICALLY — a seeded RNG, explicit targets, and an event log —
so a harness's gates are exact assertions, not flake tolerances:
every injected fault is recorded as a ``ChaosEvent`` and the harness
checks that ingestion quarantined/rolled-back/flagged *exactly* those.

Injection happens at rest (mutating files a healthy writer already
produced) rather than by patching writers: the faults modeled here are
precisely the ones that occur AFTER the writer's own code ran correctly
— crashes between write and rename, storage corruption, concurrent
publishes — so post-hoc mutation is the honest simulation.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import random

from repro_torch.core.trace import LAT_PREFIX, SHARD_HEADER, _body_digest


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One injected fault, for exact-accounting assertions."""
    kind: str      # "torn-shard" | "corrupt-line" | "header-skew" |
                   # "profile-skew" | "kill-server" | "latency-spike"
    target: str    # file path or server name
    detail: str = ""


class ChaosMonkey:
    """A seeded injector; every method mutates one target and logs it.

    All randomness flows from the constructor seed, so a fixed-seed
    chaos run replays the identical fault schedule every run.
    """

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self.events: list[ChaosEvent] = []

    def _log(self, kind: str, target, detail: str = "") -> None:
        self.events.append(ChaosEvent(kind, str(target), detail))

    def of_kind(self, kind: str) -> list[ChaosEvent]:
        return [e for e in self.events if e.kind == kind]

    # -- shard faults --------------------------------------------------------
    def tear_shard(self, path: str | pathlib.Path,
                   keep_frac: float | None = None) -> pathlib.Path:
        """Truncate a shard's BODY mid-line — the on-disk state of a
        writer that died between ``write`` and ``os.replace`` on a
        filesystem that persisted a prefix.  The header (and its sha256
        claim) survives, so merge sees a digest mismatch."""
        p = pathlib.Path(path)
        text = p.read_text()
        head, _sep, body = text.partition("\n")
        if keep_frac is None:
            keep_frac = 0.25 + 0.5 * self._rng.random()
        cut = max(1, int(len(body) * keep_frac))
        p.write_text(head + "\n" + body[:cut])
        self._log("torn-shard", p, f"body cut to {cut}/{len(body)} bytes")
        return p

    def corrupt_line(self, path: str | pathlib.Path,
                     line: int | None = None) -> pathlib.Path:
        """Overwrite one body line with garbage (bit rot / serializer
        bug).  The digest no longer matches either, but with
        ``verify_digest=False`` this exercises the parse-error
        quarantine path on its own."""
        p = pathlib.Path(path)
        lines = p.read_text().splitlines()
        data_idx = [i for i, ln in enumerate(lines)
                    if ln.strip() and not ln.lstrip().startswith("#")]
        if not data_idx:
            data_idx = [len(lines) - 1]
        i = data_idx[line if line is not None
                     else self._rng.randrange(len(data_idx))]
        lines[i] = '{"op": "allreduce", "p": 4, "nbytes": ####CORRUPT####'
        p.write_text("\n".join(lines) + "\n")
        self._log("corrupt-line", p, f"line {i + 1} garbled")
        return p

    def skew_header(self, path: str | pathlib.Path, *,
                    server: str | None = None,
                    epoch: int | None = None) -> pathlib.Path:
        """Rewrite the ``#@shard`` header so it disagrees with the
        filename (a replayed/renamed shard, or tampering) — the header
        is re-serialized VALID, with a digest matching the body, so only
        the meta-skew check can catch it."""
        p = pathlib.Path(path)
        text = p.read_text()
        head, _sep, body = text.partition("\n")
        meta = json.loads(head[len(SHARD_HEADER):])
        if server is not None:
            meta["server"] = server
        if epoch is not None:
            meta["epoch"] = int(epoch)
        if server is None and epoch is None:
            meta["epoch"] = int(meta.get("epoch", 0)) + 1
        p.write_text(SHARD_HEADER + json.dumps(meta) + "\n" + body)
        self._log("header-skew", p,
                  f"header now ({meta.get('server')!r}, "
                  f"e{meta.get('epoch')})")
        return p

    def spike_latencies(self, path: str | pathlib.Path, *,
                        factor: float = 100.0,
                        per_line: int = 1) -> int:
        """Multiply ``per_line`` random samples in each ``#@lat``
        reservoir by ``factor`` — the exploration step that landed on a
        network hiccup.  The shard stays VALID (digest recomputed): the
        point is that ``FeedbackBackend``'s MAD filter, not quarantine,
        must absorb these.  Returns the number of spiked samples."""
        p = pathlib.Path(path)
        text = p.read_text()
        head, _sep, body = text.partition("\n")
        out, spiked = [], 0
        for ln in body.splitlines():
            if ln.startswith(LAT_PREFIX):
                m = json.loads(ln[len(LAT_PREFIX):])
                lat = m.get("lat_s", [])
                for _ in range(min(per_line, len(lat))):
                    i = self._rng.randrange(len(lat))
                    lat[i] = lat[i] * factor
                    spiked += 1
                m["lat_s"] = lat
                ln = LAT_PREFIX + json.dumps(m)
            out.append(ln)
        new_body = "".join(ln + "\n" for ln in out)
        meta = json.loads(head[len(SHARD_HEADER):])
        meta["sha256"] = _body_digest(new_body)
        p.write_text(SHARD_HEADER + json.dumps(meta) + "\n" + new_body)
        self._log("latency-spike", p, f"{spiked} sample(s) ×{factor:g}")
        return spiked

    # -- publisher faults ----------------------------------------------------
    def skew_profiles(self, directory: str | pathlib.Path) -> pathlib.Path:
        """Flip a profile file AFTER its manifest was written — the
        manifest/profile skew of a publisher racing a second writer (or
        a partial rollout).  ``StoreRef.poll`` must refuse the epoch on
        the ``profiles_digest`` mismatch."""
        d = pathlib.Path(directory)
        targets = sorted(p for p in d.rglob("*")
                         if p.is_file() and p.suffix in (".pgtune", ".json")
                         and p.name != "MANIFEST.json")
        if not targets:
            raise ValueError(f"no profile files under {d} to skew")
        t = targets[self._rng.randrange(len(targets))]
        with open(t, "a") as f:
            f.write("# skewed after publish\n")
        self._log("profile-skew", t, "appended after manifest write")
        return t

    # -- server faults -------------------------------------------------------
    def kill_server(self, server: str, *, at_epoch: int) -> None:
        """Mark ``server`` dead from ``at_epoch`` on.  The harness checks
        ``alive(server, epoch)`` before letting a server serve/flush —
        death is simply the absence of every later shard and heartbeat,
        exactly what a real crash leaves behind."""
        self._log("kill-server", server, f"at epoch {at_epoch}")

    def alive(self, server: str, epoch: int) -> bool:
        for e in self.events:
            if e.kind == "kill-server" and e.target == server:
                if epoch >= int(e.detail.rsplit(" ", 1)[1]):
                    return False
        return True

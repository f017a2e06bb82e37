"""Durable request journal: a crash-consistent write-ahead log of
request lifecycle.

The port's own copy of ``paddle_tpu/serving/journal.py`` (``json``,
``zlib`` and ``os`` only).  Its files are byte-compatible with the JAX
package's: a journal either package wrote, the other reads and
recovers.

Without a journal a process that dies (an OOM kill, a host reboot, a
watchdog exit) loses every queued and running request.  Every accepted
request is journaled durably enough that a *fresh process* can
rehydrate it (``Engine.recover``) and replay it from its prompt under
the stream-restart contract: restart at token 0, ``recovered`` flag
set, the journaled effective seed making greedy and seeded outputs
bitwise identical to an uninterrupted run.

Format: append-only segments of CRC-framed JSON lines.

- A journal is a **directory** of segment files ``seg-<n>.jrnl``; each
  record is one line ``<crc32 hex8> <json>\\n`` with the CRC computed
  over the exact JSON payload bytes.  A process killed mid-write can
  tear at most the FINAL record of the FINAL segment; the scanner
  truncates exactly that (counted in ``torn_records``) and treats any
  *interior* CRC/parse failure as real corruption
  (:class:`JournalCorrupt`) rather than guessing.
- Record kinds: ``admit`` (the full replay recipe: prompt ids,
  ``SamplingParams`` + the *effective* seed, priority, deadline,
  ``max_new_tokens``, eos, model version), ``tokens`` (BATCHED: one
  record per engine step covering every delivered slot, never one per
  token), ``restart`` (a preemption reset the stream mid-engine),
  ``end`` (terminal; ``final`` false for engine-level attempt ends of
  requests a fleet router owns, whose router writes the one final),
  ``weights`` (a hot-swap version bump), ``mesh_reshard`` (a replay
  across a mesh-shape change) and ``compacted`` (cumulative totals of
  what compaction pruned).  A sharded engine journals its mesh shape
  with each admission; every rank of a mesh writes the same records, so
  each rank is given a journal directory of its own.
- **Segment rotation + compaction**: the active segment rotates after
  ``segment_records`` appends; on rotation (and on explicit
  :meth:`compact`) the longest *prefix* of closed segments whose every
  referenced request is final, with all of its records inside that
  prefix, is deleted.  A long-lived journal therefore holds only the
  segments still needed to replay non-terminal work.
- **fsync policy** (``fsync=``): ``"always"`` fsyncs every append (the
  power-loss bar), ``"rotate"`` (default) fsyncs at segment
  rotation/close, ``"never"`` leaves it to the OS.  Every append is
  ``flush()``-ed regardless, so records survive process death (SIGKILL
  included) under every policy; fsync only adds the machine-crash
  guarantee.

What is deliberately NOT durable: stream *delivery* is at-least-once
across a crash (a token streamed a microsecond before the kill is
streamed again, from token 0, on the recovered run), per-request
wall-clock deadlines restart at recovery (a replay is a fresh
admission), and rejected requests are never journaled: their rejection
was already delivered synchronously to the caller.

Everything here is host-side file I/O on the scheduler thread, between
step programs: journaling adds no device sync and no step program.
"""
from __future__ import annotations

import json
import os
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

__all__ = ["RequestJournal", "JournalCorrupt"]

_FSYNC_POLICIES = ("always", "rotate", "never")
_SEG_FMT = "seg-%08d.jrnl"


class JournalCorrupt(RuntimeError):
    """An *interior* journal record failed its CRC or JSON framing.
    Only the final record of the final segment may legally be torn (a
    crash mid-append); anything else means the log was tampered with or
    the storage corrupted it, and recovery refuses to guess."""


def _seg_index(fname: str) -> Optional[int]:
    if not (fname.startswith("seg-") and fname.endswith(".jrnl")):
        return None
    try:
        return int(fname[4:-5])
    except ValueError:
        return None


class RequestJournal:
    """Append-only CRC-per-record WAL of serving request lifecycle.

    One journal serves one engine (``Engine(journal=...)``); a fleet
    router would share one instance across its replicas.
    Reopening an existing journal directory scans every segment,
    rebuilds the pending/terminal request state, and continues
    appending into a FRESH segment — a possibly-torn tail segment is
    never appended to.

    Args:
        path: journal directory (created if absent).
        fsync: ``"always" | "rotate" | "never"`` — see module docstring.
        segment_records: appends per segment before rotation (rotation
            also triggers compaction of fully-terminal prefix segments).
    """

    def __init__(self, path: str, *, fsync: str = "rotate",
                 segment_records: int = 4096):
        if fsync not in _FSYNC_POLICIES:
            raise ValueError(f"fsync must be one of {_FSYNC_POLICIES}, "
                             f"got {fsync!r}")
        if segment_records < 1:
            raise ValueError("segment_records must be >= 1, "
                             f"got {segment_records}")
        self.path = str(path)
        self.fsync = fsync
        self.segment_records = int(segment_records)
        os.makedirs(self.path, exist_ok=True)
        # replay state, rebuilt from disk on open
        self._admissions: "OrderedDict[str, dict]" = OrderedDict()
        self._tokens: Dict[str, List[int]] = {}
        self._finals: Dict[str, int] = {}
        self._final_state: Dict[str, str] = {}
        self._seg_jids: Dict[int, set] = {}
        self._jid_max_seg: Dict[str, int] = {}
        self._jid_final_seg: Dict[str, int] = {}
        self._fleet_ids: set = set()
        self._pending = None         # (jid, recovered, origin_wall)
        self.torn_records = 0
        self.records_read = 0
        self.records_written = 0
        self.compacted_segments = 0
        #: mesh_reshard records seen (written + rescanned): how many
        #: times recovery replayed this journal's pending work across a
        #: mesh-shape change (degraded-mode sharded serving)
        self.mesh_reshards = 0
        # aggregate counters for requests whose records left the disk
        # (compaction prunes their per-jid state too — the in-memory
        # maps stay bounded by the UN-compacted suffix, not by all-time
        # traffic).  Persisted as a CUMULATIVE "compacted" record in the
        # active segment at every compaction, so outcomes()/audit() —
        # and therefore the banked-counter monotonicity recovery
        # promises — survive both rotation and reopen.
        self._compacted_admitted = 0
        self._compacted_outcomes: Dict[str, int] = {}
        self._compacted_duplicates = 0
        self._in_compact = False
        self._closed_segments: List[int] = []
        existing = sorted(i for i in (
            _seg_index(f) for f in os.listdir(self.path)) if i is not None)
        for idx in existing:
            self._scan_segment(idx, last=(idx == existing[-1]))
        self._closed_segments = existing
        #: monotonically-increasing reopen marker: the first segment
        #: index this instance writes.  Engines/fleets mix it into
        #: generated journal ids so a fresh process (whose request
        #: counters restart at 0) can never collide with pre-crash ids.
        self.boot = (existing[-1] + 1) if existing else 1
        self._seg = None
        self._seg_count = 0
        self._seg_cur = self.boot - 1
        self._open_segment()
        # crash artifacts land next to the journal when no trace dir is
        # configured (obs.crashdump: "a crash/ sibling of the journal")
        from ..obs import crashdump

        crashdump.register_journal_dir(self.path)

    # -- low-level append/scan ---------------------------------------------

    def _seg_path(self, idx: int) -> str:
        return os.path.join(self.path, _SEG_FMT % idx)

    def _open_segment(self) -> None:
        self._seg_cur += 1
        self._seg_count = 0
        self._seg_jids.setdefault(self._seg_cur, set())
        self._seg = open(self._seg_path(self._seg_cur), "a",
                         encoding="utf-8")

    def _append(self, rec: dict) -> None:
        payload = json.dumps(rec, separators=(",", ":"), sort_keys=True)
        data = payload.encode("utf-8")
        self._seg.write(f"{zlib.crc32(data) & 0xFFFFFFFF:08x} {payload}\n")
        # flush ALWAYS: the OS page cache survives process death, so a
        # flushed record survives SIGKILL under every fsync policy
        self._seg.flush()
        if self.fsync == "always":
            os.fsync(self._seg.fileno())
        self.records_written += 1
        self._seg_count += 1
        self._track(rec, self._seg_cur)
        if self._seg_count >= self.segment_records and \
                not self._in_compact:    # compact()'s own record defers
            self._rotate()               # rotation to the next append

    def _rotate(self) -> None:
        if self.fsync in ("always", "rotate"):
            os.fsync(self._seg.fileno())
        self._seg.close()
        self._closed_segments.append(self._seg_cur)
        # open the next segment BEFORE compacting: compaction persists
        # its cumulative-outcomes record into the active segment
        self._open_segment()
        self.compact()

    def _track(self, rec: dict, seg: int) -> None:
        """Fold one record into the in-memory replay state."""
        kind = rec.get("kind")
        jids = []
        if kind == "admit":
            jid = rec["jid"]
            jids = [jid]
            # latest admission wins (redispatch/recovery re-admits) but
            # the ORIGINAL arrival order is kept for replay fairness
            self._admissions[jid] = rec
            self._tokens[jid] = []
        elif kind == "tokens":
            for jid, tok in rec.get("toks", {}).items():
                if isinstance(tok, list):        # speculative burst
                    self._tokens.setdefault(jid, []).extend(
                        int(x) for x in tok)
                else:
                    self._tokens.setdefault(jid, []).append(int(tok))
                jids.append(jid)
        elif kind == "restart":
            jid = rec["jid"]
            jids = [jid]
            self._tokens[jid] = []
        elif kind == "end":
            jid = rec["jid"]
            jids = [jid]
            if rec.get("final", True):
                self._finals[jid] = self._finals.get(jid, 0) + 1
                self._final_state[jid] = rec.get("state", "finished")
                self._jid_final_seg[jid] = seg
        elif kind == "mesh_reshard":
            # a shape-change replay: reference every disposed request so
            # segment containment (and therefore compaction) treats this
            # record as part of each request's history
            jids = list(rec.get("requests", {}))
            self.mesh_reshards += 1
        elif kind == "compacted":
            # CUMULATIVE totals for everything compaction ever pruned:
            # replace-semantics (later records supersede earlier ones),
            # so dropping an old compacted record with its segment is
            # harmless — every compact() writes a fresh one
            self._compacted_admitted = int(rec.get("admitted", 0))
            self._compacted_outcomes = {
                k: int(v) for k, v in rec.get("finals", {}).items()}
            self._compacted_duplicates = int(rec.get("duplicates", 0))
        for jid in jids:
            self._seg_jids.setdefault(seg, set()).add(jid)
            self._jid_max_seg[jid] = seg

    def _scan_segment(self, idx: int, last: bool) -> None:
        path = self._seg_path(idx)
        with open(path, "rb") as f:
            raw = f.read()
        lines = raw.split(b"\n")
        # a well-formed file ends with a newline → final split is empty
        tail_complete = lines and lines[-1] == b""
        if tail_complete:
            lines = lines[:-1]
        consumed = 0                     # bytes of committed records
        for i, line in enumerate(lines):
            is_final_line = (i == len(lines) - 1)
            rec, torn = None, None
            if len(line) < 10 or line[8:9] != b" ":
                torn = "framing"
            else:
                payload = line[9:]
                try:
                    want = int(line[:8], 16)
                except ValueError:
                    want, torn = None, "crc framing"
                if torn is None:
                    if (zlib.crc32(payload) & 0xFFFFFFFF) != want:
                        torn = "crc mismatch"
                    else:
                        try:
                            rec = json.loads(payload.decode("utf-8"))
                        except (ValueError, UnicodeDecodeError):
                            torn = "json parse"
            if torn is None and is_final_line and not tail_complete:
                # a record missing its newline is a cut-short append
                # even when its CRC frames (the terminator is part of
                # the commit) — treat it exactly like a torn record
                torn = "missing newline"
            if torn is not None:
                if last and is_final_line:
                    self.torn_records += 1
                    # truncate the torn bytes ON DISK: this segment
                    # stops being the last one the moment we open a
                    # fresh segment, and a later reopen would then read
                    # the tear as interior corruption.  Best-effort — a
                    # read-only reopen still tolerates it in memory.
                    try:
                        with open(path, "r+b") as f:
                            f.truncate(consumed)
                            f.flush()
                            os.fsync(f.fileno())
                    except OSError:
                        pass
                    return
                raise JournalCorrupt(
                    f"{path} line {i + 1}: {torn} on an interior record "
                    "(only the final record of the final segment may be "
                    "torn)")
            consumed += len(line) + 1
            self.records_read += 1
            self._track(rec, idx)

    # -- lifecycle records (engine/router-facing) ----------------------------

    def record_admission(self, jid: str, *, prompt_ids, sampling: dict,
                         seed_effective: int, priority: int,
                         deadline_s: Optional[float],
                         max_new_tokens: int,
                         eos_token_id: Optional[int], engine: str,
                         model_version: int,
                         recovered: bool = False,
                         mesh_shape: Optional[str] = None,
                         adapter_version: Optional[int] = None) -> None:
        """The replay recipe: everything a fresh process needs to
        re-admit this request bitwise (``seed_effective`` is the seed
        ``Engine._seed_for`` resolved at THIS admission, so an unseeded
        temperature request replays the same stream it was drawing).

        ``mesh_shape`` is the sharded engine's mesh-shape key
        (``"model=2"``) — recorded only when set, so unsharded journals
        are byte-identical to pre-sharding ones, and recovery can refuse
        to replay a sharded admission onto a different topology.
        Tenancy rides the same only-when-set discipline: the sampling
        dict's ``adapter``/``grammar`` keys and the top-level
        ``adapter_version`` appear only for tenant requests, so
        base-tenant records stay byte-identical to pre-tenancy ones —
        and recovery replays a tenant request ONLY onto the exact
        journaled adapter version (bitwise or not at all)."""
        s = dict(sampling)
        extra = {} if mesh_shape is None else {"mesh_shape": mesh_shape}
        if adapter_version is not None:
            extra["adapter_version"] = int(adapter_version)
        samp = {
            "temperature": float(s.get("temperature", 0.0)),
            "top_k": int(s.get("top_k", 0)),
            "top_p": float(s.get("top_p", 1.0)),
            "seed": (None if s.get("seed") is None
                     else int(s["seed"])),
        }
        if s.get("adapter") is not None:
            samp["adapter"] = str(s["adapter"])
        if s.get("grammar") is not None:
            samp["grammar"] = str(s["grammar"])
        self._append({
            **extra,
            "kind": "admit", "jid": jid, "wall": round(time.time(), 6),
            "prompt_ids": [int(t) for t in prompt_ids],
            # plain-python coercion: numpy scalars are not JSON
            "sampling": samp,
            "seed_effective": int(seed_effective),
            "priority": int(priority),
            "deadline_s": (None if deadline_s is None
                           else float(deadline_s)),
            "max_new_tokens": int(max_new_tokens),
            "eos_token_id": (None if eos_token_id is None
                             else int(eos_token_id)),
            "engine": engine,
            "model_version": int(model_version),
            "recovered": bool(recovered),
        })

    def record_tokens(self, engine: str, step: int,
                      toks: Dict[str, Union[int, Sequence[int]]]) -> None:
        """One BATCHED record per engine step: every slot's delivered
        token keyed by journal id (never one record per token).  A
        speculative round delivers a BURST per slot — the value may be
        a list of ints (one record per round, the same batching
        discipline; scan-side the burst appends in order)."""
        self._append({"kind": "tokens", "engine": engine,
                      "step": int(step),
                      "toks": {j: ([int(x) for x in t]
                                   if isinstance(t, (list, tuple))
                                   else int(t))
                               for j, t in toks.items()}})

    def record_restart(self, jid: str, reason: str = "preempt") -> None:
        """The stream restarted from token 0 mid-engine (preemption):
        tokens journaled before this record are superseded."""
        self._append({"kind": "restart", "jid": jid, "reason": reason})

    def record_end(self, jid: str, state: str, *, final: bool = True,
                   error: Optional[str] = None, n_tokens: int = 0,
                   engine: Optional[str] = None) -> None:
        """Terminal record.  ``final=False`` marks an engine-level
        attempt end of a fleet-owned request (the router replays it or
        writes the one final end itself)."""
        rec = {"kind": "end", "jid": jid, "state": state,
               "final": bool(final), "n_tokens": int(n_tokens),
               "wall": round(time.time(), 6)}
        if error is not None:
            rec["error"] = str(error)[:500]
        if engine is not None:
            rec["engine"] = engine
        self._append(rec)

    def record_mesh_reshard(self, engine: str,
                            old_shape: Optional[str],
                            new_shape: Optional[str],
                            requests: Dict[str, str]) -> None:
        """Recovery replayed journaled work across a mesh-shape change
        (``old_shape`` → ``new_shape``, e.g. ``"model=2"`` →
        ``"model=1"`` after a degraded rebuild).  ``requests`` maps each
        affected journal id to its disposition (``"replayed"`` /
        ``"redispatched"`` / ``"failed"``) so ``audit()`` spans the
        degradation: every request is accounted for exactly once, on
        one side of the shape change or the other."""
        self._append({"kind": "mesh_reshard", "engine": engine,
                      "old_shape": old_shape, "new_shape": new_shape,
                      "requests": {str(j): str(d)
                                   for j, d in requests.items()},
                      "wall": round(time.time(), 6)})

    def record_weight_swap(self, engine: str, version: int) -> None:
        """A rolling hot-swap bumped this engine to ``version`` — KV
        prefilled before this record was computed under older weights
        (the prefix-cache epoch bump enforces that in-process; this
        record makes it auditable)."""
        self._append({"kind": "weights", "engine": engine,
                      "version": int(version),
                      "wall": round(time.time(), 6)})

    # -- adoption (router/recovery → engine), the tracer's pattern ----------

    def begin_attempt(self, jid: str, *, fleet_owned: bool = False,
                      recovered: bool = False,
                      origin_wall: Optional[float] = None) -> None:
        """Arm the adoption window around ONE ``engine.add_request``
        call: the admission record the engine writes inside it carries
        this journal id (and, for a recovery replay, the ``recovered``
        flag plus the pre-crash admission's wall stamp for the tracer's
        cross-process resume link)."""
        if fleet_owned:
            self._fleet_ids.add(jid)
        self._pending = (jid, bool(recovered), origin_wall)

    def end_attempt(self) -> None:
        self._pending = None

    def take_pending(self):
        """The armed adoption (or None) — read by ``Engine.add_request``;
        cleared by the router's ``end_attempt`` so a raising admission
        cannot leak the window onto an unrelated request."""
        return self._pending

    def is_fleet_owned(self, jid: str) -> bool:
        return jid in self._fleet_ids

    def has_admission(self, jid: str) -> bool:
        return jid in self._admissions

    # -- replay / audit -----------------------------------------------------

    @staticmethod
    def replay_sampling(rec: dict) -> dict:
        """The bitwise-replay sampling recipe for one admission record:
        the journaled ``SamplingParams`` fields with an unseeded
        request's seed backfilled from the journaled EFFECTIVE seed —
        the replay draws the exact stream the crashed attempt was
        drawing.  One helper for every recovering caller, so the
        determinism contract cannot drift between them."""
        s = dict(rec["sampling"])
        if s.get("seed") is None:
            s["seed"] = rec["seed_effective"]
        # pre-tenancy records carry no adapter/grammar keys: backfill
        # None so SamplingParams(**s) stays constructible forever
        s.setdefault("adapter", None)
        s.setdefault("grammar", None)
        return s

    def tokens_for(self, jid: str) -> list:
        """Tokens journaled for ``jid`` since its last admission or
        restart record, in delivery order (speculative per-round bursts
        flattened) — the delivery audit surface."""
        return list(self._tokens.get(jid, []))

    def pending(self) -> "OrderedDict[str, dict]":
        """Non-terminal journaled requests — admission recorded, no
        FINAL end — keyed by journal id in original admission order.
        This is the recovery worklist ``Engine.recover``
        rehydrates."""
        return OrderedDict(
            (jid, rec) for jid, rec in self._admissions.items()
            if not self._finals.get(jid))

    def outputs(self, jid: str) -> List[int]:
        """Tokens journaled for ``jid`` since its latest admission (or
        stream restart) — the delivered stream of the current attempt."""
        return list(self._tokens.get(jid, ()))

    def outcomes(self) -> Dict[str, int]:
        """Final terminal counts by state (``finished``/``failed``/...):
        what a recovered engine banks into its metrics so the counters
        stay monotone across the restart."""
        out = dict(self._compacted_outcomes)
        for jid, n in self._finals.items():
            if n:
                st = self._final_state.get(jid, "finished")
                out[st] = out.get(st, 0) + 1
        return out

    def audit(self) -> dict:
        """The exactly-once ledger: every admitted request must reach a
        final terminal at most once *ever* — across preemption,
        redispatch, AND process crashes.  ``duplicate_terminals`` > 0
        means the recovery contract was violated."""
        dup = self._compacted_duplicates + \
            sum(1 for n in self._finals.values() if n > 1)
        # finals counts final RECORDS: compacted jids contributed one
        # outcome each plus any duplicate records
        finals = sum(self._compacted_outcomes.values()) + \
            self._compacted_duplicates + sum(self._finals.values())
        return {
            "admitted": self._compacted_admitted + len(self._admissions),
            "pending": len(self.pending()),
            "finals": finals,
            "duplicate_terminals": dup,
            "torn_records": self.torn_records,
            "records_read": self.records_read,
            "records_written": self.records_written,
            "segments": len(self._closed_segments) + 1,
            "compacted_segments": self.compacted_segments,
            "mesh_reshards": self.mesh_reshards,
        }

    # -- compaction ---------------------------------------------------------

    def compact(self) -> int:
        """Delete the longest prefix of CLOSED segments in which every
        referenced request is final and entirely contained (its final
        end AND its last record are inside the prefix).  Returns how
        many segments were deleted.  The open segment never compacts."""
        droppable, seen = 0, set()
        for k, idx in enumerate(self._closed_segments):
            seen |= self._seg_jids.get(idx, set())
            if any(not self._finals.get(j) for j in seen):
                # a pending request: every larger prefix contains it
                # too, so nothing further can become droppable
                break
            # containment is judged against THIS candidate prefix's end
            # (a request may legally straddle a rotation boundary: its
            # admit in seg N and its final in seg N+1 drop together)
            if all(self._jid_max_seg.get(j, idx) <= idx and
                   self._jid_final_seg.get(j, idx) <= idx
                   for j in seen):
                droppable = k + 1
        if not droppable:
            return 0
        dropped, rest = (self._closed_segments[:droppable],
                         self._closed_segments[droppable:])
        gone: set = set()
        for idx in dropped:
            try:
                os.unlink(self._seg_path(idx))
            except OSError:
                pass
            gone |= self._seg_jids.pop(idx, set())
        # prune the per-jid replay state along with the disk records:
        # every dropped jid is final and fully contained in the dropped
        # prefix, so only the aggregate totals are still meaningful —
        # without this, a long-lived journal's memory would grow with
        # ALL-TIME traffic even while compaction bounded the disk
        for jid in gone:
            self._admissions.pop(jid, None)
            self._tokens.pop(jid, None)
            n = self._finals.pop(jid, 0)
            st = self._final_state.pop(jid, "finished")
            self._jid_max_seg.pop(jid, None)
            self._jid_final_seg.pop(jid, None)
            self._fleet_ids.discard(jid)
            self._compacted_admitted += 1
            if n:
                # one OUTCOME per request (duplicates counted apart,
                # matching the live outcomes()/audit() split)
                self._compacted_outcomes[st] = \
                    self._compacted_outcomes.get(st, 0) + 1
            self._compacted_duplicates += max(0, n - 1)
        self._closed_segments = rest
        self.compacted_segments += len(dropped)
        if gone:
            # persist the new cumulative totals in the ACTIVE segment
            # (which this compaction cannot have dropped): a reopen —
            # and therefore recovery's outcome banking — sees the same
            # all-time counts the live process does
            self._in_compact = True
            try:
                self._append({"kind": "compacted",
                              "admitted": self._compacted_admitted,
                              "finals": dict(self._compacted_outcomes),
                              "duplicates": self._compacted_duplicates})
            finally:
                self._in_compact = False
        return len(dropped)

    # -- lifecycle ----------------------------------------------------------

    def flush(self) -> None:
        if self._seg is not None and not self._seg.closed:
            self._seg.flush()
            if self.fsync != "never":
                os.fsync(self._seg.fileno())

    def close(self) -> None:
        if self._seg is not None and not self._seg.closed:
            self.flush()
            self._seg.close()
        from ..obs import crashdump

        crashdump.unregister_journal_dir(self.path)

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """JSON-ready observability snapshot (exported through the
        engine's ``stats()["durability"]`` section)."""
        return {"path": self.path, "fsync": self.fsync, "boot": self.boot,
                **self.audit()}

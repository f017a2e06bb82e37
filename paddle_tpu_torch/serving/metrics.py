"""Serving metrics the engine's ``stats()`` reads: time to first token,
inter-token latency, decode tokens/s, queue depth and slot occupancy, the
request and token counters behind them, the step programs' hit/miss
counters (``compile_cache``) that back the zero-recapture steady state,
and the failure-path and overload counters (cancelled, rejected and
deadline-expired requests, step failures and retries by point,
preemptions and sheds), and the durability counters (requests recovered
from a journal, the outcomes banked from it, weight swaps and the
model version), the speculative rounds' counters (rounds, draft and
verify steps, proposed and accepted draft tokens), and the per-tenant
section (``tenants``: TTFT, completed, failed and tokens by tenant label,
the adapter name, ``"grammar:<name>"`` or ``"base"``; adapter loads and
unloads), and the prefix cache's degraded mode (lookups that raised or
ran past their budget and served as misses, and registrations that
raised), which ``stats()["paging"]`` shows; and :class:`FleetMetrics`,
the sink of one :class:`~.router.Fleet` (request outcomes counted exactly
once, dispatch decisions, the supervision loop's ejections, rebuilds and
failover recovery time, crash recoveries and weight rolls).

A slice of ``paddle_tpu/serving/metrics.py``.  Times are host clock
(``perf_counter``) around work that ends in a device synchronisation: a
first token is timed when its value reaches the host, a decode step when
its sampled tokens do.
"""
from __future__ import annotations

import copy
import time
from collections import deque
from typing import Dict, Optional

__all__ = ["ServingMetrics", "FleetMetrics"]

_LATENCY_WINDOW = 4096


def _dist(xs) -> Dict[str, float]:
    if not xs:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    s = sorted(xs)
    n = len(s)

    def q(p):
        return s[min(n - 1, int(p * (n - 1) + 0.5))]

    return {"count": n, "mean": sum(s) / n, "p50": q(0.5), "p99": q(0.99),
            "max": s[-1]}


def _ms(d: Dict[str, float]) -> Dict[str, float]:
    return {k: (v if k == "count" else round(v * 1e3, 3))
            for k, v in d.items()}


class ServingMetrics:
    """Mutable metric sink for one ``serving.Engine``."""

    def __init__(self, name: str = "engine", num_slots: int = 1):
        self.name = name
        self.num_slots = num_slots
        self.t_start = time.perf_counter()
        self.requests_enqueued = 0
        self.requests_admitted = 0
        self.requests_completed = 0
        self.requests_failed = 0
        self.requests_rejected = 0
        self.requests_cancelled = 0
        self.deadline_expired = 0
        self.callback_errors = 0
        # the prefix cache's degraded mode: lookups that raised or ran past
        # their budget (served as misses) and registrations that raised
        self.prefix_lookup_errors = 0
        self.prefix_register_errors = 0
        # preemption evictions and SLO-shed admissions (a shed also
        # counts as a rejection; this counter names the cause)
        self.requests_preempted = 0
        self.requests_shed = 0
        # durability: journal replays, the pre-crash outcomes banked from
        # the journal, and in-place weight swaps
        self.requests_recovered = 0
        self.banked_outcomes: Dict[str, int] = {}
        self.weight_swaps = 0
        self.model_version = 0
        self.step_failures = 0
        self.step_retries = 0
        self.retries_by_point: Dict[str, int] = {}
        self.queue_depth = 0
        self.queue_depth_max = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.decode_steps = 0
        self.decode_time_s = 0.0
        self.prefill_time_s = 0.0
        self.prefills_by_bucket: Dict[int, int] = {}
        self.compile_hits = 0
        self.compile_misses = 0
        # speculative decoding: per-round proposal and acceptance counts;
        # spec_cb (set by an engine that speculates) gives the
        # configuration half of the section
        self.spec_rounds = 0
        self.spec_draft_steps = 0
        self.spec_verify_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_cb = None
        # multi-tenant serving: per-tenant SLO accounting (a tenant shows
        # at its first request) and the adapter lifecycle counters
        self.tenants: Dict[str, dict] = {}
        self.adapter_loads = 0
        self.adapter_unloads = 0
        self.ttft_s: deque = deque(maxlen=_LATENCY_WINDOW)
        self.itl_s: deque = deque(maxlen=_LATENCY_WINDOW)
        self._occupancy_sum = 0.0
        self._occupancy_samples = 0
        self._slots_busy = 0

    def on_enqueue(self, depth: int) -> None:
        self.requests_enqueued += 1
        self.queue_depth = depth
        self.queue_depth_max = max(self.queue_depth_max, depth)

    def on_admit(self, bucket: int, prompt_len: int, depth: int) -> None:
        self.requests_admitted += 1
        self.prefill_tokens += prompt_len
        self.prefills_by_bucket[bucket] = \
            self.prefills_by_bucket.get(bucket, 0) + 1
        self.queue_depth = depth

    def _tenant(self, tenant: str) -> dict:
        t = self.tenants.get(tenant)
        if t is None:
            t = self.tenants[tenant] = {
                "ttft_s": deque(maxlen=_LATENCY_WINDOW),
                "completed": 0, "failed": 0, "tokens": 0}
        return t

    def on_first_token(self, ttft_s: float,
                       tenant: Optional[str] = None) -> None:
        self.ttft_s.append(ttft_s)
        if tenant is not None:
            self._tenant(tenant)["ttft_s"].append(ttft_s)

    def on_decode_step(self, n_active: int, step_s: float) -> None:
        self.decode_steps += 1
        self.decode_tokens += n_active
        self.decode_time_s += step_s
        self.itl_s.extend([step_s] * n_active)

    def on_spec_round(self, step_s: float, *, draft_steps: int,
                      proposed: int, accepted: int, delivered) -> None:
        """One speculative round: ``draft_steps`` draft steps and one
        verify step delivered ``delivered[i]`` tokens to each running slot
        (``accepted`` of the ``proposed`` draft tokens survived).  Folds
        into the decode counters as a decode step does, a burst of ``n``
        tokens pricing each at ``step_s / n`` in the ITL window, so
        tokens/s and ITL compare across modes."""
        self.spec_rounds += 1
        self.spec_draft_steps += int(draft_steps)
        self.spec_verify_steps += 1
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)
        self.decode_steps += 1
        self.decode_time_s += step_s
        for n in delivered:
            if n > 0:
                self.decode_tokens += n
                self.itl_s.extend([step_s / n] * n)

    def _speculation_section(self):
        """The speculative counters, or None when the engine does not
        speculate (the snapshot's shape says which mode served)."""
        if self.spec_cb is None:
            return None
        out = dict(self.spec_cb())
        out.update({
            "rounds": self.spec_rounds,
            "draft_steps": self.spec_draft_steps,
            "verify_steps": self.spec_verify_steps,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "accept_rate": round(self.spec_accepted / self.spec_proposed, 4)
            if self.spec_proposed else 0.0,
            "mean_accepted_per_round": round(
                self.spec_accepted / self.spec_rounds, 4)
            if self.spec_rounds else 0.0,
        })
        return out

    def on_compile(self, miss: bool) -> None:
        """One step-program call: a miss builds the program (a CUDA graph
        capture on the card), a hit reuses it."""
        if miss:
            self.compile_misses += 1
        else:
            self.compile_hits += 1

    def on_complete(self, tenant: Optional[str] = None,
                    n_tokens: int = 0) -> None:
        self.requests_completed += 1
        if tenant is not None:
            t = self._tenant(tenant)
            t["completed"] += 1
            t["tokens"] += int(n_tokens)

    def on_fail(self, tenant: Optional[str] = None) -> None:
        self.requests_failed += 1
        if tenant is not None:
            self._tenant(tenant)["failed"] += 1

    def on_adapter_load(self) -> None:
        """A LoRA adapter was loaded (or hot-swapped) into a lane."""
        self.adapter_loads += 1

    def on_adapter_unload(self) -> None:
        self.adapter_unloads += 1

    def _tenants_section(self) -> dict:
        """Per-tenant gauges by tenant label and the adapter counters;
        always present (``by_tenant`` empty before the first request)."""
        by_tenant = {}
        for name in sorted(self.tenants):
            t = self.tenants[name]
            by_tenant[name] = {"completed": t["completed"],
                               "failed": t["failed"],
                               "tokens": t["tokens"],
                               "ttft_ms": _ms(_dist(t["ttft_s"]))}
        return {"adapter_loads": self.adapter_loads,
                "adapter_unloads": self.adapter_unloads,
                "by_tenant": by_tenant}

    def on_reject(self) -> None:
        self.requests_rejected += 1

    def on_cancel(self) -> None:
        self.requests_cancelled += 1

    def on_deadline(self) -> None:
        self.deadline_expired += 1

    def on_callback_error(self) -> None:
        self.callback_errors += 1

    def on_prefix_lookup_error(self) -> None:
        """A raising or over-budget prefix-cache lookup served as a miss
        (the request prefills its whole prompt)."""
        self.prefix_lookup_errors += 1

    def on_prefix_register_error(self) -> None:
        """Registering a prompt's blocks for reuse raised: the request is
        unaffected, later requests just cannot hit this prompt.  Counted
        apart from lookup errors, so the two degraded modes stay
        distinguishable."""
        self.prefix_register_errors += 1

    def on_preempt(self, depth: int) -> None:
        """A running request was evicted for a higher-priority admission
        and requeued (not a terminal outcome: the request resumes)."""
        self.requests_preempted += 1
        self.queue_depth = depth
        self.queue_depth_max = max(self.queue_depth_max, depth)

    def on_shed(self) -> None:
        """An admission was SLO-shed: its estimated queue wait already
        exceeded its deadline."""
        self.requests_shed += 1

    def bank_outcomes(self, outcomes: Dict[str, int]) -> None:
        """Fold a recovered journal's pre-crash terminal counts into the
        live counters (``Engine.recover``): a restarted engine's
        completed and failed counts continue from where the crashed
        process left off instead of starting at zero.  The banked dict
        stays visible in the snapshot."""
        total = 0
        for state, n in outcomes.items():
            self.banked_outcomes[state] = \
                self.banked_outcomes.get(state, 0) + int(n)
            total += int(n)
        # every banked outcome was enqueued, and rejections aside
        # admitted, in the crashed process
        self.requests_enqueued += total
        self.requests_admitted += total - int(outcomes.get("rejected", 0))
        self.requests_completed += int(outcomes.get("finished", 0))
        self.requests_failed += int(outcomes.get("failed", 0))
        self.requests_cancelled += int(outcomes.get("cancelled", 0))
        self.requests_rejected += int(outcomes.get("rejected", 0))

    def on_recovered(self) -> None:
        """One journaled non-terminal request was re-enqueued by crash
        recovery."""
        self.requests_recovered += 1

    def on_weight_swap(self, version: int) -> None:
        """The engine's weights were swapped in place (idle engine,
        parameters written through, prefix epoch bumped)."""
        self.weight_swaps += 1
        self.model_version = int(version)

    def on_step_failure(self, point: str) -> None:
        self.step_failures += 1

    def on_retry(self, point: str) -> None:
        self.step_retries += 1
        self.retries_by_point[point] = \
            self.retries_by_point.get(point, 0) + 1

    def on_slots(self, busy: int) -> None:
        self._slots_busy = busy
        self._occupancy_sum += busy / max(self.num_slots, 1)
        self._occupancy_samples += 1

    def tokens_per_sec(self) -> float:
        return self.decode_tokens / self.decode_time_s \
            if self.decode_time_s > 0 else 0.0

    def occupancy(self) -> float:
        return self._occupancy_sum / self._occupancy_samples \
            if self._occupancy_samples else 0.0

    def snapshot(self) -> dict:
        """The ``/stats`` payload: a JSON-ready dict that shares no
        mutable state with the metrics (a caller may change it freely)."""
        return copy.deepcopy({
            "name": self.name,
            "uptime_s": round(time.perf_counter() - self.t_start, 3),
            "requests": {"enqueued": self.requests_enqueued,
                         "admitted": self.requests_admitted,
                         "completed": self.requests_completed,
                         "failed": self.requests_failed,
                         "rejected": self.requests_rejected,
                         "running": self._slots_busy},
            "failures": {
                "failed": self.requests_failed,
                "cancelled": self.requests_cancelled,
                "rejected": self.requests_rejected,
                "deadline_expired": self.deadline_expired,
                "callback_errors": self.callback_errors,
                "step_failures": self.step_failures,
                "step_retries": self.step_retries,
                "retries_by_point": dict(sorted(
                    self.retries_by_point.items())),
            },
            "overload": {"preemptions": self.requests_preempted,
                         "shed": self.requests_shed},
            "durability": {
                "recovered": self.requests_recovered,
                "banked": dict(sorted(self.banked_outcomes.items())),
                "weight_swaps": self.weight_swaps,
                "model_version": self.model_version,
            },
            "speculation": self._speculation_section(),
            "tenants": self._tenants_section(),
            "queue_depth": self.queue_depth,
            "queue_depth_max": self.queue_depth_max,
            "slot_occupancy": round(self.occupancy(), 4),
            "slots": {"total": self.num_slots, "busy": self._slots_busy},
            "tokens": {"prefill": self.prefill_tokens,
                       "decode": self.decode_tokens},
            "decode_steps": self.decode_steps,
            "decode_tokens_per_sec": round(self.tokens_per_sec(), 2),
            "prefill_time_s": round(self.prefill_time_s, 4),
            "ttft_ms": _ms(_dist(self.ttft_s)),
            "inter_token_ms": _ms(_dist(self.itl_s)),
            "prefills_by_bucket": dict(sorted(
                self.prefills_by_bucket.items())),
            "compile_cache": {"hits": self.compile_hits,
                              "misses": self.compile_misses},
        })


class FleetMetrics:
    """Mutable metric sink for one ``serving.router.Fleet``.

    Counts the fleet's request outcomes (a terminal state is recorded
    here exactly once per request; ``duplicate_terminals`` is the audit
    that the contract held), its dispatch decisions (all, by prefix
    affinity, pinned by the caller) and the supervision loop's actions:
    ejections, rebuilds with the measured eject-to-rejoin time (the
    failover recovery), redispatches; crash recoveries and weight rolls;
    and the degraded rebuilds of shard groups (a group rebuilt at a smaller
    viable model-parallel degree after it lost a device)."""

    def __init__(self, name: str = "fleet", num_replicas: int = 1):
        self.name = name
        self.num_replicas = num_replicas
        self.t_start = time.perf_counter()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.rejected = 0
        self.duplicate_terminals = 0     # must stay 0: exactly-once audit
        self.dispatches = 0
        self.affinity_hits = 0
        self.affinity_hit_tokens = 0
        self.pinned_dispatches = 0
        self.redispatches = 0
        self.ejections = 0
        self.rebuilds = 0
        self.rebuild_failures = 0
        self.last_recovery_s: Optional[float] = None
        self.total_recovery_s = 0.0
        self.degrades = 0
        self.last_degrade_old_mp: Optional[int] = None
        self.last_degrade_mp: Optional[int] = None
        self.last_degrade_s: Optional[float] = None
        self.total_degrade_s = 0.0
        self.banked_outcomes: Dict[str, int] = {}
        self.requests_recovered = 0
        self.crash_recoveries = 0
        self.last_crash_recovery_s: Optional[float] = None
        self.weight_rolls = 0
        self.last_roll_s: Optional[float] = None
        self.model_version = 0
        #: the router's per-replica table (state, queue, occupancy)
        self.replicas_cb = None

    def on_submit(self) -> None:
        self.submitted += 1

    def on_terminal(self, state: str) -> None:
        if state == "finished":
            self.completed += 1
        elif state == "failed":
            self.failed += 1
        elif state == "cancelled":
            self.cancelled += 1
        elif state == "rejected":
            self.rejected += 1

    def on_duplicate_terminal(self) -> None:
        self.duplicate_terminals += 1

    def on_dispatch(self, affinity_tokens: int = 0,
                    pinned: bool = False) -> None:
        self.dispatches += 1
        if pinned:
            self.pinned_dispatches += 1
        elif affinity_tokens > 0:
            self.affinity_hits += 1
            self.affinity_hit_tokens += affinity_tokens

    def on_redispatch(self) -> None:
        self.redispatches += 1

    def on_eject(self) -> None:
        self.ejections += 1

    def on_rebuild(self, recovery_s: float, ok: bool = True) -> None:
        if ok:
            self.rebuilds += 1
            self.last_recovery_s = recovery_s
            self.total_recovery_s += recovery_s
        else:
            self.rebuild_failures += 1

    def on_degrade(self, old_mp: int, new_mp: int,
                   recovery_s: float) -> None:
        """A shard group was rebuilt at ``new_mp < old_mp`` on its
        surviving ranks; ``recovery_s`` is the eject-to-rejoin time that
        ``on_rebuild`` records too (a degrade is also a rebuild)."""
        self.degrades += 1
        self.last_degrade_old_mp = int(old_mp)
        self.last_degrade_mp = int(new_mp)
        self.last_degrade_s = recovery_s
        self.total_degrade_s += recovery_s

    def bank_outcomes(self, outcomes: Dict[str, int]) -> None:
        """Fold a recovered journal's pre-crash final outcomes into the
        counters (``Fleet.recover``), so they stay monotone across a
        process restart."""
        total = 0
        for state, n in outcomes.items():
            self.banked_outcomes[state] = \
                self.banked_outcomes.get(state, 0) + int(n)
            total += int(n)
        self.submitted += total
        self.completed += int(outcomes.get("finished", 0))
        self.failed += int(outcomes.get("failed", 0))
        self.cancelled += int(outcomes.get("cancelled", 0))
        self.rejected += int(outcomes.get("rejected", 0))

    def on_crash_recovery(self, replayed: int, recovery_s: float) -> None:
        self.crash_recoveries += 1
        self.requests_recovered += int(replayed)
        self.last_crash_recovery_s = recovery_s

    def on_weight_roll(self, version: int, roll_s: float) -> None:
        self.weight_rolls += 1
        self.last_roll_s = roll_s
        self.model_version = int(version)

    def affinity_hit_rate(self) -> float:
        """The share of routed dispatches (pins excluded: they bypass the
        policy) that landed on a replica already holding a prompt
        prefix."""
        routed = self.dispatches - self.pinned_dispatches
        return self.affinity_hits / routed if routed else 0.0

    def snapshot(self) -> dict:
        """JSON-ready snapshot, deep-copied: mutating it cannot touch the
        live counters or the replica table."""
        def ms(s):
            return None if s is None else round(s * 1e3, 3)

        return copy.deepcopy({
            "name": self.name,
            "uptime_s": round(time.perf_counter() - self.t_start, 3),
            "requests": {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "rejected": self.rejected,
                "duplicate_terminals": self.duplicate_terminals,
            },
            "dispatch": {
                "total": self.dispatches,
                "affinity_hits": self.affinity_hits,
                "affinity_hit_tokens": self.affinity_hit_tokens,
                "affinity_hit_rate": round(self.affinity_hit_rate(), 4),
                "pinned": self.pinned_dispatches,
                "redispatches": self.redispatches,
            },
            "supervision": {
                "ejections": self.ejections,
                "rebuilds": self.rebuilds,
                "rebuild_failures": self.rebuild_failures,
                "last_recovery_ms": ms(self.last_recovery_s),
                "total_recovery_ms": round(self.total_recovery_s * 1e3, 3),
            },
            "degraded": {
                "degrades": self.degrades,
                "last_old_mp": self.last_degrade_old_mp,
                "last_mp": self.last_degrade_mp,
                "last_degrade_ms": ms(self.last_degrade_s),
                "total_degrade_ms": round(self.total_degrade_s * 1e3, 3),
            },
            "durability": {
                "crash_recoveries": self.crash_recoveries,
                "recovered": self.requests_recovered,
                "last_crash_recovery_ms": ms(self.last_crash_recovery_s),
                "banked": dict(sorted(self.banked_outcomes.items())),
                "weight_rolls": self.weight_rolls,
                "last_roll_ms": ms(self.last_roll_s),
                "model_version": self.model_version,
            },
            "replicas": (self.replicas_cb()
                         if self.replicas_cb is not None else None),
        })

"""Elastic training manager: node registry, heartbeat lease, scale-in/out.

The port's copy of ``paddle_tpu/distributed/fleet/elastic/manager.py``
(plain Python; nothing of it is imported).  Reference:
python/paddle/distributed/fleet/elastic/manager.py — ElasticManager
(:131), lease_heartbeat (:253), _match (:397), _update_elastic_scale_out/in
(:469/:490), watch (:577).

The data-plane rendezvous is ``torch.distributed`` (the launcher's
``PADDLE_MASTER`` and the rank a worker is given), so what elasticity has
to manage is the control plane: which hosts are members, what each host's
stable rank is after joins and leaves, and when to relaunch.  The
coordinator client is an etcd-v3-shaped duck (put/get/get_prefix/lease/
watch); tests and single-host runs use :class:`InMemoryCoordinator`, a
shared directory :class:`FileCoordinator`.  Rank regeneration keeps the
reference's min-movement contract: surviving hosts keep their rank
wherever possible.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import quote, unquote

ELASTIC_TIMEOUT = 120            # elastic window (reference :41)
ELASTIC_TTL = 60                 # node lease ttl seconds
ELASTIC_EXIT_CODE = 101          # relaunch-needed exit code (reference :44)


def health_prefix(job_id: str) -> str:
    """Coordinator prefix the mesh watchdog publishes per-host health
    under — a sibling of the manager's ``.../nodes/`` membership prefix,
    same job namespace, so one coordinator carries both planes."""
    return f"/paddle_tpu/elastic/{job_id}/health/"


class ElasticLevel:
    FAULT_TOLERANCE = 1          # fixed np; rejoin under the same size
    ELASTIC = 2                  # np may move within [min_np, max_np]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class LauncherInterface:
    """What the manager drives (reference manager.py:61).  `launch` starts
    the local workers, `watch` polls them (None = running, 0 = done,
    other = failed), `stop` tears them down."""

    def launch(self):
        raise NotImplementedError

    def watch(self) -> Optional[int]:
        raise NotImplementedError

    def stop(self):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------

class _Lease:
    def __init__(self, coord, key, ttl):
        self._coord = coord
        self.key = key
        self.ttl = ttl
        self.expires = time.monotonic() + ttl
        self.revoked = False

    def refresh(self):
        if self.revoked:
            raise RuntimeError("lease revoked")
        self.expires = time.monotonic() + self.ttl
        self._coord._touch(self.key)

    def revoke(self):
        self.revoked = True
        self._coord._expire(self.key)


class InMemoryCoordinator:
    """etcd-v3-shaped in-process store with real TTL + watch semantics —
    lets the elastic tests exercise lease expiry and membership churn
    without a server (the reference mocks etcd entirely;
    test_fleet_elastic_manager.py MockEtcdClient)."""

    def __init__(self):
        self._kv: Dict[str, bytes] = {}
        self._leases: Dict[str, _Lease] = {}     # key -> lease
        self._watches: Dict[int, Tuple[str, Callable]] = {}
        self._next_watch = 0
        self._lock = threading.RLock()

    # -- kv -------------------------------------------------------------
    def put(self, key: str, value, lease: Optional[_Lease] = None):
        value = value if isinstance(value, bytes) else str(value).encode()
        with self._lock:
            self._kv[key] = value
            if lease is not None:
                lease.key = key
                self._leases[key] = lease
        self._notify(key)

    def get(self, key: str):
        with self._lock:
            self._gc()
            return self._kv.get(key), key

    def get_prefix(self, prefix: str):
        with self._lock:
            self._gc()
            return [(v, k) for k, v in sorted(self._kv.items())
                    if k.startswith(prefix)]

    def delete(self, key: str):
        with self._lock:
            existed = self._kv.pop(key, None) is not None
            self._leases.pop(key, None)
        if existed:
            self._notify(key)
        return existed

    def delete_prefix(self, prefix: str):
        with self._lock:
            keys = [k for k in self._kv if k.startswith(prefix)]
            for k in keys:
                self._kv.pop(k, None)
                self._leases.pop(k, None)
        for k in keys:
            self._notify(k)

    # -- leases ----------------------------------------------------------
    def lease(self, ttl: int) -> _Lease:
        return _Lease(self, None, ttl)

    def _touch(self, key):
        pass    # expiry tracked on the lease object

    def _expire(self, key):
        if key is not None:
            self.delete(key)

    def _gc(self):
        now = time.monotonic()
        dead = [k for k, l in self._leases.items()
                if l.expires < now or l.revoked]
        for k in dead:
            self._kv.pop(k, None)
            self._leases.pop(k, None)
        for k in dead:
            self._notify(k)

    def sweep(self):
        """Expire overdue leases now (tests call this; a real etcd does
        it server-side)."""
        with self._lock:
            self._gc()

    # -- watches ---------------------------------------------------------
    def add_watch_prefix_callback(self, prefix: str, callback) -> int:
        with self._lock:
            self._next_watch += 1
            self._watches[self._next_watch] = (prefix, callback)
            return self._next_watch

    def cancel_watch(self, watch_id: int):
        with self._lock:
            self._watches.pop(watch_id, None)

    def _notify(self, key: str):
        with self._lock:
            cbs = [cb for p, cb in self._watches.values()
                   if key.startswith(p)]
        for cb in cbs:
            try:
                cb(key)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

def _parse_np(np_spec) -> Tuple[int, int]:
    """"4" -> (4,4); "2:8" -> (2,8) (reference _parse_np:361)."""
    if isinstance(np_spec, int):
        if np_spec < 1:
            raise ValueError(f"invalid np spec {np_spec!r}")
        return np_spec, np_spec
    s = str(np_spec)
    if ":" in s:
        lo, hi = s.split(":")
        lo, hi = int(lo), int(hi)
    else:
        lo = hi = int(s)
    if lo < 1 or hi < lo:
        raise ValueError(f"invalid np spec {np_spec!r}")
    return lo, hi


class ElasticManager:
    def __init__(self, coordinator, job_id: str, np, curr_host: str,
                 elastic_level: int = ElasticLevel.FAULT_TOLERANCE,
                 elastic_timeout: float = ELASTIC_TIMEOUT,
                 lease_ttl: float = ELASTIC_TTL,
                 heartbeat_interval: Optional[float] = None):
        self.coord = coordinator
        self.job_id = job_id
        self.min_np, self.max_np = _parse_np(np)
        self.curr_host = curr_host
        self.elastic_level = (ElasticLevel.ELASTIC
                              if self.min_np != self.max_np
                              else int(elastic_level))
        self.elastic_timeout = float(elastic_timeout)
        self.lease_ttl = float(lease_ttl)

        self.prefix = f"/paddle_tpu/elastic/{job_id}"
        self.node_prefix = f"{self.prefix}/nodes/"
        self.endpoints_path = f"{self.prefix}/endpoints"

        self.np = self.max_np if self.elastic_level == \
            ElasticLevel.FAULT_TOLERANCE else self.min_np
        self.hosts: List[str] = []
        self.trainer_hosts: List[str] = []   # rank-ordered membership
        self.stopped = False
        self.need_sync = False
        self._elastic_startup_time = None
        # worker-fault relaunch budget (reference fault-tolerance window,
        # _update_fault_tolrance :443); launch wires --max_restarts here
        self.fault_count = 0
        self.max_faults = 3

        # register self under a lease and keep it alive
        self._lease = self.coord.lease(self.lease_ttl)
        self.coord.put(self.node_prefix + curr_host, curr_host,
                       lease=self._lease)
        hb = heartbeat_interval if heartbeat_interval is not None \
            else max(self.lease_ttl / 3.0, 0.05)
        self._hb_interval = hb
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._lease_heartbeat, daemon=True)
        self._hb_thread.start()

        # membership watch: any node join/leave marks a pending resync
        self._watch_id = self.coord.add_watch_prefix_callback(
            self.node_prefix, self._host_callback)

    # -- heartbeat (reference lease_heartbeat :253) -----------------------
    def _lease_heartbeat(self):
        while not self._hb_stop.wait(self._hb_interval):
            try:
                self._lease.refresh()
            except Exception:
                # lease lost: re-register so a transient coordinator blip
                # does not evict a healthy node (reference :266) — but only
                # while a slot is free.  If a replacement already filled the
                # membership, barging back in would make it over-capacity
                # and unlaunchable for everyone; keep ticking instead and
                # take the next vacancy.
                try:
                    others = [h for h in self._current_hosts()
                              if h != self.curr_host]
                    cap = (self.np if self.elastic_level ==
                           ElasticLevel.FAULT_TOLERANCE else self.max_np)
                    if len(others) < cap:
                        self._lease = self.coord.lease(self.lease_ttl)
                        self.coord.put(self.node_prefix + self.curr_host,
                                       self.curr_host, lease=self._lease)
                except Exception:
                    pass

    def _host_callback(self, _event):
        self.need_sync = True

    # -- membership -------------------------------------------------------
    def _current_hosts(self) -> List[str]:
        ents = self.coord.get_prefix(self.node_prefix)
        hosts = []
        for v, _k in ents:
            hosts.append(v.decode() if isinstance(v, bytes) else str(v))
        return sorted(set(hosts))

    def _match(self, host_list: Optional[List[str]] = None) -> bool:
        """Is the current membership launchable?  (reference :397)"""
        self.hosts = (sorted(set(host_list)) if host_list is not None
                      else self._current_hosts())
        n = len(self.hosts)
        if self.elastic_level == ElasticLevel.FAULT_TOLERANCE:
            return n == self.np
        # ELASTIC: exact size, or [min, max) after the settle window
        if n == self.np:
            self._elastic_startup_time = None
            return True
        if n == self.max_np:
            self._elastic_startup_time = None
            return True
        if self.min_np <= n < self.max_np:
            if self._elastic_startup_time is None:
                self._elastic_startup_time = time.monotonic()
            if time.monotonic() - self._elastic_startup_time \
                    <= self.elastic_timeout:
                return False          # wait for stragglers
            return True
        self._elastic_startup_time = None
        return False

    # -- rank regeneration ------------------------------------------------
    def _regen_ranks(self) -> List[str]:
        """New rank-ordered host list for the CURRENT membership, moving
        as few surviving ranks as possible (reference scale-in sort :490,
        scale-out append :469, fault-tolerance swap :443)."""
        prev = list(self.trainer_hosts)
        cur = set(self.hosts)
        n = len(self.hosts)

        # survivors keep their old rank when it is still in range
        slots: List[Optional[str]] = [None] * n
        homeless = []
        for h in sorted(cur):
            old = prev.index(h) if h in prev else None
            if old is not None and old < n and slots[old] is None:
                slots[old] = h
            else:
                homeless.append(h)
        for i in range(n):
            if slots[i] is None:
                slots[i] = homeless.pop(0)
        assert not homeless
        return slots

    def sync(self) -> Optional[Dict[str, str]]:
        """Adopt the current membership: compute the new rank table,
        publish it, and return this host's launch env (reference
        _update_hosts :537).  Returns None — BEFORE publishing anything —
        when this host fell out of the membership (lease lapse during
        churn): the caller must hold; the heartbeat loop re-registers as
        soon as a slot is free."""
        if not self.hosts:
            self._match()
        new_order = self._regen_ranks()
        if self.curr_host not in new_order:
            self.hosts = []
            self.need_sync = True
            return None
        scale = len(new_order) - len(self.trainer_hosts) \
            if self.trainer_hosts else 0
        self.trainer_hosts = new_order
        self.np = len(new_order)
        self.need_sync = False
        self.coord.put(self.endpoints_path, ",".join(new_order))
        rank = new_order.index(self.curr_host)
        env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(self.np),
            "PADDLE_TRAINERS": ",".join(
                h.split(":")[0] for h in new_order),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(new_order),
            "PADDLE_CURRENT_ENDPOINT": self.curr_host,
        }
        self._last_scale = scale
        return env

    # -- lifecycle --------------------------------------------------------
    def wait(self, poll: float = 0.1, timeout: Optional[float] = None):
        """Block until the membership is launchable (reference :554)."""
        t0 = time.monotonic()
        while not self.stopped:
            if self._match():
                return True
            if timeout is not None and time.monotonic() - t0 > timeout:
                return False
            time.sleep(poll)
        return False

    def run(self, launcher: LauncherInterface):
        self.launcher = launcher
        launcher.launch()

    def watch(self, poll: float = 0.05) -> str:
        """Poll workers + membership until something decides the round
        (reference :577)."""
        while not self.stopped:
            if self.need_sync:
                if self._completed():
                    # a peer finished the job while membership churned:
                    # never relaunch a completed job
                    self.exit(completed=False)
                    return ElasticStatus.COMPLETED
                # membership changed under us: relaunch with new ranks
                if not self._match():
                    # not launchable (node lost below min): hold
                    return ElasticStatus.HOLD
                return ElasticStatus.RESTART
            rc = self.launcher.watch()
            if rc is not None:
                if rc == 0:
                    self.exit(completed=True)
                    return ElasticStatus.COMPLETED
                if rc == ELASTIC_EXIT_CODE:
                    return ElasticStatus.RESTART
                # reference manager.py:577 — at FAULT_TOLERANCE/ELASTIC
                # level ANY worker fault relaunches the round (recovery
                # comes from checkpoints), bounded by the fault budget
                self.fault_count += 1
                if self.fault_count <= self.max_faults:
                    return ElasticStatus.RESTART
                return ElasticStatus.ERROR
            time.sleep(poll)
        return ElasticStatus.EXIT

    def _completed(self) -> bool:
        v, _ = self.coord.get(self.prefix + "/completed")
        return v is not None and v in (b"1", "1")

    def exit(self, completed: bool = False):
        if completed:
            self.coord.put(self.prefix + "/completed", "1")
        self.stopped = True
        self._hb_stop.set()
        self._hb_thread.join(timeout=2)
        try:
            self.coord.cancel_watch(self._watch_id)
        except Exception:
            pass
        try:
            self._lease.revoke()
        except Exception:
            pass
        self.coord.delete(self.node_prefix + self.curr_host)


class FileCoordinator:
    """Cross-process coordinator over a shared directory (the etcd duck
    for single-host / shared-filesystem pods — reference deployments
    point ElasticManager at etcd; this needs nothing but a path).

    Keys are files holding {"v", "ttl", "ts"}; a leased key is alive
    while its RECORD timestamp (written by the owner, not filesystem
    mtime — NFS servers stamp their own clock) is fresher than its ttl;
    heartbeat refresh rewrites the record.  Watches poll and diff the
    directory by key VALUE, so heartbeats do not fire membership events
    (etcd keepalives emit no watch events either).  Readers never delete
    stale entries (no cross-process TOCTOU); they just treat them as
    absent — only the explicit ``sweep()`` garbage-collects.

    Caveat: liveness compares the writer's wall clock against the
    reader's; keep node clocks NTP-synced within a fraction of the ttl
    (etcd has the same requirement for its own lease clocks).
    """

    _TMP_PREFIX = ".tmp-"

    def __init__(self, root: str, poll_interval: float = 0.05):
        self._root = root
        os.makedirs(root, exist_ok=True)
        self._poll = poll_interval
        self._watches: Dict[int, Tuple[str, Callable]] = {}
        self._next_watch = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tmp_seq = itertools.count()

    # -- paths ------------------------------------------------------------
    def _path(self, key: str) -> str:
        fname = quote(key, safe="")
        if fname.startswith(self._TMP_PREFIX):
            raise ValueError(f"key {key!r} collides with the temp-file "
                             "namespace")
        return os.path.join(self._root, fname)

    def _key(self, fname: str) -> str:
        return unquote(fname)

    def _is_tmp(self, fname: str) -> bool:
        return fname.startswith(self._TMP_PREFIX)

    # -- kv ---------------------------------------------------------------
    def _write(self, key: str, rec: dict):
        # per-writer unique temp name in a reserved namespace, atomic
        # publish via rename (concurrent puts of one key serialize on
        # os.replace; last writer wins, never a torn record)
        tmp = os.path.join(
            self._root,
            f"{self._TMP_PREFIX}{os.getpid()}-{next(self._tmp_seq)}")
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self._path(key))

    def put(self, key: str, value, lease: Optional["_FileLease"] = None):
        value = value if isinstance(value, bytes) else str(value).encode()
        rec = {"v": value.decode("latin1"),
               "ttl": lease.ttl if lease is not None else None,
               "ts": time.time()}
        self._write(key, rec)
        if lease is not None:
            lease.key = key
            lease._coord = self
            lease._rec = rec

    def _load(self, path: str):
        """(record, alive) — never mutates the store."""
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None, False
        if rec.get("ttl") is not None and                 time.time() - rec.get("ts", 0) > rec["ttl"]:
            return rec, False
        return rec, True

    def get(self, key: str):
        rec, alive = self._load(self._path(key))
        return (rec["v"].encode("latin1") if alive else None), key

    def get_prefix(self, prefix: str):
        out = []
        for fname in sorted(os.listdir(self._root)):
            if self._is_tmp(fname):
                continue
            key = self._key(fname)
            if key.startswith(prefix):
                rec, alive = self._load(os.path.join(self._root, fname))
                if alive:
                    out.append((rec["v"].encode("latin1"), key))
        return out

    def delete(self, key: str):
        try:
            os.unlink(self._path(key))
            return True
        except OSError:
            return False

    # -- leases ------------------------------------------------------------
    def lease(self, ttl: float) -> "_FileLease":
        return _FileLease(self, ttl)

    def sweep(self):
        """Garbage-collect expired leased entries.  Guard against the
        owner refreshing concurrently: re-read after the stale verdict
        and only unlink if STILL stale."""
        for fname in list(os.listdir(self._root)):
            if self._is_tmp(fname):
                continue
            path = os.path.join(self._root, fname)
            rec, alive = self._load(path)
            if rec is None or alive or rec.get("ttl") is None:
                continue
            rec2, alive2 = self._load(path)
            if rec2 is not None and not alive2                     and rec2.get("ts") == rec.get("ts"):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    # -- watches -----------------------------------------------------------
    def _snapshot(self):
        """fname -> (value, alive): VALUE-based so lease refreshes (ts
        rewrites) do not register as membership events."""
        snap = {}
        for fname in os.listdir(self._root):
            if self._is_tmp(fname):
                continue
            rec, alive = self._load(os.path.join(self._root, fname))
            if rec is not None:
                snap[fname] = (rec.get("v"), alive)
        return snap

    def _watch_loop(self):
        prev = self._snapshot()
        while not self._stop.wait(self._poll):
            cur = self._snapshot()
            changed = [f for f in set(prev) | set(cur)
                       if prev.get(f) != cur.get(f)]
            prev = cur
            if not changed:
                continue
            with self._lock:
                watches = list(self._watches.values())
            for fname in changed:
                key = self._key(fname)
                for pfx, cb in watches:
                    if key.startswith(pfx):
                        try:
                            cb(key)
                        except Exception:
                            pass

    def add_watch_prefix_callback(self, prefix: str, callback) -> int:
        with self._lock:
            self._next_watch += 1
            self._watches[self._next_watch] = (prefix, callback)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._watch_loop, daemon=True)
                self._thread.start()
            return self._next_watch

    def cancel_watch(self, watch_id: int):
        with self._lock:
            self._watches.pop(watch_id, None)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class _FileLease:
    def __init__(self, coord: FileCoordinator, ttl: float):
        self._coord = coord
        self.ttl = float(ttl)
        self.key = None
        self.revoked = False
        self._rec = None

    def refresh(self):
        if self.revoked:
            raise RuntimeError("lease revoked")
        if self.key is not None and self._rec is not None:
            # rewrite the record with a fresh owner timestamp (content
            # "v" unchanged, so value-based watches stay quiet)
            rec = dict(self._rec)
            rec["ts"] = time.time()
            self._coord._write(self.key, rec)
            self._rec = rec

    def revoke(self):
        self.revoked = True
        if self.key is not None:
            self._coord.delete(self.key)

"""The port's elastic manager (``paddle_tpu_torch.distributed.fleet.elastic``)
against every case of ``tests/test_elastic.py``, the JAX package's spec
(reference: unittests/test_fleet_elastic_manager.py, against a live
in-memory coordinator with real lease and watch semantics), plus the two
packages' managers in one ``FileCoordinator`` directory agreeing on the
ranks, and ``_parse_np`` equal to the JAX package's.  The timings are
the spec's (leases of 0.4 s, heartbeats every 0.1 s)."""
import time

import pytest

from paddle_tpu_torch.distributed.fleet.elastic import (
    ELASTIC_EXIT_CODE, ElasticLevel, ElasticManager, ElasticStatus,
    InMemoryCoordinator, LauncherInterface)


def mk(coord, host, np="2", level=ElasticLevel.FAULT_TOLERANCE, **kw):
    kw.setdefault("lease_ttl", 0.4)
    kw.setdefault("heartbeat_interval", 0.1)
    return ElasticManager(coord, job_id="job0", np=np, curr_host=host,
                          elastic_level=level, **kw)


class FakeLauncher(LauncherInterface):
    def __init__(self):
        self.rc = None
        self.launched = 0
        self.stopped = 0

    def launch(self):
        self.launched += 1

    def watch(self):
        return self.rc

    def stop(self):
        self.stopped += 1


class TestMembership:
    def test_register_and_match_fault_tolerance(self):
        coord = InMemoryCoordinator()
        m1 = mk(coord, "h1:6170")
        assert not m1._match()          # only 1 of np=2
        m2 = mk(coord, "h2:6170")
        assert m1._match()
        assert m1.hosts == ["h1:6170", "h2:6170"]
        m1.exit(); m2.exit()

    def test_lease_expiry_removes_node(self):
        coord = InMemoryCoordinator()
        m1 = mk(coord, "h1:6170")
        m2 = mk(coord, "h2:6170")
        assert m1._match()
        # kill h2's heartbeat; its lease must lapse and membership shrink
        m2._hb_stop.set()
        m2._hb_thread.join()
        time.sleep(0.6)
        coord.sweep()
        assert not m1._match()
        assert m1.hosts == ["h1:6170"]
        m1.exit(); m2.exit()

    def test_heartbeat_keeps_lease_alive(self):
        coord = InMemoryCoordinator()
        m1 = mk(coord, "h1:6170", np="1")
        time.sleep(1.0)   # several ttl periods
        coord.sweep()
        assert m1._match()
        m1.exit()

    def test_watch_flags_membership_change(self):
        coord = InMemoryCoordinator()
        m1 = mk(coord, "h1:6170")
        m1.need_sync = False
        mk(coord, "h2:6170")
        assert m1.need_sync            # watch callback fired on join


class TestElasticWindow:
    def test_window_waits_then_accepts(self):
        coord = InMemoryCoordinator()
        m1 = mk(coord, "h1:6170", np="2:4",
                level=ElasticLevel.ELASTIC, elastic_timeout=0.3)
        m2 = mk(coord, "h2:6170", np="2:4",
                level=ElasticLevel.ELASTIC, elastic_timeout=0.3)
        m3 = mk(coord, "h3:6170", np="2:4",
                level=ElasticLevel.ELASTIC, elastic_timeout=0.3)
        # 3 in [2,4): inside the settle window -> not yet
        assert not m1._match()
        time.sleep(0.35)
        assert m1._match()             # window elapsed -> accept 3
        m1.exit(); m2.exit(); m3.exit()

    def test_max_np_launches_immediately(self):
        coord = InMemoryCoordinator()
        ms = [mk(coord, f"h{i}:6170", np="2:4",
                 level=ElasticLevel.ELASTIC, elastic_timeout=30)
              for i in range(4)]
        assert ms[0]._match()          # at max_np: no wait
        for m in ms:
            m.exit()

    def test_below_min_never_matches(self):
        coord = InMemoryCoordinator()
        m1 = mk(coord, "h1:6170", np="2:4",
                level=ElasticLevel.ELASTIC, elastic_timeout=0.05)
        time.sleep(0.1)
        assert not m1._match()
        m1.exit()


class TestRankRegeneration:
    def test_initial_ranks_sorted(self):
        coord = InMemoryCoordinator()
        m1 = mk(coord, "h1:6170")
        m2 = mk(coord, "h2:6170")
        assert m1.wait(timeout=2)
        env = m1.sync()
        assert env["PADDLE_TRAINER_ID"] == "0"
        assert env["PADDLE_TRAINERS_NUM"] == "2"
        env2 = m2.sync()
        assert env2["PADDLE_TRAINER_ID"] == "1"
        m1.exit(); m2.exit()

    def test_scale_in_preserves_surviving_ranks(self):
        """Reference contract (manager.py:490): when h0 (rank 0) leaves,
        h1/h2 KEEP ranks 1/2 and the unseated host fills rank 0."""
        coord = InMemoryCoordinator()
        m = mk(coord, "h1:6170", np="3:4", level=ElasticLevel.ELASTIC,
               elastic_timeout=0.05)
        m.hosts = ["h0:6170", "h1:6170", "h2:6170", "h3:6170"]
        m.trainer_hosts = []
        m.sync()
        assert m.trainer_hosts == [
            "h0:6170", "h1:6170", "h2:6170", "h3:6170"]
        # h0 drops out
        m.hosts = ["h1:6170", "h2:6170", "h3:6170"]
        env = m.sync()
        # h1 keeps rank 1, h2 keeps rank 2, h3 (old rank 3, out of range)
        # moves into the vacated rank 0
        assert m.trainer_hosts == ["h3:6170", "h1:6170", "h2:6170"]
        assert env["PADDLE_TRAINER_ID"] == "1"

    def test_scale_out_appends_new_hosts(self):
        coord = InMemoryCoordinator()
        m = mk(coord, "h1:6170", np="2:4", level=ElasticLevel.ELASTIC,
               elastic_timeout=0.05)
        m.hosts = ["h1:6170", "h2:6170"]
        m.trainer_hosts = []
        m.sync()
        assert m.trainer_hosts == ["h1:6170", "h2:6170"]
        m.hosts = ["h1:6170", "h2:6170", "h9:6170"]
        m.sync()
        # old ranks unchanged; the joiner takes the new rank
        assert m.trainer_hosts == ["h1:6170", "h2:6170", "h9:6170"]
        assert m.np == 3

    def test_endpoints_published(self):
        coord = InMemoryCoordinator()
        m1 = mk(coord, "h1:6170")
        m2 = mk(coord, "h2:6170")
        m1.wait(timeout=2)
        m1.sync()
        v, _ = coord.get(m1.endpoints_path)
        assert v == b"h1:6170,h2:6170"
        m1.exit(); m2.exit()


class TestWatchLoop:
    def test_completed(self):
        coord = InMemoryCoordinator()
        m = mk(coord, "h1:6170", np="1")
        m.wait(timeout=2)
        m.sync()
        launcher = FakeLauncher()
        m.run(launcher)
        launcher.rc = 0
        assert m.watch() == ElasticStatus.COMPLETED
        assert m._completed()

    def test_error(self):
        # a worker fault relaunches (reference manager.py:577
        # FAULT_TOLERANCE) until the fault budget runs out, then errors
        coord = InMemoryCoordinator()
        m = mk(coord, "h1:6170", np="1")
        m.max_faults = 2
        m.wait(timeout=2); m.sync()
        launcher = FakeLauncher()
        m.run(launcher)
        launcher.rc = 1
        assert m.watch() == ElasticStatus.RESTART
        assert m.watch() == ElasticStatus.RESTART
        assert m.watch() == ElasticStatus.ERROR
        m.exit()

    def test_elastic_exit_code_restarts(self):
        coord = InMemoryCoordinator()
        m = mk(coord, "h1:6170", np="1")
        m.wait(timeout=2); m.sync()
        launcher = FakeLauncher()
        m.run(launcher)
        launcher.rc = ELASTIC_EXIT_CODE
        assert m.watch() == ElasticStatus.RESTART
        m.exit()

    def test_member_join_triggers_restart(self):
        coord = InMemoryCoordinator()
        m = mk(coord, "h1:6170", np="1:2", level=ElasticLevel.ELASTIC,
               elastic_timeout=0.01)
        m.wait(timeout=2); m.sync()
        launcher = FakeLauncher()
        m.run(launcher)
        m2 = mk(coord, "h2:6170", np="1:2", level=ElasticLevel.ELASTIC)
        time.sleep(0.05)
        assert m.watch() == ElasticStatus.RESTART
        env = m.sync()
        assert env["PADDLE_TRAINERS_NUM"] == "2"
        m.exit(); m2.exit()


class TestRoundNotices:
    """Which membership notices restart a running round: a late one of the
    entries the round adopted does not; a leave and rejoin on the same
    endpoint, or a lapsed and renewed lease, does (as in the JAX
    package); a peer's completion waits for this node's workers."""

    def _round(self, coord):
        m, m2 = mk(coord, "h1:6170"), mk(coord, "h2:6170")
        assert m.wait(timeout=2)
        m.sync()
        launcher = FakeLauncher()
        m.run(launcher)
        return m, m2, launcher

    def test_late_notice_of_the_adopted_membership_does_not_restart(self):
        coord = InMemoryCoordinator()
        m, m2, launcher = self._round(coord)
        m.need_sync = True           # the watch reports the join late
        launcher.rc = 0
        assert m.watch() == ElasticStatus.COMPLETED
        m2.exit()

    @pytest.mark.parametrize("how", ["rejoin", "lease_renewed"])
    def test_same_endpoint_coming_back_restarts(self, how):
        coord = InMemoryCoordinator()
        m, m2, launcher = self._round(coord)
        if how == "rejoin":
            m2.exit()
            m2 = mk(coord, "h2:6170")
        else:
            m2._lease.revoke()       # the heartbeat re-registers the node
            deadline = time.monotonic() + 2
            while "h2:6170" not in m._current_hosts():
                assert time.monotonic() < deadline
                time.sleep(0.02)
        assert m._current_hosts() == ["h1:6170", "h2:6170"]
        assert m.need_sync
        launcher.rc = 0              # the notice decides before the workers
        assert m.watch() == ElasticStatus.RESTART
        m.exit(); m2.exit()

    @pytest.mark.parametrize("rc, status", [(0, ElasticStatus.COMPLETED),
                                            (1, ElasticStatus.ERROR)])
    def test_peer_completion_waits_for_own_workers(self, rc, status):
        import threading

        coord = InMemoryCoordinator()
        m, m2, launcher = self._round(coord)
        m2.exit(completed=True)      # the peer finished and left
        assert m.need_sync and m._completed()
        threading.Timer(0.15, setattr, (launcher, "rc", rc)).start()
        t0 = time.monotonic()
        assert m.watch() == status
        assert time.monotonic() - t0 >= 0.15 and launcher.stopped == 0


class TestNpParse:
    def test_forms(self):
        from paddle_tpu_torch.distributed.fleet.elastic.manager import _parse_np

        assert _parse_np(4) == (4, 4)
        assert _parse_np("4") == (4, 4)
        assert _parse_np("2:8") == (2, 8)
        with pytest.raises(ValueError):
            _parse_np("8:2")
        with pytest.raises(ValueError):
            _parse_np("0")


class TestFileCoordinator:
    """Cross-process coordinator over a shared directory: the same
    ElasticManager code that takes etcd in pods runs single-host with
    nothing but a path."""

    def test_managers_in_separate_processes(self, tmp_path):
        import os
        import subprocess
        import sys
        import textwrap

        root = str(tmp_path / "coord")
        child_src = textwrap.dedent(f"""
            import time
            from paddle_tpu_torch.distributed.fleet.elastic import (
                ElasticManager, FileCoordinator)

            c = FileCoordinator({root!r}, poll_interval=0.05)
            m = ElasticManager(c, "job", np="2", curr_host="hB:6170",
                               lease_ttl=2.0, heartbeat_interval=0.2)
            deadline = time.time() + 10
            while time.time() < deadline and not m._match():
                time.sleep(0.05)
            env = m.sync()
            print("CHILD_RANK", env["PADDLE_TRAINER_ID"], flush=True)
            time.sleep(1.0)
            m.exit()
        """)
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        child = subprocess.Popen([sys.executable, "-c", child_src],
                                 env=env, stdout=subprocess.PIPE, text=True)
        try:
            from paddle_tpu_torch.distributed.fleet.elastic import (
                ElasticManager, FileCoordinator)

            c = FileCoordinator(root, poll_interval=0.05)
            m = ElasticManager(c, "job", np="2", curr_host="hA:6170",
                               lease_ttl=2.0, heartbeat_interval=0.2)
            assert m.wait(timeout=10)
            env_a = m.sync()
            assert env_a["PADDLE_TRAINER_ID"] == "0"     # hA sorts first
            assert env_a["PADDLE_TRAINERS_NUM"] == "2"
            out, _ = child.communicate(timeout=20)
            assert "CHILD_RANK 1" in out
            m.exit()
            c.close()
        finally:
            if child.poll() is None:
                child.kill()

    def test_lease_expiry_across_restart(self, tmp_path):
        import time

        from paddle_tpu_torch.distributed.fleet.elastic import (
            ElasticManager, FileCoordinator)

        root = str(tmp_path / "coord2")
        c = FileCoordinator(root, poll_interval=0.05)
        m1 = ElasticManager(c, "job", np="1:2", curr_host="h1:1",
                            lease_ttl=0.4, heartbeat_interval=0.1,
                            elastic_timeout=0.05)
        m2 = ElasticManager(c, "job", np="1:2", curr_host="h2:1",
                            lease_ttl=0.4, heartbeat_interval=0.1,
                            elastic_timeout=0.05)
        assert m1.wait(timeout=5)
        # kill m2's heartbeat: its file lease must go stale and drop out
        m2._hb_stop.set()
        m2._hb_thread.join()
        time.sleep(0.8)
        c.sweep()
        assert m1._current_hosts() == ["h1:1"]
        m1.exit(); m2.exit(); c.close()

    def test_heartbeats_do_not_fire_membership_events(self, tmp_path):
        """code-review r4: lease refreshes must not look like membership
        churn, or a stable cluster restarts itself every heartbeat."""
        import time

        from paddle_tpu_torch.distributed.fleet.elastic import (
            ElasticManager, FileCoordinator)

        root = str(tmp_path / "coord3")
        c = FileCoordinator(root, poll_interval=0.03)
        m = ElasticManager(c, "job", np="1", curr_host="h1:1",
                           lease_ttl=0.3, heartbeat_interval=0.05)
        assert m.wait(timeout=5)
        m.sync()
        m.need_sync = False
        time.sleep(0.5)          # ~10 heartbeats, several watch polls
        assert not m.need_sync
        m.exit(); c.close()


class TestAcrossPackages:
    def test_parse_np_matches_jax(self):
        from paddle_tpu.distributed.fleet.elastic.manager import (
            _parse_np as jax_parse)
        from paddle_tpu_torch.distributed.fleet.elastic.manager import (
            _parse_np)

        for spec in (1, 4, "4", "2:8", "1:1"):
            assert _parse_np(spec) == jax_parse(spec)
        for bad in ("8:2", "0", 0):
            with pytest.raises(ValueError):
                _parse_np(bad)
            with pytest.raises(ValueError):
                jax_parse(bad)

    def test_one_directory_two_packages(self, tmp_path):
        """A JAX manager and a port manager under one FileCoordinator
        directory see one membership and regenerate the same ranks."""
        from paddle_tpu.distributed.fleet.elastic import (
            ElasticManager as JaxManager, FileCoordinator as JaxCoordinator)
        from paddle_tpu_torch.distributed.fleet.elastic import (
            ElasticManager, FileCoordinator)

        root = str(tmp_path / "coord")
        jc, pc = JaxCoordinator(root), FileCoordinator(root)
        jm = JaxManager(jc, "job", np="2", curr_host="hA:1", lease_ttl=2.0,
                        heartbeat_interval=0.2)
        pm = ElasticManager(pc, "job", np="2", curr_host="hB:1",
                            lease_ttl=2.0, heartbeat_interval=0.2)
        try:
            assert pm.wait(timeout=5) and jm.wait(timeout=5)
            assert pm.hosts == jm.hosts == ["hA:1", "hB:1"]
            assert jm.sync()["PADDLE_TRAINER_ID"] == "0"
            assert pm.sync()["PADDLE_TRAINER_ID"] == "1"
            assert pm.trainer_hosts == jm.trainer_hosts
        finally:
            jm.exit()
            pm.exit()
            jc.close()
            pc.close()

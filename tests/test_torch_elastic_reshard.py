"""Elastic reconfiguration in the port: digests, the exactly-once data
schedule, the mesh watchdog, a resume on another world, and the SIGKILL
drill.

Spec: ``tests/test_elastic_reshard.py``.

- ``tensor_digest`` / ``state_digests`` of the port equal the JAX
  package's for the same arrays (f32, f16, int, bool, bf16 as its uint16
  bits, literals, nested states), bitwise; a ``DTensor`` sharded over a
  gloo world of 2 digests as its whole tensor.
- ``ElasticDataSchedule``'s index sets and ``lost_samples`` equal the JAX
  package's at every world size tried; nothing is lost or repeated.
- Every ``TestMeshWatchdog`` case of the spec, on the port's
  ``MeshWatchdog`` and ``FaultPlan``.
- A data-parallel ``ResilientLoop`` run in a gloo world of 2 is killed
  after step 5 (cadence saves, no final commit) and resumed in one
  process: one reconfiguration, the restored state bitwise the saved
  generation, and the losses of steps 4..7 within ``rtol=1e-4,
  atol=1e-6`` of the uninterrupted world-2 run (the spec's tolerance;
  the sums run in another order on one rank).
- The drill: two launchers at ``--np 1:2`` under one FileCoordinator,
  one SIGKILLed mid-run; the survivor relaunches at world 1 and finishes
  with no sample lost and the losses of a solo run within ``rtol=2e-4,
  atol=1e-6`` (the spec's).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
from torch_world import get, run_world, scenario  # noqa: E402

from paddle_tpu_torch.distributed import checkpoint as ckpt  # noqa: E402
from paddle_tpu_torch.distributed.fault_tolerance import (  # noqa: E402
    FaultPlan, MeshWatchdog, ResilientLoop,
)
from paddle_tpu_torch.distributed.fleet.elastic import (  # noqa: E402
    FileCoordinator, InMemoryCoordinator,
)
from paddle_tpu_torch.distributed.reshard import (  # noqa: E402
    ElasticDataSchedule, diff_digests, state_digests, tensor_digest,
    verify_resharded,
)
from paddle_tpu_torch.obs.train import StepTimeline  # noqa: E402

DRILL = os.path.join(REPO, "tests", "assets", "torch_elastic_world_train.py")
LAUNCH = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
STEPS = 8


# -- digests ----------------------------------------------------------------

def _arrays():
    rs = np.random.RandomState(0)
    return {"f32": rs.randn(8, 16).astype(np.float32),
            "f16": rs.randn(3, 5).astype(np.float16),
            "i64": rs.randint(-9, 9, (4, 4)).astype(np.int64),
            "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "bool": rs.rand(7) > 0.5,
            "scalar": np.array(1.5, dtype=np.float32),
            "bf": np.linspace(-2, 2, 32).astype(np.float32)}


class TestReshardDigests:
    def test_digests_equal_the_jax_packages(self):
        import paddle_tpu as paddle
        from paddle_tpu.distributed import reshard as jre

        arrs = _arrays()
        for name, a in arrs.items():
            if name == "bf":
                continue
            assert tensor_digest(torch.from_numpy(a)) == \
                jre.tensor_digest(a), name
        # bf16: both round the same f32 values to nearest even
        jbf = paddle.to_tensor(arrs["bf"]).astype("bfloat16")
        pbf = torch.from_numpy(arrs["bf"]).to(torch.bfloat16)
        assert tensor_digest(pbf) == jre.tensor_digest(jbf)
        # literals and a nested state, path for path
        state = {"user": {"w": torch.from_numpy(arrs["f32"]),
                          "m": [torch.from_numpy(arrs["i64"]),
                                (torch.from_numpy(arrs["f16"]), 3)]},
                 "@step": 7, "@tag": "run0", "bf": pbf}
        jstate = {"user": {"w": arrs["f32"],
                           "m": [arrs["i64"], (arrs["f16"], 3)]},
                  "@step": 7, "@tag": "run0", "bf": jbf}
        assert state_digests(state) == jre.state_digests(jstate)

    def test_bf16_digest_is_bitwise_not_lossy(self):
        x = np.linspace(-1, 1, 16).astype(np.float32)
        a = torch.from_numpy(x).to(torch.bfloat16)
        b = torch.from_numpy(x * (1 + 1e-2)).to(torch.bfloat16)
        assert tensor_digest(a) == tensor_digest(a.clone())
        assert tensor_digest(a) != tensor_digest(b)

    def test_verify_resharded_catches_one_element(self):
        w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        want = verify_resharded({"w": w, "@wall": 1.0},
                                {"w": w.clone(), "@wall": 2.0},
                                ignore=("@wall",))
        assert set(want) == {"w"}
        bad = w.clone()
        bad[1, 2] += 1e-6
        assert diff_digests(state_digests({"w": bad}),
                            state_digests({"w": w}))
        with pytest.raises(ValueError, match="NOT bitwise identical"):
            verify_resharded({"w": bad}, {"w": w})


# -- the elastic data schedule ------------------------------------------------

class TestElasticDataSchedule:
    def test_exactly_once_at_every_world_size(self):
        sched = ElasticDataSchedule(12)
        for world in range(1, 7):
            for step in (0, 1, 5):
                sched.assert_coverage(step, world)
                ids = np.concatenate([
                    sched.local_indices(step, r, world)
                    for r in range(world)])
                lo, hi = sched.step_window(step)
                np.testing.assert_array_equal(
                    ids, np.arange(lo, hi, dtype=np.int64))

    def test_world_change_loses_and_duplicates_nothing(self):
        sched = ElasticDataSchedule(8, dataset_size=32)
        assert sched.lost_samples([(0, 3, 4), (3, 6, 3)]) == 0
        assert sched.lost_samples([(0, 4, 4), (3, 6, 3)]) > 0
        assert sched.lost_samples([(0, 2, 4), (3, 6, 3)]) > 0

    def test_local_batch_gathers_this_ranks_slice(self):
        data = np.arange(10, dtype=np.float32)
        sched = ElasticDataSchedule(4, dataset_size=10)
        got = sched.local_batch(3, rank=1, world=2, data=data)
        np.testing.assert_array_equal(got, np.array([4.0, 5.0]))

    def test_index_sets_equal_the_jax_packages(self):
        from paddle_tpu.distributed.reshard import (
            ElasticDataSchedule as JaxSchedule)

        for g, size in ((12, None), (8, 32), (7, 10), (16, 16)):
            ours, theirs = ElasticDataSchedule(g, size), JaxSchedule(g, size)
            for world in range(1, 6):
                for step in (0, 1, 3, 9):
                    for r in range(world):
                        np.testing.assert_array_equal(
                            ours.local_indices(step, r, world),
                            theirs.local_indices(step, r, world))
            for segs in ([(0, 3, 4), (3, 6, 3)], [(0, 4, 4), (3, 6, 3)],
                         [(0, 2, 2), (3, 5, 1)]):
                assert ours.lost_samples(segs) == theirs.lost_samples(segs)


# -- the mesh health watchdog -------------------------------------------------

class TestMeshWatchdog:
    def _wd(self, coord, host, **kw):
        kw.setdefault("heartbeat_interval", 30.0)   # beats driven by hand
        kw.setdefault("hard_exit", False)
        return MeshWatchdog(coord, "job0", host, **kw)

    def test_heartbeat_publishes_health_records(self):
        coord = InMemoryCoordinator()
        a = self._wd(coord, "hostA").start()
        b = self._wd(coord, "hostB").start()
        try:
            assert set(a.peers()) == {"hostA", "hostB"}
            assert a.stats()["membership"] == 2
            assert a.stats()["heartbeats"] >= 1
        finally:
            a.stop()
            b.stop()
        assert a.peers() == {}

    def test_heartbeat_fault_point_drops_beats(self):
        plan = FaultPlan().add_train_fault("elastic.heartbeat",
                                           at_step=2, times=2)
        coord = InMemoryCoordinator()
        wd = self._wd(coord, "hostA", fault_plan=plan).start()
        try:
            wd._publish()                # beat 2: dropped
            wd._publish()                # beat 3: dropped
            wd._publish()                # beat 4: delivered
        finally:
            wd.stop()
        assert wd.heartbeats == 2
        assert wd.dropped_heartbeats == 2

    def test_fault_points_parse_from_env(self):
        plan = FaultPlan.from_env(env={
            "PADDLE_TPU_FT_TRAIN_FAULTS":
                "elastic.heartbeat@1x2,train.straggler@3:stall=0.01"})
        assert sorted(r["kind"] for r in plan.train_faults) == \
            ["heartbeat", "straggler"]
        assert plan.train_faults[1]["stall"] == 0.01
        assert plan.should_drop_heartbeat() is True
        assert plan.should_drop_heartbeat() is True
        assert plan.should_drop_heartbeat() is False

    def test_straggler_fault_stalls_the_step(self):
        plan = FaultPlan().add_train_fault("train.straggler", at_step=2,
                                           times=1, stall=0.05)
        t0 = time.monotonic()
        plan.fire(1)
        assert time.monotonic() - t0 < 0.04
        t0 = time.monotonic()
        plan.fire(2)
        assert time.monotonic() - t0 >= 0.05
        t0 = time.monotonic()
        plan.fire(2)
        assert time.monotonic() - t0 < 0.04

    def test_straggler_ema_flags_and_escalates(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path / "crash"))
        coord = InMemoryCoordinator()
        seen = []
        fast = self._wd(coord, "fast", straggler_factor=3.0,
                        straggler_patience=2)
        fast2 = self._wd(coord, "fast2", straggler_factor=3.0,
                         straggler_patience=2)
        slow = self._wd(coord, "slow", straggler_factor=3.0,
                        straggler_patience=2, on_escalate=seen.append)
        for wd in (fast, fast2, slow):
            wd._lease = coord.lease(wd.lease_ttl)
        fast.ema_ms, fast2.ema_ms, slow.ema_ms = 5.0, 6.0, 50.0
        for wd in (fast, fast2, slow):
            wd._publish()
        fast._check_straggler()
        assert fast.stragglers_flagged == 0
        slow._check_straggler()
        assert slow.stragglers_flagged == 1 and not slow.escalated
        slow._check_straggler()
        assert slow.escalated and "straggler" in slow.escalation_reason
        assert seen and "straggler" in seen[0]
        assert slow.stats()["stragglers_flagged"] == 2
        crash = str(tmp_path / "crash")
        assert os.path.isdir(crash) and os.listdir(crash)

    def test_wedged_collective_deadline_and_pause_discipline(self):
        coord = InMemoryCoordinator()
        wd = self._wd(coord, "hostA", collective_timeout=0.2).start()
        try:
            wd.notify(0)
            wd.notify(1)
            time.sleep(0.9)
            assert wd.step_watchdog.fired
        finally:
            wd.stop()
        wd2 = self._wd(coord, "hostB", collective_timeout=0.2).start()
        try:
            wd2.notify(0)
            wd2.notify(1)
            wd2.pause()
            time.sleep(0.9)
            assert not wd2.step_watchdog.fired
        finally:
            wd2.stop()

    def test_notify_builds_step_time_ema(self):
        coord = InMemoryCoordinator()
        wd = self._wd(coord, "hostA")
        wd.notify(0)
        assert wd.ema_ms is None
        time.sleep(0.02)
        wd.notify(1)
        assert wd.ema_ms is not None and wd.ema_ms >= 10.0

    def test_straggler_stall_escalates_through_the_loop(self, tmp_path,
                                                        monkeypatch):
        """``train.straggler`` armed in the environment stalls one step
        past the deadline of a ``ResilientLoop``'s mesh watchdog: the
        watchdog fires (hard exit off here) and the loop still ends."""
        monkeypatch.setenv("PADDLE_TPU_FT_TRAIN_FAULTS",
                           "train.straggler@3:stall=0.6")
        coord = InMemoryCoordinator()
        wd = self._wd(coord, "hostA", collective_timeout=0.2)
        loop = ResilientLoop(str(tmp_path), state_fn=dict,
                             restore_fn=lambda s: None, save_every=None,
                             verbose=False, mesh_watchdog=wd)
        assert loop.run(lambda i: time.sleep(0.01), 6) == 6
        assert wd.step_watchdog.fired


# -- a resume on another world ------------------------------------------------

def _dp_rig(seed: int = 5):
    """A data-parallel linear model over the world (one process: the
    plain model) on an ElasticDataSchedule; the loss recorded is the
    whole global batch's, computed on the host."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.optimizer import AdamW

    rs = np.random.RandomState(0)
    X = rs.randn(16, 8).astype(np.float32)
    Y = X @ rs.randn(8, 4).astype(np.float32)
    torch.manual_seed(seed)
    lin = torch.nn.Linear(8, 4)
    model = dist.DataParallel(lin)
    opt = AdamW(lin.parameters(), lr=0.05)
    sched = ElasticDataSchedule(16, dataset_size=16)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    losses = []

    def step_fn(step):
        idx = sched.local_indices(step, rank, world)
        x = torch.from_numpy(X[idx] * (1 + 0.1 * step))
        y = torch.from_numpy(Y[idx])
        ((model(x) - y) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
        with torch.no_grad():
            losses.append(float(((lin(torch.from_numpy(X)) -
                                  torch.from_numpy(Y)) ** 2).mean()))

    return {"lin": lin, "opt": opt, "step_fn": step_fn, "losses": losses,
            "state_fn": lambda: {"model": lin.state_dict(),
                                 "opt": opt.state_dict()},
            "restore_fn": lambda s: (lin.load_state_dict(s["model"]),
                                     opt.set_state_dict(s["opt"]))}


def _world_life(rank: int, world: int, workdir: str) -> dict:
    """Rank's part of the world-2 lives: the uninterrupted run and the
    killed one (cadence saves every 2 steps, no final commit)."""
    res = {}

    def oracle():
        rig = _dp_rig()
        ResilientLoop(os.path.join(workdir, "ref"), rig["state_fn"],
                      rig["restore_fn"], save_every=None, verbose=False,
                      save_final=False).run(rig["step_fn"], STEPS)
        return rig["losses"]

    def killed():
        rig = _dp_rig()
        root = os.path.join(workdir, "ck")
        ResilientLoop(root, rig["state_fn"], rig["restore_fn"],
                      save_every=2, save_final=False,
                      verbose=False).run(rig["step_fn"], 5)
        return ckpt.latest_valid(root)[0] if rank == 0 else None

    scenario(res, "oracle", oracle)
    scenario(res, "killed", killed)
    return res


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("elastic_reshard_world"))
    w = run_world("test_torch_elastic_reshard", "_world_worker", workdir, 2)
    return {"results": w.results(), "workdir": workdir}


def _world_worker(rank: int, world: int, workdir: str) -> dict:
    res = _world_life(rank, world, workdir)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor

    def dtensor_digest():
        full = torch.arange(32, dtype=torch.float32).reshape(4, 8)
        mesh = DeviceMesh("cpu", [0, 1])
        d = distribute_tensor(full, mesh, [Shard(1)])
        return {"local": tuple(d.to_local().shape),
                "digest": tensor_digest(d), "want": tensor_digest(full)}

    scenario(res, "dtensor", dtensor_digest)
    return res


class TestReconfiguredResume:
    def test_dtensor_digests_as_its_whole_tensor(self, world2):
        for r in (0, 1):
            got = get(world2["results"], "dtensor", r)
            assert got["local"] == (4, 4)
            assert got["digest"] == got["want"]

    def test_dp_change_resume_parity_digests_and_observability(self,
                                                               world2):
        """Killed at world 2 after step 5 (generation 4 committed),
        resumed here at world 1: one reconfiguration, the restored state
        bitwise the generation, the losses of steps 4..7 at the world-2
        run's within the spec's tolerance, and the reconfiguration in the
        timeline and ``train_stats()``."""
        res, root = world2["results"], os.path.join(world2["workdir"], "ck")
        oracle = get(res, "oracle", 0)
        assert get(res, "oracle", 1) == oracle
        assert get(res, "killed", 0) == 4
        gen4 = ckpt.load_state_dict(ckpt.generation_dir(root, 4),
                                    device="cpu")
        assert dict(gen4["@world"])["processes"] == 2

        rig = _dp_rig()
        probe = ResilientLoop(root, rig["state_fn"], rig["restore_fn"],
                              verbose=False)
        assert probe.resume() == 4
        assert probe.reconfigs == 1 and probe.last_reconfig_s is not None
        verify_resharded({"model": rig["lin"].state_dict(),
                          "opt": rig["opt"].state_dict()}, gen4["user"])

        rig = _dp_rig()
        tl = StepTimeline()
        loop = ResilientLoop(root, rig["state_fn"], rig["restore_fn"],
                             save_every=2, verbose=False, timeline=tl)
        loop.run(rig["step_fn"], STEPS)
        assert loop.reconfigs == 1
        np.testing.assert_allclose(rig["losses"], oracle[4:], rtol=1e-4,
                                   atol=1e-6)
        assert tl.counters()["reconfigured"] == 1
        ela = loop.train_stats()["elastic"]
        assert ela["reconfigs"] == 1 and ela["last_reconfig_ms"] > 0
        assert ela["resharded_tensors"] >= 2


# -- the SIGKILL drill ----------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env(extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "FLAGS_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


class TestElasticSigkillDrill:
    def test_sigkill_host_shrinks_world_and_converges(self, tmp_path):
        """Two launcher process groups under one FileCoordinator at
        ``--np 1:2``; one is SIGKILLed mid-run.  The survivor's worker
        fails its next collective (exit 101), the dead node's lease
        lapses, and the survivor relaunches at world 1 and resumes from
        the shared checkpoint: final world 1, no sample lost or repeated,
        the loss stream at a solo run's."""
        ref_out = str(tmp_path / "ref.json")
        r = subprocess.run([sys.executable, DRILL], env=_clean_env({
            "PADDLE_TEST_CKPT_DIR": str(tmp_path / "ck_ref"),
            "PADDLE_TEST_OUT": ref_out}), capture_output=True, text=True,
            timeout=120)
        assert r.returncode == 0, r.stderr[-2500:]
        ref = json.load(open(ref_out))
        assert ref["segments"] == [[0, STEPS, 1]]

        coord = str(tmp_path / "coord")
        step_dir = str(tmp_path / "steps")
        out = str(tmp_path / "drill.json")
        ports = sorted((_free_port(), _free_port()))
        # both node records first, so neither launcher matches a round of
        # one before its peer has started
        fc = FileCoordinator(coord)
        for p in ports:
            fc.put(f"/paddle_tpu/elastic/drill/nodes/127.0.0.1:{p}",
                   f"127.0.0.1:{p}")
        fc.close()
        env = _clean_env({
            "PADDLE_TEST_CKPT_DIR": str(tmp_path / "ck"),
            "PADDLE_TEST_STEP_DIR": step_dir, "PADDLE_TEST_OUT": out,
            "PADDLE_TEST_HEALTH_DIR": coord,
            "PADDLE_TEST_COLLECTIVE_TIMEOUT": "20",
            "PADDLE_TEST_STEP_SLEEP": "0.35"})
        procs = [subprocess.Popen(
            LAUNCH + ["--nproc_per_node", "1", "--elastic_coordinator",
                      coord, "--np", "1:2", "--job_id", "drill", "--host",
                      "127.0.0.1", "--start_port", str(p),
                      "--elastic_timeout", "2", "--lease_ttl", "2",
                      "--max_restarts", "2", DRILL],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True, cwd=REPO) for p in ports]
        try:
            marker = os.path.join(step_dir, "rank1_step3")
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline and \
                    not os.path.exists(marker):
                for pr in procs:
                    if pr.poll() is not None:
                        o, e = pr.communicate()
                        pytest.fail(f"launcher died early rc="
                                    f"{pr.returncode}\n{e[-2500:]}")
                time.sleep(0.1)
            assert os.path.exists(marker), "the drill never reached step 3"
            doomed = int(open(marker).read())
            assert doomed in [pr.pid for pr in procs]
            os.killpg(doomed, signal.SIGKILL)
            survivor = next(pr for pr in procs if pr.pid != doomed)
            so, se = survivor.communicate(timeout=120)
            assert survivor.returncode == 0, \
                f"survivor rc={survivor.returncode}\n{so[-1200:]}\n" \
                f"{se[-2500:]}"
        finally:
            for pr in procs:
                if pr.poll() is None:
                    try:
                        os.killpg(pr.pid, signal.SIGKILL)
                    except OSError:
                        pass
        res = json.load(open(out))
        worlds = [seg[2] for seg in res["segments"] if seg[1] > seg[0]]
        assert 2 in worlds, res["segments"]
        assert worlds[-1] == 1 and res["final_world"] == 1
        assert res["lost_samples"] == 0
        assert len(res["losses"]) == len(ref["losses"]) == STEPS
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=2e-4,
                                   atol=1e-6)

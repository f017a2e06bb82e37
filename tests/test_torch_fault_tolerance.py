"""The port's fault-tolerant training runtime under chaos, on the CPU.

``tests/test_fault_tolerance.py`` is the spec: each of its classes but
the hapi one has a counterpart here (the JAX ``distributed.launch``
relaunch case is not ported).  A run killed at an arbitrary step resumes
from its last committed generation and ends bitwise equal to an
uninterrupted run (parameters, optimizer state, generator state); a
corrupt or torn generation is never loaded; a stalled step fires the
watchdog; retention keeps exactly K generations.

The workload is this file run as a script (``python
tests/test_torch_fault_tolerance.py``): deterministic tiny training
under ``ResilientLoop`` (a linear layer, AdamW, dropout on the port's
generator, the batch of step N keyed on N alone), configured by
``FT_CKPT_DIR``, ``FT_STEPS``, ``FT_SAVE_EVERY``, ``FT_KEEP_LAST``,
``FT_WATCHDOG`` and ``FT_OUT`` (a JSON of sha256 digests of the final
state), faults by the ``PADDLE_TPU_FT_*`` variables.  It imports the port
and numpy only.
"""
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def main() -> None:
    from paddle_tpu_torch import rng
    from paddle_tpu_torch.distributed.fault_tolerance import ResilientLoop
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    steps = int(os.environ.get("FT_STEPS", "8"))
    wd = os.environ.get("FT_WATCHDOG")
    torch.manual_seed(1234)
    rng.seed(1234)
    net = torch.nn.Linear(8, 8)
    opt = AdamW(net.parameters(), lr=0.05)

    def step_fn(step):
        rs = np.random.RandomState(1000 + step)
        x = torch.from_numpy(rs.randn(4, 8).astype(np.float32))
        y = F.dropout(net(x), p=0.25, training=True)
        loss = (y * y).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()

    loop = ResilientLoop(
        os.environ["FT_CKPT_DIR"],
        state_fn=lambda: {"model": net.state_dict(),
                          "opt": opt.state_dict()},
        restore_fn=lambda s: (net.load_state_dict(s["model"]),
                              opt.set_state_dict(s["opt"])),
        save_every=int(os.environ.get("FT_SAVE_EVERY", "2")),
        keep_last=int(os.environ.get("FT_KEEP_LAST", "3")),
        watchdog_timeout=float(wd) if wd else None)
    loop.run(step_fn, steps)
    out = os.environ.get("FT_OUT")
    if out:
        final = {f"model/{k}": _digest(v)
                 for k, v in net.state_dict().items()}
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                final[f"opt/{i}/{k}"] = _digest(v)
        for dev, s in rng.get_rng_state().items():
            final[f"rng/{dev}"] = _digest(s)
        with open(out, "w") as f:
            json.dump(final, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
    sys.exit(0)


import pytest  # noqa: E402  (the script above needs no pytest)

from paddle_tpu_torch.distributed import checkpoint as ckpt  # noqa: E402
from paddle_tpu_torch.distributed.fault_tolerance import (  # noqa: E402
    ELASTIC_EXIT_CODE, FaultPlan, ResilientLoop, StepWatchdog,
    corrupt_shard,
)
from paddle_tpu_torch.optimizer import SGD  # noqa: E402


def _run(env_extra, timeout=120):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "FT_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    return subprocess.run([sys.executable, os.path.abspath(__file__)],
                          env=env, timeout=timeout, capture_output=True,
                          text=True)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The digests of an 8-step run never killed: the oracle."""
    d = tmp_path_factory.mktemp("ft_clean")
    out = str(d / "final.json")
    r = _run({"FT_CKPT_DIR": str(d / "ck"), "FT_OUT": out})
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out) as f:
        return json.load(f)


class TestChaosKillResume:
    def test_sigterm_commits_and_resume_is_bitwise_identical(
            self, tmp_path, uninterrupted):
        ck = str(tmp_path / "ck")
        r1 = _run({"FT_CKPT_DIR": ck, "PADDLE_TPU_FT_DIE_AT_STEP": "5"})
        assert r1.returncode == ELASTIC_EXIT_CODE, \
            (r1.returncode, r1.stderr[-2000:])
        assert "preempted at step boundary 6" in r1.stderr
        assert ckpt.latest_valid(ck)[0] == 6
        out = str(tmp_path / "final.json")
        r2 = _run({"FT_CKPT_DIR": ck, "FT_OUT": out})
        assert r2.returncode == 0, r2.stderr[-2000:]
        assert "resumed from generation 6 (step 6)" in r2.stderr
        with open(out) as f:
            assert json.load(f) == uninterrupted

    def test_sigkill_resumes_from_last_cadence_save(self, tmp_path,
                                                    uninterrupted):
        ck = str(tmp_path / "ck")
        r1 = _run({"FT_CKPT_DIR": ck, "PADDLE_TPU_FT_DIE_AT_STEP": "5",
                   "PADDLE_TPU_FT_DIE_SIGNAL": "KILL"})
        assert r1.returncode == -signal.SIGKILL
        assert ckpt.latest_valid(ck)[0] == 4
        out = str(tmp_path / "final.json")
        r2 = _run({"FT_CKPT_DIR": ck, "FT_OUT": out})
        assert r2.returncode == 0, r2.stderr[-2000:]
        assert "resumed from generation 4 (step 4)" in r2.stderr
        with open(out) as f:
            assert json.load(f) == uninterrupted

    def test_generation_payload_and_handlers(self, tmp_path):
        """A committed generation holds the user state, ``@step``, the
        generators' ``@rng``, ``@world`` and ``@wall``, and the JAX
        package reads it; the loop's signal handlers do not outlive
        ``run``."""
        from paddle_tpu.distributed import checkpoint as jck

        torch.manual_seed(0)
        net = torch.nn.Linear(2, 2)
        opt = SGD(net.parameters(), lr=0.1)
        before = signal.getsignal(signal.SIGTERM)

        def step_fn(step):
            loss = net(torch.ones(1, 2)).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()

        root = str(tmp_path / "ck")
        ResilientLoop(root, state_fn=lambda: {"model": net.state_dict()},
                      restore_fn=lambda s: net.load_state_dict(s["model"]),
                      save_every=None, verbose=False).run(step_fn, 2)
        assert signal.getsignal(signal.SIGTERM) is before
        step, path = ckpt.latest_valid(root)
        assert step == 2
        got = jck.load_state_dict(path, return_numpy=True)
        assert got["@step"] == 2
        assert got["@world"]["processes"] == 1
        assert isinstance(got["@wall"], float)
        np.testing.assert_array_equal(got["user"]["model"]["weight"],
                                      net.weight.detach().numpy())


class TestChaosWatchdog:
    def test_watchdog_fires_on_injected_stall(self, tmp_path):
        r = _run({"FT_CKPT_DIR": str(tmp_path / "ck"),
                  "FT_WATCHDOG": "1.5",
                  "PADDLE_TPU_FT_STALL_AT_STEP": "3",
                  "PADDLE_TPU_FT_STALL_SECONDS": "120"}, timeout=90)
        assert r.returncode == ELASTIC_EXIT_CODE, \
            (r.returncode, r.stderr[-2000:])
        assert "[watchdog] no step boundary" in r.stderr
        assert "last dispatched program" in r.stderr
        assert "--- thread" in r.stderr
        assert '[flight] {"name": "training", "reason": "watchdog"' \
            in r.stderr

    def test_watchdog_unit_notify_keeps_it_quiet(self):
        fired = []
        wd = StepWatchdog(timeout=0.4, hard_exit=False,
                          on_timeout=lambda: fired.append(1),
                          poll_interval=0.05)
        wd.start()
        for s in range(6):
            wd.notify(s)
            time.sleep(0.1)
        assert not fired and not wd.fired
        wd.pause()
        time.sleep(0.6)
        assert not fired
        wd.notify(7)
        time.sleep(0.8)
        wd.stop()
        assert fired and wd.fired


class TestCheckpointIntegrity:
    def _gen(self, root, step, fill):
        ckpt.save_generation({"w": torch.full((4, 4), float(fill)),
                              "@step": step}, root, step)

    def test_corrupt_shard_never_loaded_falls_back(self, tmp_path):
        from paddle_tpu.distributed import checkpoint as jck

        root = str(tmp_path / "ck")
        for s in (2, 4, 6):
            self._gen(root, s, s)
        assert ckpt.latest_valid(root)[0] == 6
        corrupt_shard(ckpt.generation_dir(root, 6))
        problems = ckpt.verify_checkpoint(ckpt.generation_dir(root, 6))
        assert problems and "crc mismatch" in problems[0]
        # the JAX package sees the same corruption and the same fallback
        assert jck.verify_checkpoint(ckpt.generation_dir(root, 6))
        assert jck.latest_valid(root)[0] == 4
        step, path = ckpt.latest_valid(root)
        assert step == 4
        step, state = ckpt.load_generation(root, device="cpu")
        assert step == 4
        assert torch.equal(state["w"], torch.full((4, 4), 4.0))

    def test_jax_corrupt_shard_flags_port_checkpoint_too(self, tmp_path):
        """The JAX ``corrupt_shard`` on a port generation: the port's
        ``verify_checkpoint`` flags it."""
        from paddle_tpu.distributed.fault_tolerance import (
            corrupt_shard as jax_corrupt,
        )

        root = str(tmp_path / "ck")
        for s in (1, 2):
            self._gen(root, s, s)
        jax_corrupt(ckpt.generation_dir(root, 2))
        assert any("crc mismatch" in p for p in
                   ckpt.verify_checkpoint(ckpt.generation_dir(root, 2)))
        assert ckpt.latest_valid(root)[0] == 1

    def test_missing_shard_and_torn_commit_detected(self, tmp_path):
        root = str(tmp_path / "ck")
        for s in (1, 2):
            self._gen(root, s, s)
        gen2 = ckpt.generation_dir(root, 2)
        npys = [f for f in os.listdir(gen2) if f.endswith(".npy")]
        os.remove(os.path.join(gen2, npys[0]))
        assert any("missing shard" in p
                   for p in ckpt.verify_checkpoint(gen2))
        os.makedirs(ckpt.generation_dir(root, 3))
        assert ckpt.latest_valid(root)[0] == 1

    def test_retention_keeps_exactly_k(self, tmp_path):
        torch.manual_seed(7)
        net = torch.nn.Linear(4, 4)
        opt = SGD(net.parameters(), lr=0.1)
        x = torch.ones(2, 4)

        def step_fn(step):
            loss = net(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()

        root = str(tmp_path / "ck")
        loop = ResilientLoop(
            root, state_fn=lambda: {"model": net.state_dict(),
                                    "opt": opt.state_dict()},
            restore_fn=lambda s: (net.load_state_dict(s["model"]),
                                  opt.set_state_dict(s["opt"])),
            save_every=1, keep_last=2, verbose=False)
        loop.run(step_fn, 5)
        assert ckpt.list_generations(root) == [4, 5]
        with pytest.raises(ValueError):
            ckpt.gc_generations(root, 0)

    def test_crc_recorded_for_every_shard(self, tmp_path):
        root = str(tmp_path / "ck")
        self._gen(root, 1, 1)
        with open(os.path.join(ckpt.generation_dir(root, 1),
                               "index.json")) as f:
            index = json.load(f)
        assert index["format"] == 2
        shards = [sh for meta in index["tensors"].values()
                  for sh in meta.get("shards", ())]
        assert shards and all("crc32" in sh for sh in shards)


class TestInjectionUnit:
    def test_plan_from_env_parsing(self):
        plan = FaultPlan.from_env({
            "PADDLE_TPU_FT_DIE_AT_STEP": "7",
            "PADDLE_TPU_FT_DIE_SIGNAL": "KILL",
            "PADDLE_TPU_FT_STALL_AT_STEP": "3",
            "PADDLE_TPU_FT_STALL_SECONDS": "2.5"})
        assert plan.die_at_step == 7
        assert plan.die_signal == signal.SIGKILL
        assert plan.stall_at_step == 3
        assert plan.stall_seconds == 2.5
        assert plan.armed
        assert not FaultPlan.from_env({}).armed

    def test_fire_is_step_keyed_and_once(self):
        hits = []
        plan = FaultPlan(die_at_step=2, die_signal=signal.SIGUSR1)
        old = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
        try:
            for s in range(4):
                plan.fire(s)
            plan.fire(2)
        finally:
            signal.signal(signal.SIGUSR1, old)
        assert hits == [signal.SIGUSR1]

    def test_mesh_watchdog_is_refused(self, tmp_path):
        """``mesh_watchdog=`` is taken (no longer refused): the loop
        starts the watchdog, feeds it each step boundary, pauses it over
        the commits, stops it at the end, and reports its counters under
        ``elastic_stats()["watchdog"]``."""
        from paddle_tpu_torch.distributed.fault_tolerance import MeshWatchdog
        from paddle_tpu_torch.distributed.fleet.elastic import (
            InMemoryCoordinator,
        )

        coord = InMemoryCoordinator()
        wd = MeshWatchdog(coord, "job", "hostA", heartbeat_interval=30.0,
                          hard_exit=False)
        seen = []
        loop = ResilientLoop(str(tmp_path), state_fn=dict,
                             restore_fn=lambda s: None, save_every=2,
                             verbose=False, mesh_watchdog=wd)

        def step(i):
            seen.append((i, set(wd.peers())))
            time.sleep(0.01)

        assert loop.run(step, 4) == 4
        assert seen == [(i, {"hostA"}) for i in range(4)]
        stats = loop.elastic_stats()["watchdog"]
        assert stats["host"] == "hostA" and stats["heartbeats"] >= 1
        assert stats["step_time_ema_ms"] > 0
        assert wd.peers() == {}            # stopped: deregistered

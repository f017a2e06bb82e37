"""``python -m paddle_tpu_torch.distributed.launch``: data-parallel
training in two processes equals one process, the failure watcher
restarts a failed set and gives up after ``--max_restarts``, and the
elastic mode (``--elastic_coordinator``) runs its rounds.

Spec: ``tests/test_launch.py`` and the elastic cases of
``tests/test_collective_multiproc.py``.  The workers,
``tests/assets/torch_launch_dp_train.py`` and
``tests/assets/torch_elastic_resume_train.py``, import the port only and
train on the CPU over gloo.  Two processes' losses (the mean over the
ranks' slices) and final parameters are the one-process run's within
``rtol=1e-5, atol=1e-7`` (the JAX spec's tolerance); a killed and
resumed run's losses are the uninterrupted run's within ``rtol=1e-6,
atol=1e-8`` (the spec's).  Like its spec, the two-worker kill drill under
the coordinator is marked ``slow``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "assets", "torch_launch_dp_train.py")
RESUME = os.path.join(REPO, "tests", "assets",
                      "torch_elastic_resume_train.py")
LAUNCH = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]


def _run(args, env_extra, timeout=240):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "FLAGS_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra)
    return subprocess.run(args, env=env, timeout=timeout,
                          capture_output=True, text=True, cwd=REPO)


class TestLaunchDP:
    def test_two_process_dp_matches_single(self, tmp_path):
        single_out = str(tmp_path / "single.json")
        r = _run([sys.executable, SCRIPT], {"PADDLE_TEST_OUT": single_out})
        assert r.returncode == 0, r.stderr[-2000:]
        multi_out = str(tmp_path / "multi.json")
        logs = tmp_path / "logs"
        r = _run(LAUNCH + ["--nproc_per_node", "2", "--log_dir", str(logs),
                           SCRIPT], {"PADDLE_TEST_OUT": multi_out})
        assert r.returncode == 0, r.stderr[-2000:]
        single, multi = (json.load(open(p)) for p in (single_out, multi_out))
        for key in ("losses", "weight", "bias"):
            np.testing.assert_allclose(multi[key], single[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
        # one log per worker
        for rank in (0, 1):
            text = (logs / f"workerlog.{rank}").read_text()
            assert f"rank {rank} losses" in text

    def test_watcher_restarts_failed_worker(self, tmp_path):
        marker = str(tmp_path / "died")
        out = str(tmp_path / "out.json")
        r = _run(LAUNCH + ["--nproc_per_node", "2", "--max_restarts", "1",
                           SCRIPT], {"PADDLE_TEST_OUT": out,
                                     "PADDLE_TEST_FAIL_MARKER": marker})
        assert "restart 1/1" in r.stderr, r.stderr[-2000:]
        assert r.returncode == 0, r.stderr[-2000:]
        assert os.path.exists(out)

    def test_watcher_gives_up_after_max_restarts(self, tmp_path):
        r = _run(LAUNCH + ["--nproc_per_node", "1", "--max_restarts", "1",
                           SCRIPT], {"PADDLE_TEST_ALWAYS_FAIL": "1"})
        assert r.returncode == 3
        assert "restart 1/1" in r.stderr and "giving up" in r.stderr


class TestLaunchCLI:
    def test_module_entrypoint_help(self):
        r = _run(LAUNCH + ["--help"], {})
        assert r.returncode == 0
        assert "nproc_per_node" in r.stdout

    def test_elastic_mode_is_not_ported(self, tmp_path):
        """The elastic mode (no longer refused): one round of one node at
        ``--np 1`` trains the DP worker to the end and exits 0, and the
        node's membership is gone from the coordinator after."""
        from paddle_tpu_torch.distributed.fleet.elastic import (
            FileCoordinator,
        )

        coord = str(tmp_path / "coord")
        out = str(tmp_path / "out.json")
        r = _run(LAUNCH + ["--elastic_coordinator", coord, "--np", "1",
                           "--job_id", "solo", SCRIPT],
                 {"PADDLE_TEST_OUT": out})
        assert r.returncode == 0, r.stderr[-2000:]
        assert len(json.load(open(out))["losses"]) == 10
        fc = FileCoordinator(coord)
        assert fc.get_prefix("/paddle_tpu/elastic/solo/nodes/") == []
        assert fc.get("/paddle_tpu/elastic/solo/completed")[0] == b"1"

    def test_worker_contract(self, monkeypatch):
        """Each worker's environment: its rank, local rank and card, the
        world, the endpoints and the rendezvous."""
        from paddle_tpu_torch.distributed import launch as launch_mod

        args = launch_mod._parse(["--nproc_per_node", "2", SCRIPT, "--x"])
        workers = launch_mod._build_workers(args, "127.0.0.1:1234")
        assert [w.rank for w in workers] == [0, 1]
        env = workers[1].env
        assert env["PADDLE_TRAINER_ID"] == "1"
        assert env["PADDLE_LOCAL_RANK"] == "1"
        assert env["PADDLE_TRAINERS_NUM"] == "2"
        assert env["PADDLE_MASTER"] == "127.0.0.1:1234"
        assert env["PADDLE_CURRENT_ENDPOINT"] == \
            env["PADDLE_TRAINER_ENDPOINTS"].split(",")[1]
        assert workers[1].cmd[1:] == [SCRIPT, "--x"]
        monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:1234")
        from paddle_tpu_torch.distributed import ParallelEnv

        penv = ParallelEnv()
        assert (penv.rank, penv.world_size, penv.launched) == (1, 2, True)


class TestElasticLaunch:
    """``--elastic_coordinator`` drives the launcher through the
    ``ElasticManager`` over a ``FileCoordinator`` directory (the JAX
    spec's ``TestElasticLaunch`` and ``TestElasticResume``)."""

    def test_single_node_elastic_completes(self, tmp_path):
        # the two workers share the launcher's stdout: each writes its line
        # in one call, so that unbuffered output (PYTHONUNBUFFERED) cannot
        # interleave the pieces of two prints
        script = tmp_path / "train.py"
        script.write_text(
            "import os, sys\n"
            "sys.stdout.write('RANK %s WORLD %s LOCAL %s\\n' % (\n"
            "    os.environ.get('PADDLE_TRAINER_ID'),\n"
            "    os.environ.get('PADDLE_TRAINERS_NUM'),\n"
            "    os.environ.get('PADDLE_LOCAL_RANK')))\n"
            "sys.stdout.flush()\n")
        r = _run(LAUNCH + ["--nproc_per_node", "2", "--elastic_coordinator",
                           str(tmp_path / "coord"), "--np", "1",
                           str(script)], {})
        assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
        lines = sorted(ln for ln in r.stdout.splitlines()
                       if ln.startswith("RANK"))
        assert lines == ["RANK 0 WORLD 2 LOCAL 0", "RANK 1 WORLD 2 LOCAL 1"]

    def test_two_launchers_rendezvous_via_coordinator(self, tmp_path):
        """Two launchers (two nodes) find each other through the
        coordinator, agree on the rank-0-derived rendezvous and on the
        ranks, and both complete."""
        script = tmp_path / "train.py"
        script.write_text(
            "import os\n"
            "print('OK', os.environ['PADDLE_TRAINER_ID'],\n"
            "      os.environ['PADDLE_TRAINERS_NUM'],\n"
            "      os.environ['PADDLE_MASTER'], flush=True)\n")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("PADDLE_", "FLAGS_"))}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        coord = str(tmp_path / "coord")
        procs = [subprocess.Popen(
            LAUNCH + ["--nproc_per_node", "1", "--elastic_coordinator",
                      coord, "--np", "2", "--host", "127.0.0.1",
                      "--start_port", str(port), str(script)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO) for port in (6270, 6280)]
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, (out[-800:], err[-1500:])
        oks = [ln.split() for out, _ in outs for ln in out.splitlines()
               if ln.startswith("OK")]
        assert sorted(o[1] for o in oks) == ["0", "1"]
        assert {o[2] for o in oks} == {"2"}
        assert len({o[3] for o in oks}) == 1, oks     # one rendezvous

    def _resume(self, tmp_path, nproc, tag, kill_step=None):
        env = {"PADDLE_TEST_CKPT_DIR": str(tmp_path / f"ck_{tag}"),
               "PADDLE_TEST_OUT": str(tmp_path / f"{tag}.json")}
        if kill_step is not None:
            env.update({"PADDLE_TEST_KILL_STEP": str(kill_step),
                        "PADDLE_TEST_KILL_MARKER": str(tmp_path / "died")})
        r = _run(LAUNCH + ["--nproc_per_node", str(nproc), "--max_restarts",
                           "2", "--elastic_coordinator",
                           str(tmp_path / f"coord_{tag}"), "--np", "1",
                           RESUME], env, timeout=300)
        assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
        return json.load(open(env["PADDLE_TEST_OUT"]))

    def test_kill_resume_elastic_coordinator(self, tmp_path):
        """One worker dies hard mid-run under the coordinator: the round
        restarts it (a worker fault within ``--max_restarts``), it resumes
        from the checkpoint, and the losses are the uninterrupted run's."""
        ref = self._resume(tmp_path, 1, "ref")
        got = self._resume(tmp_path, 1, "kill", kill_step=5)
        assert os.path.exists(str(tmp_path / "died"))
        assert len(got) == len(ref) == 10
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-8)

    @pytest.mark.slow
    def test_kill_resume_two_proc_elastic_coordinator(self, tmp_path):
        """The same with two workers: rank 1 dies, the membership
        regenerates, training resumes with loss continuity against an
        uninterrupted two-worker run."""
        ref = self._resume(tmp_path, 2, "ref")
        got = self._resume(tmp_path, 2, "kill", kill_step=4)
        assert os.path.exists(str(tmp_path / "died"))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-8)


def test_hybrid_train_worker_on_cpu(tmp_path):
    """``hybrid_train.py`` (the card's ``hybrid_train`` phase) through the
    launcher on the CPU (gloo, tiny GPT): the fleet step runs through the
    wrappers and is bitwise the step built in one process without them;
    gradient merge equals one full-batch update (1e-6) and refuses a
    compiled step; every collective gives its expected value."""
    import torch

    from paddle_tpu_torch import build_train_step

    out = str(tmp_path / "res.json")
    r = _run(LAUNCH + ["--nproc_per_node", "1", os.path.join(
        "paddle_tpu_torch", "distributed", "launch", "hybrid_train.py"),
        "--out", out, "--config", "tiny", "--seq", "16", "--device", "cpu",
        "--warmup", "2", "--steps", "3"], {})
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.load(open(out))
    assert res["world"] == {"backend": "gloo", "size": 1}
    assert all(res["collectives"].values()), res["collectives"]
    assert res["merge"]["max_abs_diff"] <= 1e-6
    assert res["merge"]["update_max_abs"] > 1e-4
    assert res["merge"]["refuses_to_static"]
    fl = res["fleet"]
    assert (fl["model"], fl["optimizer"]) == ("TensorParallel",
                                              "HybridParallelOptimizer")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # the worker's sums, in its order
    try:
        ts = build_train_step("tiny", batch=8, seq=16, device="cpu")
        assert type(ts.model).__name__ == "GPTForCausalLM"   # no launcher
        losses = [float(ts.train_step(ts.x, ts.y)) for _ in range(5)]
    finally:
        torch.set_num_threads(threads)
    assert losses == fl["losses"]


def _spawned(out_dir):
    """A ``spawn`` target: join the world from the contract, all-reduce."""
    import torch

    from paddle_tpu_torch import distributed as dist

    penv = dist.init_parallel_env(device="cpu")
    t = torch.tensor([float(penv.rank + 1)])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"rank{penv.rank}"), "w") as f:
        f.write(f"{penv.world_size} {t.item()}")


def test_spawn_starts_a_world(tmp_path):
    """``distributed.spawn`` gives each process the launcher's contract:
    two processes join one world and all-reduce."""
    from paddle_tpu_torch import distributed as dist

    dist.spawn(_spawned, args=(str(tmp_path),), nprocs=2)
    for r in (0, 1):
        assert (tmp_path / f"rank{r}").read_text() == "2 3.0"


def test_split_builds_the_parallel_layers():
    """``distributed.split`` returns the tensor-parallel layer (the JAX
    package's form); without a model degree it is one rank's whole
    layer."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mp

    emb = dist.split(None, (64, 16), "embedding")
    assert isinstance(emb, mp.VocabParallelEmbedding)
    assert tuple(emb.weight.shape) == (64, 16)
    row = dist.split(None, (16, 8), "linear", axis=0, gather_out=False)
    assert isinstance(row, mp.RowParallelLinear) and row.input_is_parallel
    col = dist.split(None, (16, 8), "linear", axis=1)
    assert isinstance(col, mp.ColumnParallelLinear) and col.gather_output
    with pytest.raises(ValueError):
        dist.split(None, (4, 4), "conv")
    with pytest.raises(NotImplementedError, match="parameter-server"):
        dist.InMemoryDataset()

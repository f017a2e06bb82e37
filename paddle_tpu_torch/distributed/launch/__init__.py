"""``python -m paddle_tpu_torch.distributed.launch``: start the workers of
a job on this node, watch them, restart the set on a failure.

Port of ``paddle_tpu/distributed/launch/__init__.py`` (``launch`` :294,
``_build_workers`` :133, ``_launch_elastic`` :173).  One worker is one
process, one rank:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py --its-args

Each worker runs ``python train.py ...`` with the environment contract
that :func:`..init_parallel_env` reads: ``PADDLE_TRAINER_ID``,
``PADDLE_LOCAL_RANK`` (its card), ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT`` and
``PADDLE_MASTER`` (``--master``, or ``127.0.0.1:<a free port>``: the
rendezvous of ``torch.distributed``), plus ``FLAGS_selected_gpus``.  With
``--log_dir`` each worker writes ``workerlog.<rank>`` there (else it
shares the launcher's output).

The watcher: when a worker exits non-zero the launcher tears the local
set down and starts it again with the same ranks and a fresh rendezvous
port, up to ``--max_restarts`` times (then it exits with the worker's
code).  A worker that exits with :data:`ELASTIC_EXIT_CODE` asks to be
relaunched (a preemption, a hang watchdog): that is honoured up to
``--max_relaunches`` times and does not use up ``--max_restarts``.

The elastic mode (``--elastic_coordinator DIR``, a
:class:`~..fleet.elastic.FileCoordinator` directory shared by the nodes):
this node registers as ``--host:--start_port`` under ``--job_id`` with a
lease of ``--lease_ttl`` seconds, and an
:class:`~..fleet.elastic.ElasticManager` runs rounds.  A round waits until
the membership is launchable (``--np N``, or ``min:max`` with
``--elastic_timeout`` seconds of grace between them), regenerates the
ranks (survivors keep theirs), starts this node's workers with the new
world, and watches them and the membership: a worker's exit 101 or a
membership change starts a new round; any other failure does too, up to
``--max_restarts`` times (default 3); all workers ending well ends the
job.  Every node derives the round's rendezvous from the shared
membership (the rank-0 endpoint's host, its port + 10000 + a hash of the
membership), unless ``--master`` is given.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

from ..fleet.elastic.manager import ELASTIC_EXIT_CODE

__all__ = ["launch", "main", "ELASTIC_EXIT_CODE"]


def _parse(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="multi-process distributed launcher")
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.environ.get("PADDLE_NPROC_PER_NODE", "1")))
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master", type=str, default=None,
                   help="rendezvous host:port (default 127.0.0.1:<free>)")
    p.add_argument("--ips", type=str, default=None,
                   help="comma-separated node hostnames, node_rank order "
                        "(required for --nnodes > 1)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--max_restarts", type=int, default=None,
                   help="restarts after a worker failure before giving up "
                        "(default: 0, or 3 in the elastic mode)")
    p.add_argument("--max_relaunches", type=int,
                   default=int(os.environ.get("PADDLE_TPU_MAX_RELAUNCHES",
                                              "100")),
                   help="cap on relaunches a worker asks for (exit code "
                        f"{ELASTIC_EXIT_CODE}); these do not use up "
                        "--max_restarts")
    p.add_argument("--start_port", type=int,
                   default=int(os.environ.get("PADDLE_START_PORT", "6170")))
    p.add_argument("--elastic_coordinator", type=str,
                   default=os.environ.get("PADDLE_ELASTIC_COORDINATOR"),
                   help="shared directory of the elastic membership (a "
                        "FileCoordinator)")
    p.add_argument("--np", type=str, default=None,
                   help='elastic node count, "N" or "min:max" (with '
                        "--elastic_coordinator)")
    p.add_argument("--job_id", type=str,
                   default=os.environ.get("PADDLE_ELASTIC_JOB_ID", "default"),
                   help="elastic job id, the coordinator's namespace")
    p.add_argument("--elastic_timeout", type=float,
                   default=float(os.environ.get(
                       "PADDLE_ELASTIC_TIMEOUT", "0") or 0) or None,
                   help="seconds the membership may sit between min and max "
                        "np before a round launches anyway (default 120)")
    p.add_argument("--lease_ttl", type=float,
                   default=float(os.environ.get(
                       "PADDLE_ELASTIC_LEASE_TTL", "0") or 0) or None,
                   help="node lease seconds: a dead node's membership "
                        "lapses after this (default 60)")
    p.add_argument("--host", type=str, default=os.environ.get("POD_IP"),
                   help="this node's address in the elastic membership")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Worker:
    def __init__(self, rank: int, cmd: List[str], env: dict,
                 log_path: Optional[str]):
        self.rank = rank
        self.cmd = cmd
        self.env = env
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._log_f = None

    def start(self) -> None:
        out = None
        if self.log_path:
            self._log_f = out = open(self.log_path, "ab")
        self.proc = subprocess.Popen(self.cmd, env=self.env, stdout=out,
                                     stderr=subprocess.STDOUT if out else None)

    def poll(self):
        return self.proc.poll() if self.proc else None

    def terminate(self) -> None:
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self._log_f:
            self._log_f.close()
            self._log_f = None


def _build_workers(args, master: str) -> List[_Worker]:
    n_local = args.nproc_per_node
    world = n_local * args.nnodes
    if args.nnodes > 1:
        if not args.ips:
            raise SystemExit("--nnodes > 1 requires --ips host0,host1,... "
                             "so every node's endpoints are addressable")
        hosts = [h.strip() for h in args.ips.split(",")]
        if len(hosts) != args.nnodes:
            raise SystemExit(f"--ips lists {len(hosts)} hosts for "
                             f"--nnodes {args.nnodes}")
    else:
        hosts = [master.split(":")[0]]
    endpoints = [f"{hosts[node]}:{args.start_port + node * n_local + i}"
                 for node in range(args.nnodes) for i in range(n_local)]
    workers = []
    for i in range(n_local):
        rank = args.node_rank * n_local + i
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_LOCAL_RANK": str(i),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_MASTER": master,
            "FLAGS_selected_gpus": str(i),
        })
        cmd = [sys.executable, args.training_script] + \
            list(args.training_script_args)
        log = (os.path.join(args.log_dir, f"workerlog.{rank}")
               if args.log_dir else None)
        workers.append(_Worker(rank, cmd, env, log))
    return workers


def _watch(workers: List[_Worker]):
    """Wait until every worker ended well (None) or one failed:
    ``(rank, code)``."""
    while True:
        alive = False
        for w in workers:
            rc = w.poll()
            if rc is None:
                alive = True
            elif rc != 0:
                return w.rank, rc
        if not alive:
            return None
        time.sleep(0.2)


def _launch_elastic(args) -> int:
    """The membership-driven rounds of the elastic mode (see the module);
    returns the exit code."""
    import zlib

    from ..fleet.elastic import (
        ElasticManager, ElasticStatus, FileCoordinator, LauncherInterface,
    )

    host = args.host or socket.gethostname()
    coord = FileCoordinator(args.elastic_coordinator)
    kw = {}
    if args.elastic_timeout is not None:
        kw["elastic_timeout"] = args.elastic_timeout
    if args.lease_ttl is not None:
        kw["lease_ttl"] = args.lease_ttl
    manager = ElasticManager(coord, job_id=args.job_id,
                             np=args.np or str(args.nnodes),
                             curr_host=f"{host}:{args.start_port}", **kw)
    if args.max_restarts is not None:
        # 0 is a real request: a deterministic crash ends the job
        manager.max_faults = args.max_restarts

    class _Launcher(LauncherInterface):
        def __init__(self, workers: List[_Worker]):
            self.workers = workers

        def launch(self):
            for w in self.workers:
                w.start()

        def watch(self):
            alive = False
            for w in self.workers:
                rc = w.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    return rc
            return None if alive else 0

        def stop(self):
            for w in self.workers:
                w.terminate()

    current: List[_Launcher] = []

    def _teardown(sig, _frame):
        for launcher in current:
            launcher.stop()
        manager.exit()
        coord.close()
        sys.exit(128 + sig)

    old_int = signal.signal(signal.SIGINT, _teardown)
    old_term = signal.signal(signal.SIGTERM, _teardown)
    try:
        while True:
            if not manager.wait(timeout=manager.elastic_timeout * 4):
                print("[launch] elastic: the membership never became "
                      "launchable", file=sys.stderr)
                return 1
            env = manager.sync()
            if env is None:
                # this node fell out of the regenerated membership (its
                # lease lapsed during churn): stand by until a slot frees
                time.sleep(max(manager.lease_ttl / 3.0, 0.05))
                continue
            os.environ.update(env)
            hosts = env["PADDLE_TRAINER_ENDPOINTS"].split(",")
            args.nnodes = len(hosts)
            args.node_rank = int(env["PADDLE_TRAINER_ID"])
            args.ips = ",".join(h.split(":")[0] for h in hosts)
            if args.master:
                master = args.master
            else:
                # from the shared membership only, so every node agrees;
                # a new membership gets a new port
                h0, p0 = hosts[0].rsplit(":", 1)
                epoch = zlib.crc32(env["PADDLE_TRAINER_ENDPOINTS"].encode())
                master = f"{h0}:{int(p0) + 10000 + epoch % 97}"
            launcher = _Launcher(_build_workers(args, master))
            current.append(launcher)
            manager.run(launcher)
            try:
                status = manager.watch()
            finally:
                launcher.stop()
                current.clear()
            if status == ElasticStatus.COMPLETED:
                return 0
            if status == ElasticStatus.ERROR:
                return 1
            if status in (ElasticStatus.RESTART, ElasticStatus.HOLD):
                print(f"[launch] elastic: {status}; resyncing the "
                      "membership", file=sys.stderr)
                continue
            return 0
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)
        manager.exit()
        coord.close()


def launch(argv: Optional[List[str]] = None) -> int:
    """Run the launcher; returns the exit code (0: every worker ended
    well)."""
    args = _parse(argv)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    if args.elastic_coordinator:
        return _launch_elastic(args)
    if args.max_restarts is None:
        args.max_restarts = 0
    master = args.master or f"127.0.0.1:{_free_port()}"
    restarts = relaunches = 0
    while True:
        workers = _build_workers(args, master)
        for w in workers:
            w.start()

        def _forward(sig, _frame):
            for w in workers:
                w.terminate()
            sys.exit(128 + sig)

        old_int = signal.signal(signal.SIGINT, _forward)
        old_term = signal.signal(signal.SIGTERM, _forward)
        try:
            failed = _watch(workers)
        finally:
            signal.signal(signal.SIGINT, old_int)
            signal.signal(signal.SIGTERM, old_term)
        for w in workers:
            w.terminate()
        if failed is None:
            return 0
        rank, rc = failed
        print(f"[launch] worker rank {rank} exited with {rc}; tearing down "
              f"peers", file=sys.stderr)
        if rc == ELASTIC_EXIT_CODE:
            if relaunches >= args.max_relaunches:
                print(f"[launch] giving up after {relaunches} requested "
                      f"relaunches", file=sys.stderr)
                return rc
            relaunches += 1
            print(f"[launch] relaunch {relaunches}/{args.max_relaunches} "
                  f"requested by worker (ranks preserved)", file=sys.stderr)
        else:
            if restarts >= args.max_restarts:
                print(f"[launch] giving up after {restarts} restarts",
                      file=sys.stderr)
                return rc
            restarts += 1
            print(f"[launch] restart {restarts}/{args.max_restarts} "
                  f"(ranks preserved)", file=sys.stderr)
        # a fresh rendezvous port avoids a half-dead one
        master = args.master or f"127.0.0.1:{_free_port()}"


def main() -> None:
    sys.exit(launch())

"""The port's profiler against the JAX package's, on the CPU.

Spec: ``tests/test_profiler.py`` (every case has a counterpart here).  The
schedulers agree state by state over a grid of arguments; the profilers'
state machines agree step by step (the JAX one timer-only, so nothing is
traced there); the statistics of the JAX test's synthetic trace are the
same tables in both; a capture on the CPU through ``torch.profiler``
records exactly the RECORD steps' ``RecordEvent`` spans; a Kineto trace's
events are placed by their ``cat``.
"""
import gzip
import itertools
import json
import os

import pytest

import paddle_tpu.profiler as jprofiler
import paddle_tpu_torch.profiler as profiler
from paddle_tpu_torch.profiler import (ProfilerState, ProfilerTarget,
                                       SortedKeys, make_scheduler)
from paddle_tpu_torch.profiler.statistic import StatisticData

GRID = list(itertools.product((0, 1, 2), (0, 1), (1, 3), (0, 2), (0, 3)))


class TestScheduler:
    def test_cycle(self):
        sched = make_scheduler(closed=1, ready=1, record=2, repeat=0)
        assert [sched(i) for i in range(8)] == [
            ProfilerState.CLOSED, ProfilerState.READY,
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN] * 2

    def test_skip_first_and_repeat(self):
        sched = make_scheduler(closed=0, ready=0, record=1, repeat=2,
                               skip_first=2)
        assert [sched(i) for i in range(6)] == [
            ProfilerState.CLOSED, ProfilerState.CLOSED,
            ProfilerState.RECORD_AND_RETURN, ProfilerState.RECORD_AND_RETURN,
            ProfilerState.CLOSED, ProfilerState.CLOSED]

    def test_validation(self):
        for kw in (dict(closed=0, ready=0, record=0),
                   dict(closed=-1, ready=0, record=1)):
            with pytest.raises(ValueError):
                make_scheduler(**kw)
            with pytest.raises(ValueError):
                jprofiler.make_scheduler(**kw)

    @pytest.mark.parametrize("closed,ready,record,repeat,skip", GRID[::4])
    def test_states_equal_jax(self, closed, ready, record, repeat, skip):
        kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
                  skip_first=skip)
        got = [make_scheduler(**kw)(i).name for i in range(24)]
        want = [jprofiler.make_scheduler(**kw)(i).name for i in range(24)]
        assert got == want

    def test_targets(self):
        assert ProfilerTarget.TPU is ProfilerTarget.GPU
        assert [t.name for t in ProfilerTarget] == ["CPU", "GPU"]


def _synthetic():
    """The JAX test's trace: a host span, two overlapping device ops."""
    return {"traceEvents": [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "python host"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "step", "ts": 0,
         "dur": 100},
        {"ph": "X", "pid": 2, "tid": 1, "name": "fusion.1", "ts": 10,
         "dur": 40},
        {"ph": "X", "pid": 2, "tid": 2, "name": "fusion.1", "ts": 30,
         "dur": 40},
    ]}


def _tables(data):
    return ({k: (v.call, v.total_us, v.max_us, v.min_us)
             for k, v in data.host.items()},
            {k: (v.call, v.total_us, v.max_us, v.min_us)
             for k, v in data.device.items()},
            data.device_busy_us, data.wall_us)


class TestStatistic:
    def test_aggregation_and_busy_union(self):
        data = StatisticData.from_chrome_trace(_synthetic())
        want = jprofiler.StatisticData.from_chrome_trace(_synthetic())
        assert _tables(data) == _tables(want)
        assert data.host["step"].call == 1
        assert data.device["fusion.1"].call == 2
        assert data.device["fusion.1"].total_us == 80
        assert data.device_busy_us == 60      # the overlap merged
        assert data.wall_us == 100

    def test_format_tables(self):
        data = StatisticData.from_chrome_trace(_synthetic())
        want = jprofiler.StatisticData.from_chrome_trace(_synthetic())
        for key in (SortedKeys.DeviceTotal, SortedKeys.CPUAvg):
            out = data.format_tables(sorted_by=key)
            assert out == want.format_tables(
                sorted_by=jprofiler.SortedKeys[key.name])
        assert "fusion.1" in out and "device busy" in out

    def test_kineto_categories(self):
        """torch.profiler's events are placed by ``cat``: kernels, copies
        and fills on the device; ops, annotations and Python on the host;
        the runtime's launches and a user annotation's device copy
        left out."""
        evs = [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": d,
                "pid": 0, "tid": 0}
               for c, n, t, d in (
                   ("kernel", "void pt::flash_fwd_kernel<float, 64>", 10, 5),
                   ("kernel", "void pt::flash_fwd_kernel<float, 64>", 20, 5),
                   ("gpu_memcpy", "Memcpy HtoD", 30, 2),
                   ("gpu_memset", "Memset", 40, 1),
                   ("cpu_op", "aten::mm", 0, 50),
                   ("user_annotation", "static_step", 0, 60),
                   ("gpu_user_annotation", "static_step", 5, 40),
                   ("cuda_runtime", "cudaLaunchKernel", 1, 1),
                   ("python_function", "run", 0, 55))]
        data = StatisticData.from_chrome_trace({"traceEvents": evs})
        assert data.device["void pt::flash_fwd_kernel<float, 64>"].call == 2
        assert set(data.device) == {"void pt::flash_fwd_kernel<float, 64>",
                                    "Memcpy HtoD", "Memset"}
        assert set(data.host) == {"aten::mm", "static_step", "run"}
        assert data.host["static_step"].call == 1
        assert data.device_busy_us == 13
        assert data.wall_us == 60


class TestProfilerE2E:
    def test_capture_and_summary(self, tmp_path):
        import torch

        d = str(tmp_path)
        p = profiler.Profiler(
            targets=[ProfilerTarget.CPU],
            scheduler=make_scheduler(closed=1, ready=1, record=2, repeat=1),
            on_trace_ready=profiler.export_chrome_tracing(d))
        x = torch.ones(64, 64)
        p.start()
        for _ in range(5):
            with profiler.RecordEvent("train_step"):
                x @ x
            p.step(num_samples=64)
        p.stop()
        assert p.chrome_trace_path and os.path.exists(p.chrome_trace_path)
        assert os.path.dirname(p.chrome_trace_path) == d
        data = p.statistic_data()
        # only the 2 RECORD steps are in the trace
        assert data.host["train_step"].call == 2
        assert data.host["aten::matmul"].call == 2
        out = p.summary(row_limit=5)
        assert "avg step" in out and "train_step" in out

    def test_state_machine_equals_jax(self, tmp_path):
        """The states each step enters, and the traces handed over, as
        the JAX package's profiler (timer-only there: nothing traced)."""
        import torch

        sched = dict(closed=1, ready=1, record=2, repeat=2)
        exported = []

        def ready(prof):
            exported.append(prof.current_state.name)

        p = profiler.Profiler(targets=[ProfilerTarget.CPU],
                              scheduler=make_scheduler(**sched),
                              on_trace_ready=ready)
        jp = jprofiler.Profiler(timer_only=True,
                                scheduler=jprofiler.make_scheduler(**sched))
        got, want = [], []
        p.start()
        jp.start()
        for _ in range(9):
            torch.ones(4).sum()
            got.append(p.current_state.name)
            want.append(jp.current_state.name)
            p.step()
            jp.step()
        p.stop()
        jp.stop()
        assert got == want
        assert len(exported) == 2          # one trace per RECORD window

    def test_export_protobuf(self, tmp_path):
        import torch

        p = profiler.Profiler(targets=[ProfilerTarget.CPU],
                              scheduler=(1, 3),
                              on_trace_ready=profiler.export_protobuf(
                                  str(tmp_path), "w0"))
        p.start()
        for _ in range(4):
            torch.ones(8).sum()
            p.step()
        p.stop()
        path = p.exported_protobuf
        assert path and os.path.exists(path)
        assert os.path.basename(path).startswith("w0")
        # torch.profiler's tensorboard file is a chrome trace
        data = profiler.load_profiler_result(path)
        assert data.host

    def test_load_gzipped_result(self, tmp_path):
        path = str(tmp_path / "t.json.gz")
        with gzip.open(path, "wt") as f:
            json.dump(_synthetic(), f)
        data = profiler.load_profiler_result(path)
        assert data.device["fusion.1"].call == 2

    def test_record_event_begin_end(self, tmp_path):
        import torch

        p = profiler.Profiler(targets=[ProfilerTarget.CPU],
                              on_trace_ready=profiler.export_chrome_tracing(
                                  str(tmp_path)))
        p.start()
        ev = profiler.RecordEvent("span")
        ev.begin()
        torch.ones(8).sum()
        ev.end()
        p.stop()
        assert p.statistic_data().host["span"].call == 1

    def test_timer_only(self):
        for mod in (profiler, jprofiler):
            p = mod.Profiler(timer_only=True)
            p.start()
            for _ in range(3):
                p.step(num_samples=4)
            p.stop()
            assert p.chrome_trace_path is None

    def test_benchmark_timer(self):
        for mod in (profiler, jprofiler):
            b = mod.benchmark()
            b.reset()
            b.begin()
            for _ in range(3):
                b.step(num_samples=8)
            b.end()
            assert b.avg_step_seconds >= 0
            assert "avg_step" in b.step_info() and "ips" in b.step_info()


def test_registry_names_kept():
    """The registry's surface stays where it was (``obs`` and the engines
    import it from here)."""
    for name in ("serving_stats", "serving_health", "serving_paging",
                 "serving_fleet", "train_stats", "flight_record",
                 "serving_flight_record", "_register_serving_metrics",
                 "_register_fleet_metrics", "_register_train_stats"):
        assert callable(getattr(profiler, name))
    assert profiler.serving_stats() == {} or isinstance(
        profiler.serving_stats(), dict)

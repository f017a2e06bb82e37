"""``chip_smoke.py`` and the port's import boundary, on the CPU.

The card-only phases of ``chip_smoke.py`` run on the card; here its serve,
parity and graph_parity helpers run at ``llama_tiny`` and ``gpt_tiny``
size and its train and train_parity helpers at ``gpt_tiny`` size, with
``device="cpu"`` (the kernels' plain versions, so no kernel launches, and
the engine's step programs run their bodies), and the script itself
must refuse to report a result where there is no card or no repository
around it.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch import create_engine
from paddle_tpu_torch.models import (
    GPTForCausalLM, LlamaForCausalLM, gpt_tiny, llama_tiny,
)
from paddle_tpu_torch.ops import kernels

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _port_sources():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "profile_serving.py",
                    ROOT / "profile_training.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "paddle_tpu"
            or name.startswith("paddle_tpu."))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_serve_phase_on_tiny_cpu():
    """The paged serve phase's helper: shared system prompt, mixed
    greedy/temperature/top-k/top-p requests, more requests than slots."""
    eng = create_engine("llama:tiny", device="cpu", kv_layout="paged",
                        block_size=8, min_bucket=8, max_seq=64, num_slots=4)
    reqs = chip_smoke.make_requests(128, 6, 16, [3, 9, 17, 30], seed=0)
    res = chip_smoke.serve(eng, reqs, max_new_tokens=4)
    assert res["requests"] == 6 and len(res["outputs"]) == 6
    assert res["prefix_hit_rate"] > 0
    assert res["kv_block_invariants"] == "ok"
    # CPU tensors take the plain versions: no kernel launched
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}
    again = chip_smoke.serve(
        create_engine("llama:tiny", device="cpu", kv_layout="contiguous",
                      min_bucket=8, max_seq=64, num_slots=4),
        reqs, max_new_tokens=4)
    assert again["outputs"] == res["outputs"]      # same seeds, same model


def test_parity_phase_on_tiny_cpu():
    model = LlamaForCausalLM(llama_tiny(max_position_embeddings=512),
                             device="cpu",
                             generator=torch.Generator().manual_seed(1))
    rs = np.random.RandomState(2)
    prompt = rs.randint(0, 128, (40,)).tolist()
    tail = rs.randint(0, 128, (9,)).tolist()
    ref, fed = chip_smoke.drive_paged(model, "reference", prompt, 32, tail, 3)
    got, _ = chip_smoke.drive_paged(model, "cuda", prompt, 32, tail, 3,
                                    feed=fed)
    assert len(ref) == 4 and ref[0].shape == (2, 128)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    assert err <= 1e-5


def test_gpt_parity_phase_on_tiny_cpu():
    """``drive_paged`` on a GPT (learned positions, MHA, head dim 16): the
    kernel route's plain versions agree with the reference route."""
    model = GPTForCausalLM(gpt_tiny(max_position_embeddings=512),
                           device="cpu",
                           generator=torch.Generator().manual_seed(1))
    rs = np.random.RandomState(2)
    prompt = rs.randint(0, 128, (40,)).tolist()
    tail = rs.randint(0, 128, (9,)).tolist()
    ref, fed = chip_smoke.drive_paged(model, "reference", prompt, 32, tail, 3)
    got, _ = chip_smoke.drive_paged(model, "cuda", prompt, 32, tail, 3,
                                    feed=fed)
    assert len(ref) == 4 and ref[0].shape == (2, 128)
    assert max((a - b).abs().max().item() for a, b in zip(got, ref)) <= 1e-5


def test_serve_gpt_phase_on_tiny_cpu():
    """The serve_gpt phase's helper on ``gpt:tiny``: prefix hits, a clean
    pool, every program built at warmup and none after."""
    eng = create_engine("gpt:tiny", device="cpu", kv_layout="paged",
                        block_size=8, min_bucket=8, max_seq=64, num_slots=4)
    reqs = chip_smoke.make_requests(128, 6, 16, [3, 9, 17, 30], seed=2)
    res = chip_smoke.serve(eng, reqs, max_new_tokens=4)
    assert res["prefix_hit_rate"] > 0
    assert res["kv_block_invariants"] == "ok"
    assert res["compile_cache"]["misses"] == len(eng.buckets) + 1
    assert res["compile_cache"]["after_warmup"] == 0
    assert res["compile_cache"]["hits"] > 0


def test_serve_fails_when_warmup_leaves_a_program_unbuilt():
    eng = create_engine("gpt:tiny", device="cpu", kv_layout="paged",
                        block_size=8, min_bucket=8, max_seq=64, num_slots=4)
    warm = eng.warmup
    eng.warmup = lambda: warm(buckets=[8])
    reqs = chip_smoke.make_requests(128, 2, 16, [3, 30], seed=2)
    with pytest.raises(AssertionError, match="warmup built 2 programs"):
        chip_smoke.serve(eng, reqs, max_new_tokens=2)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_graph_parity_phase_on_tiny_cpu(layout):
    """The graph_parity helper: the engine's programs and the step bodies
    driven eagerly by the phase give identical streams (on the CPU both
    run the bodies; on the card the first are CUDA graphs)."""
    model = GPTForCausalLM(gpt_tiny(max_position_embeddings=256),
                           device="cpu",
                           generator=torch.Generator().manual_seed(1))
    reqs = chip_smoke.make_requests(128, 4, 48, [5, 40, 17, 90], seed=3)
    res = chip_smoke.drive_graph_parity(model, layout, reqs, 8, num_slots=4,
                                        max_seq=256, min_bucket=16,
                                        block_size=16)
    assert res["identical"] and len(res["programs"]) == 4
    assert all(len(o) == 8 for o in res["eager"])
    assert res["compile_cache"]["after_warmup"] == 0
    assert res["compile_cache"]["hits"] == 4 + 7


def test_train_phase_on_tiny_cpu():
    """The train phase's helper: falling finite losses, the figures it
    prints, and no kernel launched on CPU tensors."""
    res = chip_smoke.run_train("tiny", batch=2, seq=16, device="cpu",
                               warmup=1, steps=2)
    assert len(res["losses"]) == 3 and res["losses"][-1] < res["losses"][0]
    assert res["params"] == sum(
        p.numel() for p in GPTForCausalLM(gpt_tiny(), device="cpu")
        .parameters())
    assert res["tokens_per_s"] > 0 and res["step_ms"] > 0
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}


def test_train_parity_phase_on_tiny_cpu():
    """Both paths take the plain versions on the CPU: they agree exactly,
    and the checker passes them."""
    res = chip_smoke.drive_train_parity(gpt_tiny(), batch=2, seq=16,
                                        device="cpu")
    assert res["loss_rel_err"] == res["grad_rel_err"] == 0.0
    assert res["param_abs_err"] == res["noise_param_abs_err"] == 0.0
    assert 0.0 < res["noise_share"] < 0.5
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}
    chip_smoke.check_train_parity(res)
    with pytest.raises(AssertionError, match="grad_rel_err"):
        chip_smoke.check_train_parity({**res, "grad_rel_err": 1.0})


def test_bound_names_the_larger_time():
    ms, by = chip_smoke.bound(3.35e9, 1.0, torch.bfloat16)
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
    ms, by = chip_smoke.bound(1.0, 989e9, torch.bfloat16)
    assert by == "operations" and abs(ms - 1.0) < 1e-9


def test_main_without_a_card_reports_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py the script exits non-zero
    and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    for line in p.stdout.splitlines():
        assert not (line.startswith("{") and json.loads(line).get("ok"))


@pytest.mark.parametrize("mangled,label", [
    ("_ZN2pt16flash_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_Pfiii",
     "flash_fwd_kernel<bf16,64>"),
    ("_ZN2pt20paged_prefill_kernelIfLi128EEEvPKT_S3_S3_PKiiPS1_",
     "paged_prefill_kernel<f32,128>"),
    ("_ZN2pt19paged_decode_kernelI13__nv_bfloat16Li128ELi4EEEvPKT_S4_",
     "paged_decode_kernel<bf16,128,4>"),
    ("_ZN2pt19flash_bwd_dq_kernelI6__halfLi64EEEvPKT_S4_S4_S4_PKfS6_PS2_",
     "flash_bwd_dq_kernel<f16,64>"),
    ("some_other_symbol", "some_other_symbol"),
])
def test_kernel_label_names_instances(mangled, label):
    assert chip_smoke.kernel_label(mangled) == label


def _hgmma_everywhere():
    """HGMMA counts in every 16-bit instance the build has: bf16 and f16
    for all four kernels (the paged prefill's f16 instance included)."""
    out = {}
    for lib, kernel in chip_smoke.TENSOR_CORE_KERNELS:
        out.setdefault(lib, {}).update(
            {f"{kernel}<{t},{d}>": 8 for d in kernels.HEAD_DIMS
             for t in ("bf16", "f16")})
    return out


@pytest.mark.parametrize("lib,label", [
    ("paged_attention", "paged_prefill_kernel<bf16,128>"),
    ("flash_attention_fwd", "flash_fwd_kernel<bf16,64>"),
    ("flash_attention_bwd", "flash_bwd_dkv_kernel<bf16,64>"),
    ("flash_attention_bwd", "flash_bwd_dq_kernel<bf16,128>"),
    ("flash_attention_fwd", "flash_fwd_kernel<f16,128>"),
    ("flash_attention_bwd", "flash_bwd_dkv_dropout_kernel<f16,64>"),
    ("flash_attention_bwd", "flash_bwd_dq_kernel<f16,128>"),
    ("paged_attention", "paged_prefill_kernel<f16,64>"),
    ("paged_attention", "paged_prefill_kernel<f16,128>"),
])
def test_check_tensor_cores_wants_hgmma_in_bf16_k1_and_k5(lib, label):
    """The bf16 and the f16 K1, K5, K2 and K3 must each hold HGMMA at
    both head dims; one instance without any fails the check, and names
    itself."""
    good = _hgmma_everywhere()
    assert {lib for lib, _ in chip_smoke.TENSOR_CORE_KERNELS} == {
        "paged_attention", "flash_attention_fwd", "flash_attention_bwd"}
    chip_smoke.check_tensor_cores(good)
    bad = {**good, lib: {**good[lib], label: 0}}
    with pytest.raises(AssertionError, match=label.split("<")[0]):
        chip_smoke.check_tensor_cores(bad)


def test_ptxas_by_kernel_labels_each_instance():
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN2pt20flash_bwd_dkv_kernelI13__nv_bfloat16Li128EEEvPKT_' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN2pt20flash_bwd_dkv\n"
        "    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN2pt19flash_bwd_dq_kernelIfLi64EEEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Used 80 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_by_kernel(log) == {
        "flash_bwd_dkv_kernel<bf16,128>":
            "24 bytes stack frame, 20 bytes spill stores, 20 bytes spill "
            "loads; Used 255 registers, used 1 barriers",
        "flash_bwd_dq_kernel<f32,64>": "Used 80 registers, used 1 barriers"}


def test_bf16_grad_parity_phase_on_tiny_cpu():
    """Both paths take the plain versions on the CPU: the bf16 gradient
    check reads no difference and no launch."""
    res = chip_smoke.drive_grad_parity_bf16(gpt_tiny(), batch=2, seq=16,
                                            device="cpu")
    assert np.isfinite(res["loss"])
    assert res["loss_rel_err"] == res["grad_rel_err"] == 0.0
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}


def test_bwd_edges_cover_the_tensor_core_shapes():
    cases = chip_smoke.bwd_edges(None, "flash_bwd_dkv")
    labels = {c[0] for c in cases}
    assert labels == {f"S{S}/{m}/D{d}" for S in (1000, 70)
                      for m in ("causal", "full") for d in (64, 128)} | {
        "S16/causal/D64", "S16/causal/D128"}
    assert all(c[4] == chip_smoke.BF16 for c in cases)
    assert sum(c[5] for c in cases) == 2


def test_cached_build_still_reports_ptxas(tmp_path, monkeypatch):
    """A library built by an earlier process reports the compiler's
    register and spill lines as a fresh build does (the build line reads
    them), from the report kept beside it."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "while [ \"$1\" != \"-o\" ]; do shift; done\n"
        "touch \"$2\"\n"
        "echo \"ptxas info    : Used 42 registers, used 1 barriers\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    first = kernels.build(["flash_attention_bwd"])["flash_attention_bwd"]
    again = kernels.build(["flash_attention_bwd"])["flash_attention_bwd"]
    assert not first["cached"] and again["cached"]
    assert "Used 42 registers" in first["ptxas"]
    assert again["ptxas"] == first["ptxas"]


def test_decode_edges_cover_the_split_k_shapes():
    """K4's edge cases: the first seven (the multi-split ones among them)
    in f32 and bf16, the rest in bf16; one long slot, 32 slots, the long
    table and the groups of 1, 4 and 8 at D 128 are timed."""
    cases = chip_smoke.decode_edges(None)
    labels = [c[0] for c in cases]
    assert labels[:7] == ["len0", "lenP-1,P,P+1", "past_table",
                          "B1/len4095", "B32/len1023", "long_table",
                          "G2/D128"]
    assert set(labels[7:]) == {"G3/D128", "bs32", "shared_prefix"} | {
        f"G{g}/D{d}" for g in (1, 4, 8) for d in (64, 128)}
    assert all(c[4] == chip_smoke.BOTH for c in cases[:7])
    assert all(c[4] == chip_smoke.BF16 for c in cases[7:])
    assert {c[0] for c in cases if c[5]} == {
        "B1/len4095", "B32/len1023", "long_table", "G1/D128", "G4/D128",
        "G8/D128"}


def test_serve_overload_phase_on_tiny_cpu():
    """The serve_overload phase at its own geometry (8 slots, max_seq
    4096, 384 blocks of 16, the 512-token system prompt and its traffic)
    over ``llama_tiny``: no eos ends a stream, so the schedule (admissions,
    deferrals, preemptions, resumes) is the one the card runs.  The phase
    checks itself; here also that every cause and path showed."""
    model = LlamaForCausalLM(llama_tiny(max_position_embeddings=4096),
                             device="cpu",
                             generator=torch.Generator().manual_seed(1))
    eng, res = chip_smoke.run_serve_overload(model.eval())
    assert res["preemptions_by_cause"]["slot"] >= 1
    assert res["preemptions_by_cause"]["blocks"] >= 1
    assert res["shed"] == 2 and len(res["cancelled"]) == 2
    assert res["finished"] == 20
    assert any(r["whole_blocks_hit"] and r["bucket"] == 16
               for r in res["resumes"])
    assert all(c["ttft"]["count"] == c["requests"] > 0
               for c in res["by_class"].values())
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}
    assert eng.stats()["queue_depth_max"] <= eng.max_queue


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_overload_parity_phase_on_tiny_cpu(family, layout):
    """overload_parity's drive: preempted streams and streams through
    failed and retried programs equal the same requests served alone."""
    cfg = dict(max_position_embeddings=256)
    gen = torch.Generator().manual_seed(1)
    model = (LlamaForCausalLM(llama_tiny(**cfg), device="cpu", generator=gen)
             if family == "llama" else
             GPTForCausalLM(gpt_tiny(**cfg), device="cpu", generator=gen))
    res = chip_smoke.drive_overload_parity(model.eval(), layout, seed=6,
                                           max_seq=256, min_bucket=16,
                                           block_size=16)
    chip_smoke.check_overload_parity(res, f"{family}, {layout}")
    assert res["step_failures"] == 4


def _tiny_llama(seed):
    """``llama_tiny`` at serve_paged's positions (4096), from ``seed``."""
    return LlamaForCausalLM(llama_tiny(max_position_embeddings=4096),
                            device="cpu",
                            generator=torch.Generator().manual_seed(seed)
                            ).eval()


def test_serve_durable_phase_on_tiny_cpu(tmp_path):
    """serve_durable at its own geometry (serve_paged's engine and traffic,
    the 8-request crash, the swap, drain and shutdown) over ``llama_tiny``;
    one round of the journal-cost runs.  The phase checks itself; here
    also what each part reports."""
    res = chip_smoke.run_serve_durable(_tiny_llama(0), _tiny_llama,
                                       str(tmp_path), rounds=1)
    cost = res["journal_cost"]["summary"]
    runs = res["journal_cost"]["runs"]
    assert [r["mode"] for r in runs] == ["none", "rotate", "always"]
    # each run's own ITL window: 12 streams of 63 decoded tokens
    assert all(r["itl"]["count"] == r["client_itl"]["count"] == 12 * 63
               for r in runs)
    for mode in ("rotate", "always"):
        # 12 admissions, first tokens and ends, and one record per step
        assert cost[mode]["token_records_per_decode_step"] == 1.0
        assert cost[mode]["records"] == cost["rotate"]["records"] > 36
        assert cost[mode]["bytes"] > 0
        # the write + flush calls are timed inside the appends
        assert 0 < cost[mode]["write_flush_ms"] < cost[mode]["journal_ms"]
    rec = res["recovery"]
    assert rec["replayed"] == 6 and rec["bitwise"]
    # each replay begins with exactly what its client was sent
    assert rec["journal_holds_sent"] and rec["continues_sent"]
    assert rec["sent_tokens"] >= 2 * 6
    assert rec["banked"] == {"finished": 2} and rec["recovered"] == 6
    assert min(rec["streamed_before_crash"]) == 2
    assert res["hot_swap"]["versions"] == [0, 1, 2]
    assert res["hot_swap"]["hit_tokens_after_swaps"] == [0, 0]
    assert res["drain"]["tokens"] == [16] * 4
    assert res["shutdown"]["outcomes"] == [
        ("cancelled", "engine shutdown", "replica")]
    for part in ("journal_cost", "recovery", "hot_swap", "drain"):
        assert res[part]["launches"] == {n: 0 for n in kernels.KERNELS}


def test_sigkill_drill_on_tiny_cpu(tmp_path):
    """The drill's two children at ``gpt_tiny`` size on the CPU: the first
    dies by SIGKILL mid-decode, the second recovers bitwise."""
    res = chip_smoke.sigkill_drill("gpt:tiny", "cpu", "float32", 64,
                                   [6, 11, 14], 8, str(tmp_path))
    assert res["killed_by"] == 9 and res["replayed"] == 3
    assert res["continues_sent"] and res["sent_tokens"] > 0
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}


def test_serve_spec_phase_on_tiny_cpu():
    """serve_spec's drive at its own geometry (serve_paged's traffic, 8
    slots, max_seq 2048, k 4) over ``llama_tiny`` with an independent
    1-layer draft: the speculation counters, a clean pool, every program
    built at warmup, and the greedy streams equal to the plain engine's
    (f32 on the CPU: no near-tie parts them)."""
    model = _tiny_llama(0)
    draft = LlamaForCausalLM(llama_tiny(num_hidden_layers=1,
                                        max_position_embeddings=2048),
                             device="cpu",
                             generator=torch.Generator().manual_seed(1)
                             ).eval()
    reqs = chip_smoke.make_requests(128, 12, 512, chip_smoke.PAGED_TAILS,
                                    seed=0)
    plain = chip_smoke.serve(create_engine(
        model, device="cpu", **{**chip_smoke.SPEC_ENGINE}), reqs, 8)
    eng, res = chip_smoke.run_serve_spec(model, draft, reqs, 8,
                                         plain["outputs"])
    assert res["greedy"] == {"greedy_requests": 3, "equal_share": 1.0,
                             "first_divergence": None}
    sp = res["speculation"]
    assert sp["k"] == chip_smoke.SPEC_K and sp["rounds"] > 0
    assert sp["draft_steps"] == chip_smoke.SPEC_K * sp["rounds"]
    assert res["compile_cache"]["misses"] == 2 * len(eng.buckets) + 2
    assert res["allocator"] == {"invariants": "ok", "blocks_in_use": 0}
    assert res["device_ms_per_round"] is None       # no CUDA events here
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}


def test_greedy_agreement_names_the_first_divergence():
    from paddle_tpu_torch.serving import SamplingParams

    g, t = SamplingParams(), SamplingParams(temperature=1.0, seed=1)
    reqs = [([1], g), ([2], t), ([3], g)]
    out = chip_smoke.greedy_agreement(reqs, [[1, 2], [5], [7, 8, 9]],
                                      [[1, 2], [6], [7, 0, 9]])
    assert out == {"greedy_requests": 2, "equal_share": 0.5,
                   "first_divergence": {"request": 2, "token": 1}}


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_spec_parity_phase_on_tiny_cpu(family, layout):
    """spec_parity's drive: greedy speculative streams (an independent
    1-layer draft, and the target as its own) equal the plain engine's,
    the last request retiring on capacity past max_seq."""
    cfg = dict(max_position_embeddings=256)
    gen = torch.Generator().manual_seed(1)
    dgen = torch.Generator().manual_seed(2)
    if family == "llama":
        model = LlamaForCausalLM(llama_tiny(**cfg), device="cpu",
                                 generator=gen).eval()
        draft = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, **cfg),
                                 device="cpu", generator=dgen).eval()
    else:
        model = GPTForCausalLM(gpt_tiny(**cfg), device="cpu",
                               generator=gen).eval()
        draft = GPTForCausalLM(gpt_tiny(num_hidden_layers=1, **cfg),
                               device="cpu", generator=dgen).eval()
    reqs = chip_smoke.spec_parity_requests(128, 256, seed=3)
    assert len(reqs[-1][0]) == 253
    for d in (draft, model):
        res = chip_smoke.drive_spec_parity(model, d, layout, reqs, 12,
                                           num_slots=4, max_seq=256,
                                           min_bucket=16, block_size=16)
        chip_smoke.check_spec_parity(res, f"{family}, {layout}")
        assert len(res["spec"][-1]) == 4       # 253 + 3 = max_seq


def test_ticket_replay_on_cpu():
    """The ticket drive's order and comparisons (on the CPU the programs
    run their bodies, and K4's plain version runs)."""
    res = chip_smoke.ticket_replay(torch.device("cpu"), torch.float32,
                                   lengths=[30, 7, 0], H=4, Hkv=2, D=8,
                                   bs=8, max_seq=32)
    assert [c[:2] for c in res["calls"]] == [
        ("decode", "capture"), ("verify", "capture"), ("decode", "replay"),
        ("verify", "replay"), ("decode", "replay")]
    assert res["all_equal"] and res["tickets_nonzero"] == 0


def test_serve_tenancy_phase_on_tiny_cpu():
    """serve_tenancy's drive over ``llama_tiny`` (4 slots, paged): lanes
    off bitwise the plain engine in turns, the mixed tenants with every
    json stream accepted, salted prefix domains, a hot swap and an unload
    mid-flight with the JAX engine's ``error_ctx``, a clean pool, no
    program after warmup.  ``scale`` 0.5 moves the tiny model's argmax
    (the 7B's 0.05 does not at width 64)."""
    model = _tiny_llama(0)
    reqs = chip_smoke.make_requests(128, 12, 32, [3, 9, 17, 30], seed=0)
    res = chip_smoke.run_serve_tenancy(
        model, reqs, 12, eos=2, scale=0.5, kv_layout="paged", block_size=8,
        min_bucket=8, num_slots=4, max_seq=128)
    assert res["lanes_off"]["bitwise_plain"]
    assert [len(v) for v in res["lanes_off"]["turns"].values()] == [2, 2]
    per = res["mixed"]["per_tenant"]
    assert sorted(per) == ["base", "grammar:json", "t1", "t2", "t3"]
    assert sum(d["requests"] for d in per.values()) == 12
    assert res["mixed"]["tenants"]["t1"]["completed"] == 3
    assert res["salted_domains"]["t1_only"] == {
        "None": 0, "t1": res["salted_domains"]["t1_only"]["t1"], "t2": 0,
        "t3": 0}
    sw = res["swaps"]
    assert sw["hot_swap"]["error_ctx"] == {"adapter": "t1", "version": 1}
    assert sw["unload"]["error_ctx"] == {"adapter": "t2", "version": 1}
    assert sw["v1_back"] == {"t1": True, "t2": True}
    assert res["allocator"] == {"invariants": "ok", "blocks_in_use": 0}
    assert res["compile_cache"]["after_warmup"] == 0
    assert res["tenancy"]["adapters"] == {"t1": 3, "t2": 2, "t3": 1}
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_tenancy_parity_phase_on_tiny_cpu(family, layout):
    """tenancy_parity's drive: lanes off, speculation, preempt-resume,
    step retries and crash recovery, each against its reference."""
    cfg = dict(max_position_embeddings=256)
    gen = torch.Generator().manual_seed(1)
    dgen = torch.Generator().manual_seed(2)
    if family == "llama":
        model = LlamaForCausalLM(llama_tiny(**cfg), device="cpu",
                                 generator=gen).eval()
        draft = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, **cfg),
                                 device="cpu", generator=dgen).eval()
    else:
        model = GPTForCausalLM(gpt_tiny(**cfg), device="cpu",
                               generator=gen).eval()
        draft = GPTForCausalLM(gpt_tiny(num_hidden_layers=1, **cfg),
                               device="cpu", generator=dgen).eval()
    res = chip_smoke.drive_tenancy_parity(model, layout, draft, eos=2,
                                          max_seq=256, min_bucket=16,
                                          block_size=16)
    chip_smoke.check_tenancy_parity(res, f"{family}, {layout}")
    assert res["spec"][0]["t1"] != res["spec"][0][None]
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}


def test_check_tenancy_parity_names_what_differs():
    res = {"lanes_off": ([[1]], [[1]]), "spec": ({}, {}),
           "preempt": ([[2]], [[3]]), "retry": ([], []),
           "recovery": ([], []), "spec_rounds": 1,
           "preempted": [1, 0, "finished"], "retries": 3,
           "recovered": (2, 0, 0), "after_warmup": 0, "audit": "ok"}
    with pytest.raises(AssertionError, match="preempt: \\[\\[2\\]\\]"):
        chip_smoke.check_tenancy_parity(res, "x")
    res["preempt"] = ([[3]], [[3]])
    chip_smoke.check_tenancy_parity(res, "x")


def test_serve_resilience_phase_on_tiny_cpu():
    """serve_resilience's drive over ``llama_tiny`` with a 1-layer draft
    (paged, 8 slots, block 8): the chaos plan from the environment,
    exhausted retries, the raising and stalled prefix lookups, the
    watchdog on a host stall, the strict sanitized engines and the
    arming cost in turns.  Two parts are card-only and skipped here: (e),
    the device stall (``torch.cuda._sleep``), and the strict guard's
    error in (f)'s control (on the CPU the guard is a null context, so
    the control's reads are counted and its request finishes)."""
    model = _tiny_llama(0)
    draft = LlamaForCausalLM(llama_tiny(num_hidden_layers=1,
                                        max_position_embeddings=2048),
                             device="cpu",
                             generator=torch.Generator().manual_seed(1)
                             ).eval()
    engine = dict(kv_layout="paged", block_size=8, min_bucket=8,
                  num_slots=8)
    res = chip_smoke.run_serve_resilience(
        model, draft, chip_smoke.make_requests(128, 4, 24, [8, 30, 3, 17],
                                               seed=11), 8,
        chip_smoke.make_requests(128, 6, 16, [5, 20, 9], seed=0), 6,
        rounds=1, big=dict(engine, max_seq=128),
        small=dict(engine, max_seq=64))
    a = res["chaos"]
    assert a["failed"] == [2] and a["streams_equal_unfaulted"] == 3
    assert a["retries_by_point"] == {"serving.decode": 1}
    assert a["allocator"] == {"invariants": "ok", "blocks_in_use": 0}
    assert a["compile_cache"]["after_warmup"] == 0
    assert res["exhausted"] == {"batch": ["failed", "failed"],
                                "next_equal": True}
    assert res["prefix_lookup"]["errors"] == 2
    wd = res["watchdog_host"]
    assert (wd["state"], wd["watchdog_armed"], wd["request"]) == (
        "unhealthy", False, "cancelled")
    assert "watchdog_device" not in res          # card-only
    san = res["sanitizer"]
    for label in ("plain", f"spec k={chip_smoke.SPEC_K}"):
        assert san[label]["per_decode_step"] == 0.0
        assert san[label]["decode_steps"] == san[label]["steps_run"] > 0
    ctl = san["control"]
    assert ctl["request"] == "finished" and ctl["guard_violations"] == 0
    assert ctl["counted"] == 7                   # one read a decode step
    cost = res["arming_cost"]
    assert [n for n in cost if n != "sanitizer_reports"] == [
        n for n, _, _ in chip_smoke.ARMINGS]
    assert set(cost["none"]) == {"itl_p50_ms", "tokens_per_s",
                                 "ttft_p50_ms"}
    assert cost["sanitizer_reports"]["sanitize_strict"]["strict"]


def test_serve_fleet_phase_on_tiny_cpu(tmp_path):
    """serve_fleet's drive over ``llama_tiny`` (paged, 8 slots, block 8,
    a 16-token system prompt): (a) dispatch beside a bare engine in turns,
    (b) two failover cycles, (c) a rolling update to the weights of seed
    2, (d) fleet crash recovery.  The memory checks of (b) are card-only."""
    res = chip_smoke.run_serve_fleet(
        _tiny_llama(0), lambda: _tiny_llama(2),
        chip_smoke.make_requests(128, 12, 16, [5, 20, 9, 30], seed=0), 8,
        system_len=16, rounds=1, cycles=2, fault_at=3,
        engine=dict(kv_layout="paged", block_size=8, min_bucket=8,
                    num_slots=8, max_seq=128), root=str(tmp_path))
    d = res["dispatch"]
    assert sorted(d["dispatches"].values()) == [6, 6]
    assert d["affinity_hits"] == 6 and d["affinity_hit_tokens"] == 6 * 16
    assert d["supervise_pass_ms"]["count"] == d["fleet_steps"] > 0
    assert set(d["in_turns"]) == {"fleet", "engine"}
    for row in res["failover"]["cycles"]:
        assert (row["ejections"], row["rebuilds"]) == (1, 1)
        assert row["streams_equal_reference"] == row["requests"]
        assert row["after_warmup"] == [0, 0] and row["restarts_marked"]
        assert row["recovery_ms"] >= row["warmup_ms"] > 0
        assert "memory_allocated_delta_mib" not in row   # card-only
    roll = res["roll"]
    assert roll["model_version"] == 1 and roll["replicas_updated"] == 2
    assert roll["live_streams"] == 4 and roll["stall_ms"] > 0
    assert roll["streams_equal_bare_engine"] == 4
    assert res["trace"]["problems"] == [] and res["trace"]["dropped"] == 0
    crash = res["crash"]
    assert crash["replayed"] == 4
    assert crash["streams_equal_uninterrupted"] == 4
    assert crash["prefix_kept"] == 4


def test_prime_makes_streams_independent_of_placement():
    """A primed request prefills its tail over the same prefix K/V on any
    engine: its stream is the same served alone or in the fleet's waves."""
    from paddle_tpu_torch.serving import Engine

    model = _tiny_llama(0)
    reqs = chip_smoke.make_requests(128, 4, 16, [5, 20, 9, 30], seed=3)
    kw = dict(kv_layout="paged", block_size=8, min_bucket=8, num_slots=8,
              max_seq=128)
    eng = Engine(model, **kw)
    eng.warmup()
    system = reqs[0][0][:16]
    together = chip_smoke.serve_waves(eng, reqs, 6, system=system)["reqs"]
    alone = [chip_smoke.serve_waves(eng, [r], 6, system=system)["reqs"][0]
             for r in reqs]
    assert [r.output_ids for r in together] == [r.output_ids for r in alone]


def test_train_recipe_runs_on_tiny_cpu():
    """train_recipe's helper: finite losses, each step read the
    scheduler's rate, the clipped norm at most 1.0, and the first loss
    bitwise equal with recompute on and off (the same dropout masks)."""
    runs = [chip_smoke.run_recipe(rc, "tiny", 2, 16, "cpu", steps=4)
            for rc in (False, True)]
    for run in runs:
        assert all(np.isfinite(run["losses"]))
        assert run["lr_max_abs_err"] == 0.0
        assert run["grad_norm_after_clip"] <= 1.0 + 1e-6
        assert run["grad_norm_before_clip"] > 1.0
        assert run["program_cache"] == {"programs": 1, "misses": 1,
                                        "captures": 0}
    assert runs[0]["losses"] == runs[1]["losses"]
    assert len(set(runs[0]["lr_seen"])) > 1
    json.dumps(runs)


def test_train_phase_compares_compiled_and_eager_losses_on_tiny_cpu():
    eager = chip_smoke.run_train("tiny", batch=2, seq=16, device="cpu",
                                 warmup=0, steps=3, to_static=False,
                                 check_fall=False)
    graph = chip_smoke.run_train("tiny", batch=2, seq=16, device="cpu",
                                 warmup=1, steps=2)
    assert graph["losses"] == eager["losses"]
    assert graph["program_cache"] == {"programs": 1, "misses": 1, "hits": 2,
                                      "captures": 0}
    assert "program_cache" not in eager


def test_kernels_line_covers_the_dropout_instances():
    assert chip_smoke.RECIPE_KERNELS == (
        "flash_fwd_dropout", "flash_bwd_dkv_dropout", "flash_bwd_dq_dropout")
    assert set(chip_smoke.RECIPE_KERNELS) <= set(kernels.KERNELS)
    labels = {k for _, k in chip_smoke.TENSOR_CORE_KERNELS}
    assert {f"{n}_kernel" for n in chip_smoke.RECIPE_KERNELS} <= labels
    assert chip_smoke.kernel_label(
        "_ZN2pt24flash_fwd_dropout_kernelI13__nv_bfloat16Li64EEEvPKT_"
    ) == "flash_fwd_dropout_kernel<bf16,64>"


def test_kernels_line_covers_the_f16_paged_instances():
    """The f16 K4/K5 are kernels of their own in the registry and in the
    kernels phase, and serve_f16 requires both."""
    assert chip_smoke.F16_SERVE_KERNELS == ("paged_decode_f16",
                                            "paged_prefill_f16")
    for name in chip_smoke.F16_SERVE_KERNELS:
        info = kernels.KERNELS[name]
        assert info.source.endswith("csrc/paged_attention.cu")
        assert info.replaces == kernels.KERNELS[name[:-4]].replaces
    assert torch.float16 in kernels.PAGED_DTYPES
    labels = {c[0] for c in chip_smoke.decode_edges(torch.Generator())}
    assert set(chip_smoke.F16_DECODE_EDGES) <= labels


def _f16_engine(family: str, **kw):
    return create_engine(f"{family}:tiny", device="cpu", dtype=torch.float16,
                         kv_layout="paged", block_size=8, min_bucket=8,
                         max_seq=64, num_slots=4, **kw)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_serve_f16_phase_on_tiny_cpu(family):
    """``serve_f16``'s run at tiny size in f16: every logit the steps hand
    the sampler is finite (the device counter reads 0), every program is
    built at warmup and none after, prefix hits and a clean pool."""
    eng = _f16_engine(family)
    reqs = chip_smoke.make_requests(128, 6, 16, [3, 9, 17, 30], seed=0)
    res = chip_smoke.run_serve_f16(eng, reqs, max_new_tokens=4)
    assert res["nonfinite_logits"] == 0
    assert res["compile_cache"]["after_warmup"] == 0
    assert res["prefix_hit_rate"] > 0 and len(res["outputs"]) == 6
    assert eng.cache.dtype == torch.float16


def test_serve_f16_names_where_an_overflow_starts():
    """An f16 model whose second layer's MLP writes inf (as a projection
    past 65504 rounds to): the counter sees the non-finite logits and the
    error names the first module whose output is not finite, without
    clamping anything."""
    eng = _f16_engine("llama")
    with torch.no_grad():
        eng.model.llama.layers[1].mlp.down_proj.weight[0, 0] = float("inf")
    reqs = chip_smoke.make_requests(128, 2, 16, [3, 9], seed=0)
    with pytest.raises(AssertionError, match=r"non-finite logits.*"
                       r"layers\.1\.mlp\.down_proj"):
        chip_smoke.run_serve_f16(eng, reqs, max_new_tokens=2)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_parity_f16_phase_on_tiny_cpu(family):
    """``parity_f16``'s drive at tiny size: the kernel routes (the plain
    versions here) and the contiguous route against the paged reference,
    all finite and within the phase's tolerance."""
    cls, cfg = ((LlamaForCausalLM, llama_tiny) if family == "llama"
                else (GPTForCausalLM, gpt_tiny))
    model = cls(cfg(max_position_embeddings=512), device="cpu",
                dtype=torch.float16,
                generator=torch.Generator().manual_seed(1)).eval()
    rs = np.random.RandomState(2)
    prompt = rs.randint(0, 128, (40,)).tolist()
    tail = rs.randint(0, 128, (9,)).tolist()
    res = chip_smoke.drive_parity_f16(model, prompt, 32, tail, steps=3)
    assert res["forwards"] == 4 and res["finite"]
    assert res["paged_err"] == 0.0          # one plain route on the CPU
    chip_smoke.check_parity_f16(res, family, cuda=False)
    with pytest.raises(AssertionError, match="contiguous_err"):
        chip_smoke.check_parity_f16({**res, "contiguous_err": 1.0}, family,
                                    cuda=False)


def test_predictor_phase_on_tiny_cpu(tmp_path):
    """``predictor``'s run on a small f16 GPT on the CPU: the artifact
    served through the handles equals the eager forward and is held to
    the reference path, a pool of 2 loads once, no kernel launches on the
    CPU; the checker refuses a second load or a stray launch."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTConfig

    model = GPTForCausalLM(GPTConfig(vocab_size=128, hidden_size=64,
                                     num_hidden_layers=2,
                                     num_attention_heads=2,
                                     max_position_embeddings=64,
                                     hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0),
                           device="cpu",
                           generator=torch.Generator().manual_seed(0)).eval()
    model = amp.decorate(model, level="O2", dtype="float16")
    ids = np.random.RandomState(6).randint(0, 128, (2, 32))
    res = chip_smoke.run_predictor(model, ids, str(tmp_path))
    assert res["input_names"] == ["input_ids"]
    assert res["out_shape"] == [2, 32, 128] and res["out_dtype"] == "float16"
    assert res["eager_err"] == 0.0 and res["device"] == "cpu"
    chip_smoke.check_predictor(res, 2, cuda=False, tag="cpu")
    with pytest.raises(AssertionError, match="loaded 2 times"):
        chip_smoke.check_predictor({**res, "pool_loads": 2}, 2, cuda=False,
                                   tag="cpu")
    stray = {**res["launches"], "flash_fwd": 1}
    with pytest.raises(AssertionError, match="launched"):
        chip_smoke.check_predictor({**res, "launches": stray}, 2,
                                   cuda=False, tag="cpu")
    tiny = chip_smoke.cpu_artifact_on_card(str(tmp_path), "cpu")
    assert tiny["err"] == 0.0 and tiny["device"] == "cpu"
    assert sum(tiny["launches"].values()) == 0


def test_fp16_scaler_phase_on_tiny_cpu():
    """``train_fp16_scaler``'s run and checks on ``gpt_tiny`` on the CPU
    (no graph there: the body runs every call): from a scale past the
    f16 range the first steps overflow, leave the state's checksums as
    they were and halve the scale, then steps apply; the trajectory is the
    JAX rule's, and the JAX scaler fed the same ``found_inf`` sequence
    gives the same scales."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn

    run = chip_smoke.run_fp16_scaler(8, 2.0 ** 22, config="tiny", batch=2,
                                     seq=16, device="cpu")
    assert run["found_inf"][0] and not run["found_inf"][-1]
    chip_smoke.check_fp16_scaler(run, "cpu")
    bad = {**run, "checksums": [[0, 0, 0]] + run["checksums"][1:]}
    with pytest.raises(AssertionError, match="changed the state"):
        chip_smoke.check_fp16_scaler(bad, "cpu")
    with pytest.raises(AssertionError, match="JAX rule"):
        chip_smoke.check_fp16_scaler({**run, "scales": run["scales"][::-1]},
                                     "cpu")
    # the rule replayed on the host is the JAX scaler's own
    kw = chip_smoke.SCALER_KW
    scaler = paddle.amp.GradScaler(**{**kw, "init_loss_scaling": 2.0 ** 22})
    lin = jnn.Linear(2, 1)
    opt = paddle.optimizer.SGD(learning_rate=0.0,
                               parameters=lin.parameters())
    jax_scales = []
    for f in run["found_inf"]:
        scaler.scale(lin(paddle.to_tensor(np.ones((1, 2), np.float32)))
                     .sum()).backward()
        if f:
            lin.weight.grad = np.full((2, 1), np.inf, np.float32)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        jax_scales.append(scaler.get_loss_scaling())
    assert jax_scales == run["scales"] == chip_smoke.scaler_rule(
        run["found_inf"], **{**kw, "init": 2.0 ** 22})


@pytest.mark.parametrize("family,layout", [("llama", "paged"),
                                           ("gpt", "contiguous")])
def test_serve_mesh_phase_on_tiny_cpu(family, layout):
    """serve_mesh's helper on a gloo world of one (``serving_mesh(1)``
    with no process group, on the CPU): the plain and mesh engines in
    turns give the plain engine's streams (all four laws), the mesh's
    step programs issue the all-reduces and the all-gather (counted a
    decode step and over each turn), the plain engine none, and no
    program is built after warmup."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.serving import Engine, serving_mesh

    cls, cfg = ((LlamaForCausalLM, llama_tiny) if family == "llama"
                else (GPTForCausalLM, gpt_tiny))
    model = cls(cfg(), device="cpu",
                generator=torch.Generator().manual_seed(0)).eval()
    kw = dict(kv_layout=layout, num_slots=4, max_seq=64, min_bucket=8,
              block_size=8)
    reqs = chip_smoke.make_requests(128, 6, 16, [3, 9, 17, 30], seed=0)
    assert not dist.is_initialized()
    try:
        mesh = serving_mesh(1, device="cpu")
        ref = chip_smoke.serve(Engine(model, **kw), reqs, max_new_tokens=4)
        res = chip_smoke.run_serve_mesh(Engine(model, **kw),
                                        Engine(model, mesh=mesh, **kw),
                                        reqs, 4, ref["outputs"])
    finally:
        mp_layers.reset_collectives()
        if dist.is_initialized():
            dist.destroy_process_group()
    layers = model.config.num_hidden_layers
    assert res["collectives_per_decode_step"] == {
        "all_reduce": 2 * layers + 1, "all_gather": 1}
    assert [t["engine"] for t in res["turns"]] == list(chip_smoke.MESH_TURNS)
    mesh_steps = sum(t["decode_steps"] for t in res["turns"]
                     if t["engine"] == "mesh")
    assert res["collectives"]["all_reduce"] >= \
        mesh_steps * (2 * layers + 1)
    assert res["launches"] == {}         # the CPU runs the plain versions
    assert set(res["summary"]) == {"plain", "mesh"}


@pytest.fixture(scope="module")
def resilience_tiny():
    return chip_smoke.drive_train_resilience("tiny", batch=2, seq=16,
                                             device="cpu")


def test_train_resilience_phase_on_tiny_cpu(resilience_tiny):
    """train_resilience's helper at gpt_tiny on the CPU: one anomaly,
    rollback and skip; the rolled-back state and the resumed state bitwise
    equal to their oracles'; the drill's first loss the bench step's; one
    program (no capture off the card) and no steady-state compile; the
    preempted loop exits 101 with its handler restored and a valid
    generation; the cost ledger adds no program; no kernel launched on
    CPU tensors; every figure JSON-ready."""
    res = resilience_tiny
    drill, pre, cost = res["drill"], res["preempt"], res["cost"]
    c = drill["counters"]
    assert (c["anomalies"], c["rollbacks"], c["skipped_steps"]) == (1, 1, 1)
    assert c["blocklist"] == [chip_smoke.RESILIENCE_NAN_STEP]
    assert drill["bitwise"] and pre["bitwise"]
    assert drill["first_loss"] == drill["reference_loss"]
    assert np.isnan(drill["losses"][chip_smoke.RESILIENCE_NAN_STEP])
    assert (drill["programs"], drill["captures"]) == (1, 0)
    assert drill["compiles"]["compiles"] == 1
    assert drill["compiles"]["steady_state_misses"] == 0
    assert drill["timeline_problems"] == [] and drill["rolled_back_spans"]
    assert drill["restore_ms"] > 0 and drill["snapshot_ms"] > 0
    assert set(res["sentry_cost"]) == {"no_sentry", "sentry", "cost_pct",
                                       "resolved"}
    for k in ("no_sentry", "sentry"):
        v = res["sentry_cost"][k]
        assert len(v["step_ms"]) == 2 * chip_smoke.SENTRY_TURN_STEPS
        assert v["q1"] <= v["median"] <= v["q3"]
    assert isinstance(res["sentry_cost"]["resolved"], bool)
    assert pre["exit_code"] == 101 and pre["handler_restored"]
    assert pre["generations"] == [chip_smoke.PREEMPT_AT + 1]
    assert pre["verify_problems"] == []
    assert pre["completed"] == chip_smoke.PREEMPT_STEPS
    assert pre["gb_written"] > 0 and pre["resume_s"] > 0
    assert cost["new_programs"] == cost["new_captures"] == 0
    assert cost["eager_run_launches"] == {}    # no kernel on the CPU
    assert cost["attention_calls"] == 3 * gpt_tiny().num_hidden_layers
    assert 1.0 < cost["flops_vs_6nd"] < 4.0
    assert res["launches"] == {n: 0 for n in kernels.KERNELS}
    json.dumps(res)


def test_train_resilience_phase_fails_on_a_broken_hold(resilience_tiny,
                                                       monkeypatch, capsys):
    """The phase prints its four parts and its holds, and raises naming
    every broken hold (here the card-only ones a CPU run breaks: no
    capture, no kernel launched); with them mended it passes."""
    monkeypatch.setattr(chip_smoke, "drive_train_resilience",
                        lambda reference_loss=None: resilience_tiny)
    with pytest.raises(AssertionError) as ei:
        chip_smoke.phase_train_resilience()
    for hold in ("one_program_one_capture", "dropout_kernels",
                 "k1_k3_launched"):
        assert hold in str(ei.value)
    assert "rollback_bitwise" not in str(ei.value)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["part"] for ln in lines
            if ln["phase"] == "train_resilience"] == [
        "a", "a_sentry_cost", "b", "c", "holds"]
    mended = json.loads(json.dumps(resilience_tiny))
    mended["drill"]["captures"] = 1
    mended["preempt"]["dropout_launches"] = {
        n: 1 for n in chip_smoke.RECIPE_KERNELS}
    mended["launches"] = {n: 1 for n in kernels.KERNELS}
    monkeypatch.setattr(chip_smoke, "drive_train_resilience",
                        lambda reference_loss=None: mended)
    assert chip_smoke.phase_train_resilience() == mended["launches"]


#: a BERT-shaped masked-LM model at a tiny width (head dim 64, a kernel
#: head dim, so the encoder takes the kernel route)
BERT_TINY = {"vocab_size": 64, "hidden_size": 128, "num_hidden_layers": 2,
             "num_attention_heads": 2, "intermediate_size": 64,
             "max_position_embeddings": 32, "type_vocab_size": 2,
             "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}


def test_nn_encoder_phase_on_tiny_cpu():
    """``phase_nn_encoder`` at a tiny width on the CPU (the kernels' plain
    versions): the compiled step's first losses bitwise the eager
    step's, losses finite and falling, the kernel route every layer of
    every step and of the eval forward, the plain route only in the
    decoder's masked and cross attention, the f32 parity within
    tolerance."""
    res = chip_smoke.phase_nn_encoder(BERT_TINY, "cpu", (2, 16),
                                      (2, 8, 16), (2, 16))
    steps = len(res["losses"])
    assert steps == 13 and res["eager_max_abs_diff"] == 0.0
    assert res["train_routes"] == {"kernel": 2 * steps}
    assert res["eval_routes"] == {"kernel": 2}
    assert res["cross"]["routes"] == {"kernel": 2, "plain": 4}
    assert res["parity"]["grad_rel_err"] <= \
        chip_smoke.TRAIN_PARITY_TOLERANCE["grad"]
    assert not res["train_launches"] and not res["eval_launches"]


def test_nn_encoder_holds_refuse_a_plain_route():
    res = {"losses": [2.0, 1.0], "eager_max_abs_diff": 0.0,
           "eager_losses": [2.0], "program_cache": {},
           "train_routes": {"kernel": 4, "plain": 1},
           "eval_routes": {"kernel": 2}}
    with pytest.raises(AssertionError, match="plain attention route"):
        chip_smoke.check_nn_encoder(res, 2, cuda=False)
    res["train_routes"] = {"kernel": 4}
    res["losses"] = [1.0, 2.0]
    with pytest.raises(AssertionError, match="losses"):
        chip_smoke.check_nn_encoder(res, 2, cuda=False)


#: seq2seq at a tiny width: 2 layers, hidden 32, vocabularies of 64
SEQ2SEQ_TINY = {**chip_smoke.SEQ2SEQ, "src_vocab": 64, "trg_vocab": 64,
                "embed": 32, "hidden": 32, "batch": 8, "beam": 4,
                "max_out": 12, "min_len": 4, "max_len": 12}


def test_seq2seq_phase_on_tiny_cpu():
    """``phase_seq2seq`` at a tiny width on the CPU: ``Model.fit`` over two
    workers (every batch through the ring), the losses equal to the CPU
    twin's (the same device: bitwise), the beam search held to its CPU
    copy's (every step decided or not, ids equal) and its backtrace."""
    res = chip_smoke.phase_seq2seq(SEQ2SEQ_TINY, "cpu", (1, 2))
    assert len(res["losses"]) == 3 and res["loss_rel_err"] == 0.0
    assert res["transport"] == {"ring": 3, "queue": 0}
    assert res["decode_untrained"]["steps"] == SEQ2SEQ_TINY["max_out"]
    for part in ("decode_untrained", "decode"):
        assert res[part]["cpu_rows"] == 8
        assert res[part]["score_rel_err"] == 0.0
    assert 0.0 <= res["data_fetch_share"] < 1.0
    assert not res["launches"] and not res["routes"]


def test_seq2seq_model_matches_a_hand_loop():
    """The decoder's teacher-forced forward equals stepping its cell by
    hand, and the loss is the example's (masked, batch mean, step sum)."""
    from paddle_tpu_torch import device_guard, rng

    cfg = SEQ2SEQ_TINY
    data = chip_smoke.Seq2SeqPairs(cfg, 4)
    rng.seed(0)
    with device_guard("cpu"):
        net = chip_smoke.seq2seq_model(cfg).eval()
    src, src_len, trg = (torch.from_numpy(a[:4]) for a in (
        data.src, data.src_len, data.trg_in))
    logits = net(src, src_len, trg)
    keys, states, mask = net.encode(src, src_len)
    for b in range(4):
        row, n = mask[b, 0], int(src_len[b])
        assert (row[:n] == 0).all() and (row[n:] == -1e9).all()
    for t in range(trg.shape[1]):
        out, states = net.cell(net.trg_embedder(trg[:, t]), states, keys,
                               mask)
        torch.testing.assert_close(net.output_layer(out), logits[:, t],
                                   rtol=0, atol=0)
    label, tmask = (torch.from_numpy(a[:4]) for a in (data.trg_out,
                                                      data.trg_mask))
    ce = torch.nn.functional.cross_entropy(logits.transpose(1, 2), label,
                                           reduction="none")
    torch.testing.assert_close(chip_smoke.seq2seq_loss(logits, label, tmask),
                               (ce * tmask).sum() / 4)
    assert (data.trg_out[data.trg_mask == 0] == cfg["eos"]).all()
    assert data.trg_mask.sum(1).min() >= cfg["min_len"] + 1


def test_compare_beams_refuses_a_decided_difference():
    """Where the CPU's margins are wide, a differing id fails; past a
    near-tie it does not."""
    from types import SimpleNamespace

    def dec(ids, scores, tops):
        ids = torch.tensor(ids)
        return SimpleNamespace(raw=SimpleNamespace(
            predicted_ids=ids, parent_ids=torch.zeros_like(ids),
            scores=torch.tensor(scores)), tops=[torch.tensor(t)
                                                for t in tops])

    tops = [[[0.0, -1.0, -2.0]], [[-1.0, -1.00001, -3.0]]]
    ref = dec([[[1, 2]], [[3, 4]]], [[[0.0, -1.0]], [[-1.0, -1.00001]]],
              tops)
    swapped = dec([[[1, 2]], [[4, 3]]], [[[0.0, -1.0]], [[-1.00001, -1.0]]],
                  tops)
    got = chip_smoke.compare_beams(swapped, ref, chip_smoke.SEQ2SEQ_TOLERANCE)
    assert got["decided_share"] == 0.5
    wrong = dec([[[2, 1]], [[3, 4]]], [[[0.0, -1.0]], [[-1.0, -1.00001]]],
                tops)
    with pytest.raises(AssertionError, match="decided ids"):
        chip_smoke.compare_beams(wrong, ref, chip_smoke.SEQ2SEQ_TOLERANCE)


#: hapi_fit at a tiny width (BERT 2 layers of 64)
HAPI_TINY = {"batch": 2, "seq": 16, "predictions": 4, "train": 3, "eval": 2,
             "predict": 1}
BERT_TINY_64 = {**BERT_TINY, "hidden_size": 64, "num_attention_heads": 1}


def test_hapi_fit_phase_on_tiny_cpu():
    """``phase_hapi_fit`` at a tiny width on the CPU: fit with the three
    callbacks, evaluate, predict, the checkpoint's load bitwise, summary's
    count, the kernel route in every attention call."""
    res = chip_smoke.phase_hapi_fit(BERT_TINY_64, "cpu", HAPI_TINY)
    assert len(res["losses"]) == 3 and res["lr_steps"] == 3
    assert res["load_bitwise"]
    assert res["summary"]["total_params"] == res["params"]
    # 2 layers: 3 train batches, the epoch's 2 eval batches
    assert res["fit_routes"] == {"kernel": 2 * (3 + 2)}
    assert res["eval_routes"] == {"kernel": 4}
    assert res["predict_routes"] == {"kernel": 2}
    assert set(res["eval_logs"]) == {"loss", "acc"}
    assert not res["fit_launches"]


def test_hapi_fit_holds_want_twelve_launches_a_batch():
    res = {"losses": [1.0] * 6, "lr_steps": 6, "load_bitwise": True,
           "params": 132_363_066,
           "summary": {"total_params": 132_363_066},
           "fit_routes": {"kernel": 96}, "eval_routes": {"kernel": 24},
           "predict_routes": {"kernel": 12},
           "fit_launches": {**{n: 72 for n in chip_smoke.NN_TRAIN_KERNELS},
                            "flash_fwd": 24},
           "eval_launches": {"flash_fwd": 24},
           "predict_launches": {"flash_fwd": 12}}
    chip_smoke.check_hapi_fit(res, chip_smoke.BERT_BASE, chip_smoke.HAPI_FIT,
                              cuda=True)
    res["fit_launches"] = {**res["fit_launches"], "flash_fwd_dropout": 71}
    with pytest.raises(AssertionError, match="fit launches"):
        chip_smoke.check_hapi_fit(res, chip_smoke.BERT_BASE,
                                  chip_smoke.HAPI_FIT, cuda=True)
    res["fit_launches"]["flash_fwd_dropout"] = 72
    res["predict_routes"] = {"kernel": 11, "plain": 1}
    with pytest.raises(AssertionError, match="plain attention route"):
        chip_smoke.check_hapi_fit(res, chip_smoke.BERT_BASE,
                                  chip_smoke.HAPI_FIT, cuda=True)


def test_dy2static_generate_phase_on_tiny_cpu(tmp_path):
    """``dy2static_generate``'s drive at 2 layers on the CPU: the eager
    loop, ``to_static`` (its body run eagerly here) and the saved program
    served by ``create_predictor`` give the same ids and ``cur_len``, and
    an eos taken from the eager run stops the loop early; no kernel
    launches on the CPU."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

    torch.manual_seed(0)
    model = GPTForCausalLM(gpt_tiny(), device="cpu").eval()
    gen = chip_smoke.GreedyGenerator(model, 24)
    ids = np.random.RandomState(7).randint(0, 128, (2, 24))
    res = chip_smoke.drive_generate(gen, ids, 6, -1, "cpu", str(tmp_path))
    chip_smoke.check_generate(res, 2, "tiny", cuda=False)
    assert res["eager_len"] == 24 and res["captures"] == 0
    assert res["replay_launches"] == {} and res["predictor_launches"] == {}
    eos = int(res["eager_ids"][0, 6 + 4])
    early = chip_smoke.drive_generate(gen, ids[:1], 6, eos, "cpu", "",
                                      predictor=False)
    chip_smoke.check_generate(early, 2, "tiny/early", cuda=False)
    assert early["eager_len"] <= 6 + 5


def test_ops_phase_on_cpu():
    """``ops``' drive with the CPU on both sides: every row of both op
    suites runs, and none differs from itself (on the card the same drive
    holds the card to the CPU)."""
    res = chip_smoke.drive_ops("cpu", "cpu")
    assert res["ops"] == 362 and res["failed"] == 0, res["failures"]
    assert res["grad_rows"] > 200 and "multinomial" in res["random_rows"]


def test_ops_phase_names_a_differing_row(monkeypatch):
    """A row that differs between the two devices is counted and named
    (here the second side's ``lerp`` is off by 1e-3)."""
    R = chip_smoke.op_rows()
    run = R.run_row
    calls = []

    def skewed(spec, device, seed=0):
        out = run(spec, device, seed)
        calls.append(device)
        if spec.name == "lerp" and len(calls) % 2 == 0:
            out["out"] = [o + 1e-3 for o in out["out"]]
        return out

    monkeypatch.setattr(R, "run_row", skewed)
    res = chip_smoke.drive_ops("cpu", "cpu", names=["lerp", "add"])
    assert res["failed"] == 1 and list(res["failures"]) == ["lerp"]


#: resnet_fit at a CPU's size: ResNet-18 at 64 x 64, batch 32 (at lr 0.1 a
#: smaller batch diverges), 2 workers
RESNET_TINY = dict(chip_smoke.RESNET_FIT, depth=18, image=(3, 64, 64),
                   batch=32, workers=2)


def test_resnet_fit_phase_on_tiny_cpu():
    """``resnet_fit``'s drive and holds on the CPU: 12 batches through
    ``Model.fit`` over 2 workers (every batch through the ring), the loss
    falling on the memorised FakeData, ``summary``'s count the model's,
    ``evaluate``'s top-1 and top-5, no kernel launches and no plain
    route."""
    res = chip_smoke.drive_resnet_fit(RESNET_TINY, "cpu")
    chip_smoke.check_resnet_fit(res, RESNET_TINY)
    assert res["params"] == 11_689_512 and res["launches"] == {}
    assert len(res["eval_accuracy_top1_top5"]) == 2
    assert res["images_per_s"] > 0 and res["loader_wait_ms_per_batch"] >= 0
    bad = dict(res, losses=res["losses"][::-1])
    with pytest.raises(AssertionError, match="did not fall"):
        chip_smoke.check_resnet_fit(bad, RESNET_TINY)


#: mobilenet_fit at a CPU's size: MobileNetV3-small, batch 16 of 64 x 64
#: crops from 16 images of sides 72-96 (resized to 72 for eval), 2 workers
MOBILENET_TINY = dict(chip_smoke.MOBILENET_FIT, arch="mobilenet_v3_small",
                      image=(3, 64, 64), resize=72, batch=16, images=16,
                      sides=(72, 96), workers=2)


def test_mobilenet_fit_phase_on_tiny_cpu(tmp_path):
    """``mobilenet_fit``'s drive and holds on the CPU: 12 batches of
    augmented images through ``Model.fit`` over 2 workers (every batch
    through the ring, each ``[16, 3, 64, 64]`` float32 at the network),
    the loss falling, ``summary``'s count the model's, no kernel launches
    and no plain route."""
    res = chip_smoke.drive_mobilenet_fit(MOBILENET_TINY, "cpu",
                                         str(tmp_path))
    chip_smoke.check_mobilenet_fit(res, MOBILENET_TINY)
    assert res["launches"] == {} and not res["routes"]
    assert len(os.listdir(tmp_path)) == 10
    assert res["images_per_s"] > 0 and res["one_worker_batch_ms"] > 0
    assert len(res["eval_accuracy_top1_top5"]) == 2
    bad = dict(res, batches=res["batches"][:-1] + [[[16, 3, 60, 64],
                                                    "torch.float32"]])
    with pytest.raises(AssertionError, match="received"):
        chip_smoke.check_mobilenet_fit(bad, MOBILENET_TINY)


def test_mobilenet_fit_counts_the_large_model():
    """At its card shape the phase holds MobileNetV3-large at 1000 classes
    to 5,483,032 parameters."""
    res = {"params": 5_483_032, "summary": {"total_params": 5_483_032},
           "losses": [6.9] + [5.0] * 11,
           "transport": {"ring": 12, "queue": 0},
           "batches": [[[64, 3, 224, 224], "torch.float32"]] * 12}
    chip_smoke.check_mobilenet_fit(res, chip_smoke.MOBILENET_FIT)
    with pytest.raises(AssertionError, match="parameters"):
        chip_smoke.check_mobilenet_fit(dict(res, params=5_483_033),
                                       chip_smoke.MOBILENET_FIT)


#: vision_ops at a CPU's size: the same ops, the detectors' shapes cut
VISION_OPS_TINY = {
    "yolo": dict(chip_smoke.VISION_OPS["yolo"], batch=2, grids=(2, 4, 8),
                 classes=6, image=64, gt_boxes=8),
    "nms": dict(chip_smoke.VISION_OPS["nms"], boxes=120, categories=5,
                top_k=20),
    "roi": dict(chip_smoke.VISION_OPS["roi"], feat=(2, 8, 20, 24), rois=16,
                sides=(8, 48)),
    "psroi": dict(chip_smoke.VISION_OPS["psroi"], feat=(2, 98, 20, 24)),
    "deform": dict(chip_smoke.VISION_OPS["deform"], x=(2, 8, 6, 7),
                   cout=8),
    "viterbi": dict(chip_smoke.VISION_OPS["viterbi"], batch=4, seq=10,
                    tags=6),
}


def test_vision_ops_phase_on_cpu():
    """``vision_ops``' drive with the CPU on both sides at small shapes:
    every op runs, with its gradient where it has one, and none differs
    from itself (on the card the same drive holds the card to the
    CPU)."""
    res = chip_smoke.drive_vision_ops(VISION_OPS_TINY, "cpu", "cpu",
                                      reps=1)
    assert not res["failed"], res["failed"]
    ops = res["ops"]
    assert len(ops) == 12 and all(r["max_abs_err"] == 0 for r in
                                  ops.values())
    assert "ms_with_grad" in ops["roi_align"] \
        and "ms_with_grad" not in ops["nms"]
    assert ops["roi_align"]["outputs"] == [[32, 8, 7, 7]]
    assert ops["psroi_pool"]["outputs"] == [[32, 2, 7, 7]]


def test_vision_ops_phase_names_a_differing_op(monkeypatch):
    """An op whose second run differs is named: a float output beyond the
    tolerance, and an nms index (integers must be equal)."""
    from paddle_tpu_torch.vision import ops as V

    calls = {"roi_align": 0, "nms": 0}
    align, nms = V.roi_align, V.nms

    def skewed_align(*a, **k):
        calls["roi_align"] += 1
        out = align(*a, **k)
        return out * 1.01 if calls["roi_align"] == 2 else out

    def skewed_nms(*a, **k):
        calls["nms"] += 1
        out = nms(*a, **k)
        return out.flip(0) if calls["nms"] == 2 else out

    monkeypatch.setattr(V, "roi_align", skewed_align)
    monkeypatch.setattr(V, "nms", skewed_nms)
    res = chip_smoke.drive_vision_ops(VISION_OPS_TINY, "cpu", "cpu",
                                      reps=1)
    assert sorted(res["failed"]) == ["nms", "roi_align"]
    assert "integer outputs differ" in res["failed"]["nms"]


def test_elastic_train_phase_on_tiny_cpu(tmp_path, monkeypatch):
    """``elastic_train``'s drive on the CPU (gloo, the tiny GPT): the
    straggler stalls life 1 past the deadline, the launcher relaunches
    the worker, life 2 resumes from step 4; the 13 losses are bitwise the
    same step built in this process (one thread, as the worker runs)."""
    from paddle_tpu_torch import build_train_step

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = chip_smoke.drive_elastic_train("tiny", "cpu", str(tmp_path),
                                         batch=8, seq=16, stall=3.0,
                                         deadline=1.0, timeout=240)
    assert res["rc"] == 0 and res["lives"] == 2, res
    assert res["resume_step"] == 4 and res["steps_redone"] == 2
    assert res["redone_life1"] == res["redone_life2"]
    assert res["lost_samples"] == 0
    assert res["detect_s"] >= 1.0 and res["load_s"] > 0
    assert res["program_cache"]["misses"] == 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ts = build_train_step("tiny", batch=8, seq=16, device="cpu")
        losses = [float(ts.train_step(ts.x, ts.y))
                  for _ in range(chip_smoke.ELASTIC_STEPS)]
    finally:
        torch.set_num_threads(threads)
    assert res["losses"] == losses


def test_ring_attention_phase_on_tiny_cpu():
    """``ring_attention``'s drive on the CPU in f32 (K1-K3's plain versions
    a tick): the ring against the whole-sequence call and the plain ring,
    and no kernel launched."""
    res = chip_smoke.drive_ring_attention("cpu", shape=(1, 64, 2, 16),
                                          chunks=4, dtype=torch.float32)
    assert res["ticks"] == 10 and res["launches"] == {}
    for key in ("out_err_whole", "out_err_plain"):
        assert res[key] <= 1e-5, res
    for key in ("grad_rel_err_whole", "grad_rel_err_plain"):
        assert res[key] <= 1e-5, res


def test_auto_parallel_train_phase_on_tiny_cpu():
    """``auto_parallel_train``'s drive on the CPU: the Engine's step on a
    process mesh of one gives the compiled bench step's losses bitwise.
    The mesh's world of one and the global mesh it sets are taken down
    after, so later tests in this process find none."""
    import torch.distributed as dist

    from paddle_tpu_torch import build_train_step
    from paddle_tpu_torch.distributed import mesh

    had_world, saved = dist.is_initialized(), mesh.get_global_mesh()
    try:
        res = chip_smoke.drive_auto_parallel_train("tiny", 2, 16, "cpu",
                                                   steps=4)
    finally:
        mesh.set_global_mesh(saved)
        if not had_world and dist.is_initialized():
            dist.destroy_process_group()
    ts = build_train_step("tiny", batch=2, seq=16, device="cpu")
    assert res["losses"] == [float(ts.train_step(ts.x, ts.y))
                             for _ in range(4)]
    assert res["program_cache"]["misses"] == 1

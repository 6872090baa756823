"""``chip_smoke.py``'s own logic on the CPU: it refuses to run without a
card, its kernel checks (comparison, bound, JSON keys) work at tiny
shapes with the plain versions standing in for the kernels, and its
training phases (7, 8, 10-12), speculative and int8 serving phases
(14-16), LLaMA phases (19-22), remat policies (23) and durability
drills (24) run end to end at tiny widths."""
import numpy as np
import pytest
import torch

import chip_smoke as cs

_KEYS = {"max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
         "bound_by", "library_ms", "shape"}


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(cs, "DEV", torch.device("cpu"))
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=30, warmup=5:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, iters=20, warmup=3:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "cold_ms", lambda fn, iters=20, warmup=3:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return cs.peaks_for("NVIDIA H100 80GB HBM3")


def test_main_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    assert cs.main() != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_peaks_pick_the_part_from_its_name():
    assert cs.peaks_for("NVIDIA H100 80GB HBM3")["hbm"] == 3.35e12
    assert cs.peaks_for("NVIDIA H100 PCIe")["bf16"] == 756e12
    with pytest.raises(RuntimeError):
        cs.peaks_for("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("check,args,kw", [
    ("check_dec", (torch.float32, 4, 2, 64), {}),
    ("check_dec", (torch.float32, 4, 2, 64), {"qlen": 5}),
    ("check_dec", (torch.float32, 4, 2, 64), {"int8": True}),
    ("check_dec", (torch.float32, 4, 4, 64), {"qlen": 5, "int8": True}),
    ("check_seg", (torch.float32, 200, 2, 64), {}),
    ("check_bshd", (torch.float32, 2, 70, 2, 64), {}),
])
def test_kernel_checks_report_every_key(on_cpu, check, args, kw):
    rng = np.random.RandomState(0)
    res = getattr(cs, check)(rng, *args, on_cpu, timed=True, **kw)
    assert _KEYS <= set(res)
    assert check != "check_dec" or res["cold_ms"] == 0.0
    assert res["max_abs_err"] == 0.0     # plain version against itself
    assert res["bound_ms"] > 0 and res["bound_by"] in ("bytes",
                                                       "operations")


@pytest.mark.parametrize("check,args,names", [
    ("check_train", (torch.float32, 2, 70, 2, 64), ("K-PACK", "K-DQ",
                                                    "K-DKV")),
    ("check_seg_train", (torch.float32, 2, 192, 2, 64), ("K-SEG", "K-SDQ",
                                                         "K-SDKV")),
    ("check_bshd_train", (torch.float32, 2, 70, 2, 64), ("K-BSHD", "K-BDQ",
                                                         "K-BDKV")),
])
def test_training_kernel_checks_report_every_key(on_cpu, check, args, names):
    rng = np.random.RandomState(0)
    res = getattr(cs, check)(rng, *args, on_cpu, timed=True)
    assert set(res) == set(names)
    for r in res.values():
        assert _KEYS <= set(r)
        assert r["max_abs_err"] == 0.0   # plain version against itself
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes",
                                                       "operations")


def test_segment_pairs_count_the_visible_mask():
    rng = np.random.RandomState(1)
    seg = cs.segments(rng, 300, 8)
    assert seg[0, -1] == -1 and len(np.unique(seg)) == 9
    s = seg[0]
    mask = (s[:, None] == s[None, :]) & np.tril(np.ones((300, 300), bool))
    assert cs.visible_pairs_seg(seg) == int(mask.sum())
    (_, _, rows, _), eff = cs.packed_rows(0, 3, 256, 32, 300, 1000)
    want = sum(int(((r[:, None] == r[None, :])
                    & np.tril(np.ones((256, 256), bool))).sum())
               for r in rows)
    assert cs.visible_pairs_seg(rows) == want
    assert 0 < eff < 1 and rows.shape == (3, 256)


def test_forward_edge_checks_rehearse_on_cpu(on_cpu):
    """Phase 2's bf16 edge checks of the forward kernels, run here in fp32
    at 2 heads through the plain versions: every case runs and reports."""
    res = cs.check_fwd_edges(torch.float32, heads=2)
    assert res == {"K-PACK": 0.0, "K-BSHD": 0.0, "K-SEG": 0.0}


def test_backward_edge_checks_rehearse_on_cpu(on_cpu):
    """Phase 2's bf16 edge checks of the backward kernels, run here in
    fp32 at 2 heads through the plain versions: every case runs, and each
    of the six kernels reports its worst error."""
    res = cs.check_bwd_edges(torch.float32, heads=2)
    assert res == dict.fromkeys(("K-DQ", "K-DKV", "K-SDQ", "K-SDKV",
                                 "K-BDQ", "K-BDKV"), 0.0)


def test_paged_edge_checks_rehearse_on_cpu(on_cpu):
    """Phase 2's paged edge checks, run here in fp32 through the plain
    versions (unpoisoned: the plain version gathers the whole table):
    every case runs, and each of the four kernels reports its worst
    error."""
    res = cs.check_paged_edges((torch.float32,), poison=False)
    assert res == dict.fromkeys(("K-DEC", "K-DEC8", "K-MQ", "K-MQ8"), 0.0)


def test_paged_edge_cases_cross_the_chunk_edges():
    """The paged edge cases put lengths on both sides of every chunk edge
    (256 tokens at both page sizes), at the whole table and past it;
    windows of 5 and 8 whose rows straddle an edge, and shorter than the
    context; GQA 4 at d 64 and d 128."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    e = cs.PAGED_EDGES
    for ps, maxp in e["tables"]:
        cp, n = pa.split_plan(ps, maxp)
        assert cp * ps == 256 and maxp * ps == 640 and n == 3
    assert {ps for ps, _ in e["tables"]} == {8, 32}
    assert {(nh // kv, d) for nh, kv, d in e["heads"]} == {(1, 64), (4, 64),
                                                           (4, 128)}
    assert {255, 256, 257, 511, 512, 513, 640, 700} <= set(e["lens"][None])
    for qlen in (5, 8):
        lens = e["lens"][qlen]
        assert any(x - qlen < 256 < x for x in lens)     # straddles 256
        assert any(x - qlen < 512 < x for x in lens)     # straddles 512
        assert any(0 < x < qlen for x in lens) and 0 in lens
        assert 700 in lens


def test_backward_edge_cases_hold_the_shapes_named():
    """The backward edge cases cross every tile boundary of the Hopper
    bodies (128-row dQ blocks, 64-key and 64-query tiles) at both head
    dims, full attention with Sq != Sk, and batches of 2 whose last tile
    runs past the end of the first batch."""
    e = cs.BWD_EDGES
    assert [s for s, d in e["causal"] if d == 64] == [1, 17, 63, 65, 127,
                                                      129, 1000]
    assert [s for s, d in e["causal"] if d == 128] == [1, 129]
    assert e["full"] == [(2, 300, 700, 64), (2, 128, 1024, 64),
                         (2, 300, 700, 128)]
    assert e["seg"] == [64, 128]
    assert e["bshd"] == [(2, 129, 16, 64), (2, 129, 8, 128)]


def test_segment_edge_rows_hold_the_cases_they_name():
    t = 1000
    rows = cs.seg_edges(np.random.RandomState(2), t)
    assert rows.shape == (3, t) and rows.dtype == np.int32
    first = rows[0]
    starts = np.flatnonzero(np.diff(first)) + 1
    assert {1, 2, 3} <= set(starts)              # single-token segments
    assert any(p % 128 for p in starts)          # starts inside a tile
    assert (first[int(0.6 * t):] == -1).all()    # the pad tail ...
    assert (first[640:768] == -1).all()          # ... holds whole tiles
    runs = rows[1][np.r_[0, np.flatnonzero(np.diff(rows[1])) + 1]]
    assert (np.diff(runs) < 0).any()             # out of order
    assert (runs == 2).sum() == 2                # an id that comes back
    for a, b in ((1023, -1), (7, 1031)):         # same low 10 bits
        assert a in runs and b in runs and a % 1024 == b % 1024
    assert {2 ** 31 - 1, -2 ** 31} <= set(runs.tolist())
    assert set(rows[2].tolist()) <= set(runs.tolist())
    assert len(np.flatnonzero(np.diff(rows[2]))) > t // 2   # no long runs


def test_build_log_names_each_kernel():
    line = ("ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0"
            "acc9_22_flash_attention_fwd_cu_552e7eaf4sm9021flash_fwd_kernel_"
            "sm90ILi128ELb1EEEv14CUtensorMap_stS2_S2_PKiP13__nv_bfloat16Pfii"
            "ifi' for 'sm_90a'")
    assert cs.kernel_entry(line) == "entry flash_fwd_kernel_sm90<128, true>"
    fp32 = line.replace("4sm9021flash_fwd_kernel_sm90ILi128ELb1E",
                        "16flash_fwd_kernelILi64ELb0E")
    assert cs.kernel_entry(fp32) == "entry flash_fwd_kernel<64, false>"
    typed = "'_ZN12_GLOBAL__N_112paged_kernelI13__nv_bfloat16Li64EEvv'"
    assert cs.kernel_entry(typed).startswith("entry _ZN12")


@pytest.mark.parametrize("kernel,seg,kind", [
    ("flash_dq_kernel_sm90", False, "K-DQ"),
    ("flash_dq_kernel_sm90", True, "K-SDQ"),
    ("flash_dkv_kernel_sm90", False, "K-DKV"),
    ("flash_dkv_kernel_sm90", True, "K-SDKV"),
])
@pytest.mark.parametrize("d", [64, 128])
def test_hopper_backward_kernels_are_named_and_classified(kernel, seg, kind,
                                                          d):
    """Phase 1 names the bf16 backward bodies from ptxas' mangled entry,
    and the profiles classify them from the demangled and the mangled
    name alike, both SEG values."""
    flag = "true" if seg else "false"
    mangled = (f"_ZN55_GLOBAL__N__0f1e2d3c_22_flash_attention_bwd_cu_7a6b5c4d"
               f"4sm90{len(kernel)}{kernel}ILi{d}ELb{int(seg)}EEEv"
               "14CUtensorMap_stS2_S2_S2_PKfS4_PKiP13__nv_bfloat16")
    line = f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'"
    assert cs.kernel_entry(line) == f"entry {kernel}<{d}, {flag}>"
    demangled = (f"void (anonymous namespace)::sm90::{kernel}<{d}, {flag}>"
                 "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, ...)")
    assert cs.kernel_kind(demangled) == kind
    assert cs.kernel_kind(mangled) == kind


@pytest.mark.parametrize("kind", range(4))
@pytest.mark.parametrize("d,rows", [(64, 1), (64, 8), (128, 4)])
def test_paged_kernels_are_named_and_classified(kind, d, rows):
    """Phase 1 names the paged split and merge kernels from ptxas' mangled
    entries, and the profiles class both as one ``paged`` kind, from the
    demangled and the mangled name alike."""
    split = (f"_ZN12_GLOBAL__N_118paged_split_kernelILi{kind}ELi{d}ELi{rows}"
             "EEEvNS_6ParamsE")
    merge = (f"_ZN12_GLOBAL__N_118paged_merge_kernelILi{kind}ELi{d}EEEvPKfPK"
             "iPviiiii")
    for mangled, name, args in ((split, "paged_split_kernel",
                                 f"{kind}, {d}, {rows}"),
                                (merge, "paged_merge_kernel", f"{kind}, {d}")):
        line = (f"ptxas info    : Compiling entry function '{mangled}' for "
                "'sm_90a'")
        assert cs.kernel_entry(line) == f"entry {name}<{args}>"
        assert cs.kernel_kind(mangled) == "paged"
        assert cs.kernel_kind(f"void (anonymous namespace)::{name}<{args}>"
                              "((anonymous namespace)::Params)") == "paged"


def test_profile_skips_user_annotations():
    """A user annotation spans the kernels it launched on the device
    timeline; only the kernels count."""
    from types import SimpleNamespace as NS

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [NS(key="gemm", device_type=cuda, self_device_time_total=3e3),
              NS(key="Optimizer.step#AdamW.step", device_type=cuda,
                 self_device_time_total=5e3, is_user_annotation=True),
              NS(key="aten::mm", device_type=cpu, self_device_time_total=0)]
    prof = NS(key_averages=lambda: events)
    assert cs.device_ms_by_kernel(prof) == {"gemm": 3.0}


@pytest.fixture
def tiny_training(on_cpu, monkeypatch):
    """Phases 7 and 8 at a tiny GPT on the CPU: the trainers' default
    device is the CPU, and each plain attention version counts itself
    as its kernel would, so the launch accounting is exercised."""
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    monkeypatch.setattr(cs, "model_config", lambda: cfg)
    monkeypatch.setattr(cs, "LAYERS", cfg.num_layers)
    monkeypatch.setattr(cs.hybrid, "resolve_device",
                        lambda device=None: torch.device(device or "cpu"))
    for fn in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for mod, name, ref in (
            (fp, "K-PACK", "packed_attention_ref"),
            (fp, "K-DQ", "packed_dq_ref"), (fp, "K-DKV", "packed_dkv_ref"),
            (fp, "K-SEG", "segment_attention_ref"),
            (fp, "K-SDQ", "segment_dq_ref"),
            (fp, "K-SDKV", "segment_dkv_ref"),
            (fa, "K-BSHD", "causal_attention_ref"),
            (fa, "K-BDQ", "bshd_dq_ref"), (fa, "K-BDKV", "bshd_dkv_ref")):
        orig = getattr(mod, ref)

        def counted(*a, _orig=orig, _name=name, _mod=mod, **kw):
            _mod.LAUNCHES[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, ref, counted)
    return on_cpu


def test_training_phases_rehearse_on_cpu(tiny_training):
    counts = {}
    acc = cs.phase_train_accuracy(counts, batch=2, seq=32)
    assert acc["grad_worst_ratio"] == 0.0 and len(acc["steps"]) == 3
    m = cs.phase_train(counts, tiny_training, iters=3, batch=2, seq=64)
    assert m["losses"][-1] < m["losses"][0]
    # remat recomputes each layer's forward: two K-PACK per layer per step
    assert counts["phase8"]["K-PACK"] == 3 * 2 * 2
    assert counts["phase8"]["K-DQ"] == counts["phase8"]["K-DKV"] == 3 * 2
    # grads + 3 steps x 2 layers, on each side (both sides are the CPU)
    assert counts["phase7"]["K-DQ"] == 2 * 4 * 2


def test_packed_training_phases_rehearse_on_cpu(tiny_training):
    counts = {}
    acc = cs.phase_packed_accuracy(counts, batch=2, seq=64,
                                   doc_lengths=(5, 25), seed=3)
    assert acc["grad_worst_ratio"] == 0.0 and len(acc["steps"]) == 3
    assert counts["phase10"]["K-SDQ"] == 2 * 4 * 2
    assert counts["phase10"]["K-PACK"] == counts["phase10"]["K-DQ"] == 0
    m = cs.phase_train(counts, tiny_training, iters=3, batch=2, seq=64,
                       packed=True, doc_lengths=(8, 40))
    assert 0 < m["packing_efficiency"] <= 1
    assert m["real_tokens_per_s"] <= m["tokens_per_s"]
    # remat recomputes each layer's forward: two K-SEG per layer per step
    assert counts["phase11"]["K-SEG"] == 3 * 2 * 2
    assert counts["phase11"]["K-SDQ"] == counts["phase11"]["K-SDKV"] == 6
    assert counts["phase11"]["K-PACK"] == 0


def test_remat_phase_rehearses_on_cpu(tiny_training):
    """Phase 23 at a tiny GPT: every policy's grads equal the CPU's and
    remat=False's, and the plain forward runs once a layer a step under
    ``names:attn_out_kernel,attn_lse``, twice under True and "dots"."""
    counts = {}
    m = cs.phase_remat(counts, tiny_training, acc=(2, 32), speed=(2, 64),
                       steps=2)
    assert set(m["accuracy"]) == {str(p) for p in cs.ACC_POLICIES}
    for r in m["accuracy"].values():
        assert r["grad_worst_ratio"] == 0.0 and r["vs_no_remat_bitwise"]
    assert {k: r["k_pack"] for k, r in m["accuracy"].items()} == {
        "False": 2, "full": 4, "dots": 4, "names:attn_out_kernel,attn_lse": 2}
    speed = m["speed"]
    assert speed["names:attn_out_kernel,attn_lse"]["launches_per_step"] == {
        "K-PACK": 2, "K-DQ": 2, "K-DKV": 2}
    assert speed["names:attn_out_kernel,attn_lse,ffn_in"][
        "launches_per_step"] == {"K-PACK": 2, "K-DQ": 2, "K-DKV": 2}
    for remat in ("True", "dots"):
        assert speed[remat]["launches_per_step"]["K-PACK"] == 4
    assert counts["phase23_names"]["K-PACK"] == 2 * 2
    assert counts["phase23_names_ffn_in"]["K-PACK"] == 2 * 2
    assert counts["phase23_true"]["K-PACK"] == 2 * 4
    assert {"step_ms", "tokens_per_s", "mfu",
            "max_memory_allocated_gb"} <= set(speed["dots"])


def test_durability_phase_rehearses_on_cpu(tiny_training):
    """Phase 24 at a tiny GPT on the CPU: loss scaling against its
    schedule and a clean run, a checkpoint round trip, the preemption
    drill across two worker processes, and the divergence rollback, each
    bitwise."""
    counts = {}
    m = cs.phase_durability(counts, scale_shape=(2, 32), ckpt_shape=(2, 32),
                            drill_shape=(2, 32))
    a = m["loss_scaling"]
    # grown after steps 2 and 5 (two finite in a row), halved at 3
    assert a["scales"] == [2.0 ** 15, 2.0 ** 16, 2.0 ** 15, 2.0 ** 15,
                           2.0 ** 16, 2.0 ** 16]
    assert a["scaler"]["scale"] == 2.0 ** 16
    assert a["scaled_grads"]["scale"] == 2.0 ** 15
    assert a["scaled_grads"]["worst_gap"] == 0.0
    b = m["checkpoint"]
    assert b["resumed_step"] == 3 and b["resumed_losses"] == b["losses"]
    assert b["on_disk"] == ["step-2", "step-3"] and b["bytes"] > 0
    c = m["preemption"]
    assert [r["rc"] for r in c["runs"]] == [118, 0]
    assert c["relaunch"] == {"resumed_at": 3, "global_step": 6}
    assert c["params_bitwise"]
    d = m["rollback"]
    assert d["rolled_back_to"] == 2 and d["params_equal_checkpoint"]
    for key in ("phase24_scale", "phase24_ckpt", "phase24_preempt",
                "phase24_rollback"):
        assert counts[key]["K-PACK"] > 0, key


def test_nn_api_training_phase_rehearses_on_cpu(tiny_training):
    counts = {}
    m = cs.phase_nn_train(counts, tiny_training, steps=2, acc_shape=(2, 32),
                          shape=(2, 64))
    assert m["grad_worst_ratio"] == 0.0 and len(m["losses"]) == 3
    for name in ("K-BSHD", "K-BDQ", "K-BDKV"):
        assert counts["phase12"][name] == 2 * 2


def test_nn_api_profile_phase_rehearses_on_cpu(tiny_training):
    m = cs.phase_nn_profile(steps=1, shape=(2, 32))
    assert m["steps"] == 1 and m["wall_ms_per_step"] > 0
    assert {"device_busy_ms_per_step", "device_idle_share",
            "device_ms_per_step_by_kind"} <= set(m)


def test_profile_kinds_name_the_training_kernels():
    assert cs.kernel_kind("void (anonymous namespace)::flash_dkv_kernel"
                          "<__nv_bfloat16, 64>(...)") == "K-DKV"
    assert cs.kernel_kind("void (anonymous namespace)::flash_dkv_kernel"
                          "<__nv_bfloat16, 64, true>(...)") == "K-SDKV"
    assert cs.kernel_kind("void (anonymous namespace)::flash_dq_kernel"
                          "<float, 128, false>(...)") == "K-DQ"
    assert cs.kernel_kind("void (anonymous namespace)::flash_fwd_kernel"
                          "<__nv_bfloat16, 64, true>(...)") == "K-SEG"
    # the bf16 forward's Hopper body
    assert cs.kernel_kind("void (anonymous namespace)::sm90::flash_fwd_"
                          "kernel_sm90<64, true>(CUtensorMap_st, ...)") == \
        "K-SEG"
    assert cs.kernel_kind("void (anonymous namespace)::sm90::flash_fwd_"
                          "kernel_sm90<128, false>(CUtensorMap_st, ...)") == \
        "K-PACK"
    assert cs.kernel_kind("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT") == \
        "matmul"
    assert cs.kernel_kind("void at::native::reduce_kernel<512, 1>") == \
        "reduction"
    assert cs.kernel_kind("Memcpy DtoH (Device -> Pinned)") == "copy"
    assert cs.kernel_kind("something_else") == "other"


@pytest.fixture
def tiny_serving(tiny_training, monkeypatch):
    """Phases 14-16 at a tiny GPT on the CPU: the paged wrappers count
    themselves as their kernels would, on top of ``tiny_training``."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    for fn, names in (("paged_decode_attention", ("K-DEC", "K-DEC8")),
                      ("paged_multiquery_attention", ("K-MQ", "K-MQ8"))):
        orig = getattr(pa, fn)

        def counted(*a, _orig=orig, _names=names, **kw):
            pa.LAUNCHES[_names[kw.get("scales") is not None]] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(pa, fn, counted)
    return tiny_training


_TINY_SERVING = dict(page_size=8, max_model_len=128, max_batch=4,
                     max_prefill_tokens=256)


def test_spec_and_int8_accuracy_phase_rehearses_on_cpu(tiny_serving):
    counts = {}
    m = cs.phase_spec_accuracy(counts, serving=_TINY_SERVING,
                               trace=(4, 8, 3, 4, 8), decode_steps=3)
    assert m["verify_ticks"] > 0 and m["accepted"] > 0
    assert counts["phase14"]["K-MQ"] == m["verify_ticks"] * 2
    assert m["int8_card_vs_cpu"] == 0.0 and m["int8_vs_fp32_gap"] > 0
    assert counts["phase14_int8"]["K-DEC8"] == 3 * 2
    assert counts["phase14_int8"]["K-MQ8"] == 2


def test_spec_and_int8_load_phases_rehearse_on_cpu(tiny_serving):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(cs.model_config(), device="cpu",
                           dtype=torch.bfloat16).eval()
    counts = {}
    trace = dict(phrase_lens=(4, 8), repeats=(3, 4), out_tokens=(8, 16))
    m = cs.phase_spec_load(model, counts, n_req=8, serving=_TINY_SERVING,
                           trace=trace)
    spec, plain = m["spec"], m["plain"]
    assert spec["verify_ticks"] > 0 and plain["verify_ticks"] == 0
    assert 0 < spec["acceptance_rate"] <= 1
    assert counts["phase15"]["K-MQ"] == spec["verify_ticks"] * 2
    assert counts["phase15_plain"]["K-DEC"] == plain["decode_ticks"] * 2
    assert 0 <= m["identical_streams"] <= 8
    m = cs.phase_int8_load(model, counts, n_req=8, serving=_TINY_SERVING,
                           trace=trace, prompt=(8, 24), new_tokens=(4, 12))
    assert counts["phase16"]["K-DEC8"] == m["plain"]["decode_ticks"] * 2
    assert counts["phase16"]["K-DEC"] == counts["phase16"]["K-MQ8"] == 0
    assert counts["phase16_spec"]["K-MQ8"] == m["spec"]["verify_ticks"] * 2
    # int8 codes are half of bf16's bytes, plus 8 bytes of scales per page
    # and kv head against bf16's 2 * page_size * d * 2 = 1024 (d = 32)
    assert m["pool_bytes_ratio"] == pytest.approx(0.5 + 8 / 1024)


@pytest.fixture
def tiny_llama(tiny_serving, monkeypatch):
    """Phases 19-22 at ``llama_tiny`` widths on the CPU: ``llama_config``
    keeps the depth it is asked for and the GQA group (32 heads over 8 kv
    heads become 4 over 1), on top of ``tiny_serving``."""
    import dataclasses

    from paddle_tpu_torch.models.llama import llama_tiny

    def tiny(num_layers=2, num_kv_heads=None):
        kv = None if num_kv_heads is None else 4 * num_kv_heads // 32
        return dataclasses.replace(llama_tiny(), num_layers=num_layers,
                                   num_kv_heads=kv)

    monkeypatch.setattr(cs, "llama_config", tiny)
    return tiny_serving


def test_llama_serving_accuracy_phase_rehearses_on_cpu(tiny_llama):
    counts = {}
    m = cs.phase_llama_accuracy(counts, serving=_TINY_SERVING, n_req=2,
                                prompt=(10, 30), new_tokens=6, seq=20,
                                decode_steps=3)
    assert set(m) == {"mha", "gqa"}
    assert set(m["gqa"]) == {"no_cache_err", "int8_card_vs_cpu",
                             "int8_card_vs_cpu_own", "fp32_card_vs_cpu",
                             "int8_vs_fp32_gap"}
    assert m["mha"]["no_cache_err"] == m["gqa"]["no_cache_err"] == 0.0
    g = m["gqa"]
    assert g["int8_card_vs_cpu"] == g["int8_card_vs_cpu_own"] == 0.0
    assert g["fp32_card_vs_cpu"] == 0.0 and g["int8_vs_fp32_gap"] > 0
    for name in ("K-SEG", "K-DEC", "K-BSHD", "K-DEC8", "K-MQ", "K-MQ8"):
        assert counts["phase19"][name] > 0, name


@pytest.mark.parametrize("layers", [2, 32])
def test_llama_load_phase_rehearses_on_cpu(tiny_llama, layers):
    """Phase 20's launch formulas hold at its full depth of 32 layers:
    K-DEC = decode ticks x 32, K-SEG = prefill calls x 32, K-BSHD = 32
    for the one prefill_batch."""
    counts = {}
    m = cs.phase_llama_load(counts, layers=layers, n_req=4,
                            serving=_TINY_SERVING, prompt=(8, 16),
                            new_tokens=(2, 5))
    c = counts["phase20"]
    assert c["K-DEC"] == m["decode_ticks"] * layers
    assert c["K-SEG"] == m["prefill_calls"] * layers
    assert c["K-BSHD"] == layers and c["K-MQ"] == 0
    assert {"decode_tokens_per_s", "decode_tick_ms_p50", "decode_tick_ms_p90",
            "ttft_ms_p50", "prefill_tokens_per_s", "weight_bytes",
            "pool_bytes", "max_memory_allocated_gb", "build_s",
            "prefill_batch_vs_packed", "prefill_batch_argmax_agree"} <= set(m)
    assert m["weight_bytes"] > 0 and m["prefill_batch_shape"][0] == 4


def test_llama_training_phases_rehearse_on_cpu(tiny_llama):
    counts = {}
    acc = cs.phase_llama_train_accuracy(counts, batch=1, seq=32)
    assert acc["grad_worst_ratio"] == 0.0 and len(acc["steps"]) == 3
    assert acc["nn_api"]["grad_worst_ratio"] == 0.0
    assert acc["nn_api"]["k_proj_v_proj_worst_ratio"] == 0.0
    assert acc["nn_api"]["launches"]["K-BDKV"] == 2
    # phase 22 at its depth of 8 layers: per step 16 K-PACK (forward and
    # the remat recompute), 8 K-DQ, 8 K-DKV
    m = cs.phase_train(counts, tiny_llama, iters=2, batch=1, seq=32,
                       mcfg=cs.llama_config(num_layers=8), tag="phase22",
                       label="LLaMA")
    assert m["layers"] == 8 and m["losses"][-1] < m["losses"][0]
    assert counts["phase22"]["K-PACK"] == 2 * 16
    assert counts["phase22"]["K-DQ"] == counts["phase22"]["K-DKV"] == 2 * 8
    assert {"step_ms", "tokens_per_s", "mfu", "max_memory_allocated_gb",
            "num_params", "flops_per_token"} <= set(m)


def test_llama_kernel_rows_report_every_key(on_cpu):
    rows = cs.llama_rows(on_cpu, {"dec": (2, (2, 1), 64),
                                  "seg": (200, 2, 64),
                                  "bshd": (2, 70, 2, 64),
                                  "train": (2, 70, 2, 64)})
    assert {k: len(v) for k, v in rows.items()} == {
        "K-DEC": 2, "K-SEG": 1, "K-BSHD": 1, "K-PACK": 1, "K-DQ": 1,
        "K-DKV": 1}
    for name, rs in rows.items():
        for r in rs:
            assert _KEYS <= set(r), name
            # bf16 inputs against the fp32 plain version: the checks' own
            # tolerances (2e-2 paged and forward, 1e-2 training) held
            assert r["bound_ms"] > 0 and r["max_abs_err"] <= 2e-2
    assert cs.LLAMA_ROWS["train"] == (4, 2048, 32, 128)

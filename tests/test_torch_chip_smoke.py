"""``chip_smoke.py``'s own logic on the CPU: it refuses to run without a
card, its kernel checks (comparison, bound, JSON keys) work at tiny
shapes with the plain versions standing in for the kernels, and its
training phases (7, 8, 10-12), speculative and int8 serving phases
(14-16), LLaMA phases (19-22), remat policies (23), durability drills
(24), run telemetry (25), the rest of serving (26), multi-rank
training (27, four gloo rank processes), BERT with varlen attention
(29), launched, durable multi-rank training (30, through the port's
launcher) and the transformer layers with attention dropout and masks
(32) run end to end at tiny widths."""
import numpy as np
import pytest
import torch

import chip_smoke as cs

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

_KEYS = {"max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
         "bound_by", "library_ms", "shape"}


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(cs, "DEV", torch.device("cpu"))
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=30, warmup=5:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, floor_ms, iters=20,
                        warmup=3: (fn(), 0.0)[1])
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


def test_ring_block_rows_rehearse_on_cpu(on_cpu):
    """Phase 2's rows at phase 27's ring blocks: MULTIRANK's rings give
    the full step_hi (L x 2L) and step_lo (2L x L) blocks at d 64 in fp32
    and bf16 and at d 128 in fp32; the rows of a tiny ring run here
    through the plain versions, each kernel of the three reporting."""
    shapes = cs.ring_block_shapes()
    for want in [("float32", 2, 256, 512, 8, 64, False),
                 ("float32", 2, 512, 256, 8, 64, False),
                 ("bfloat16", 2, 256, 512, 8, 64, False),
                 ("bfloat16", 2, 512, 256, 8, 64, False),
                 ("float32", 1, 512, 1024, 32, 128, False),
                 ("float32", 1, 1024, 512, 32, 128, False)]:
        assert want in shapes
    rng = np.random.RandomState(0)
    tiny = cs.ring_block_shapes(_TINY_RANKS)
    assert ("float32", 2, 16, 32, 8, 64, False) in tiny
    for dt, b, sq, sk, nh, d, causal in tiny:
        res = cs.check_train(rng, getattr(torch, dt), b, sq, nh, d, None,
                             timed=False, causal=causal, sk=sk)
        assert set(res) == {"K-PACK", "K-DQ", "K-DKV"}


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


def test_ab_runs_feature_rows_in_each_tree_in_turns(monkeypatch, tmp_path):
    """``--ab``: every tree is built first, then ``feature_rows`` runs in
    each tree in the order given; each run's device ms lands under its
    tree, and each tree's ptxas log is read for its registers."""
    ns, name = "_GLOBAL__N__1a2b3c4d_13_flash_bwd_cu", "flash_dq_kernel_sm90"
    log = tmp_path / "lib.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN"
        f"{len(ns)}{ns}4sm90{len(name)}{name}ILi64ELb0ELb1ELb1EEEvv' for "
        "'sm_90a'\n    0 bytes stack frame, 4 bytes spill stores, 4 bytes "
        "spill loads\nptxas info    : Used 128 registers, used 1 barriers\n")
    built, runs = [], []

    class Build:
        def __init__(self, cmd, cwd, **kw):
            built.append(cwd)
            self.returncode = 0

        def communicate(self):
            return str(tmp_path / "lib.so") + "\n", None

    def run(cmd, cwd, **kw):
        runs.append(cwd)
        rows = {"K-BDQ+bias": {"device_ms": 0.01 * len(runs), "ms": 0.1}}
        return type("R", (), {"returncode": 0, "stderr": "",
                              "stdout": "ROWS " + cs.json.dumps(rows)})()

    monkeypatch.setattr(cs.subprocess, "Popen", Build)
    monkeypatch.setattr(cs.subprocess, "run", run)
    got = cs.ab_feature_rows({"parent": "p", "change": "c"},
                             ["parent", "change", "change", "parent"])
    assert built == ["p", "c"] and runs == ["p", "c", "c", "p"]
    assert got == {"K-BDQ+bias": {"parent": [0.01, 0.04],
                                  "change": [0.02, 0.03]}}
    usage = cs.ptxas_usage(log.read_text())
    assert usage == {"flash_dq_kernel_sm90<64, false, true, true>": {
        "registers": 128, "spill_stores": 4, "spill_loads": 4}}


def test_kernel_entry_takes_the_innermost_name():
    """Digits in nvcc's anonymous-namespace tag that read as a length
    prefix reaching the template arguments do not name the kernel: the
    innermost length-prefixed identifier does (a tag of this form named
    a dK/dV kernel after its tag in a build, and phase 2's SASS check
    counted it as changed)."""
    junk = ("7bdd_29_flash_attention_bwd_dq_ext_cu_f6da1fb14sm9021"
            "flash_dkv_kernel_sm90")
    mangled = (f"_ZN55_GLOBAL__N__9e1c{len(junk)}{junk}ILi64ELb0ELb1ELb0EEEv"
               "14CUtensorMap_stS2_S2_S2_PKfS4_PKiS6_P13__nv_bfloat16")
    assert cs.kernel_entry(mangled) == (
        "entry flash_dkv_kernel_sm90<64, false, true, false>")


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
    # a telemetry span is a record_function range: the profiler marks it
    # a user annotation, so its device-side copy is skipped too
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import observability as obs

    with profile(activities=[ProfilerActivity.CPU]) as real:
        with obs.span("checkpoint_save"):
            torch.ones(3).add_(1)
    (span,) = [e for e in real.key_averages() if e.key == "checkpoint_save"]
    assert span.is_user_annotation
    events.append(NS(key=span.key, device_type=cuda,
                     self_device_time_total=7e3,
                     is_user_annotation=span.is_user_annotation))
    assert cs.device_ms_by_kernel(prof) == {"gemm": 3.0}


def test_device_ms_profiles_again_until_it_caught_half_the_launches(
        monkeypatch):
    """A profile that caught fewer than half its calls' launches, or a
    time per caught launch under the call's bound, is taken again; with
    none good the phase fails."""
    import contextlib
    from types import SimpleNamespace as NS

    import torch.profiler

    cuda = torch.autograd.DeviceType.CUDA
    kern = "void flash_dq_kernel_sm90<64, false>(CUtensorMap)"
    runs = [[], [NS(key=kern, device_type=cuda, count=1,
                    self_device_time_total=30.0)],
            [NS(key=kern, device_type=cuda, count=3,
                self_device_time_total=1.0)],
            [NS(key=kern, device_type=cuda, count=3,
                self_device_time_total=30.0),
             NS(key="Memset (Device)", device_type=cuda, count=3,
                self_device_time_total=3.0)]]
    seen = []

    @contextlib.contextmanager
    def profile(**_):
        events = runs[len(seen)]
        seen.append(events)
        yield NS(key_averages=lambda: events)

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    ms = cs.device_ms(lambda: calls.append(1), 0.005, iters=4, warmup=1)
    # 3 of 4 launches caught: the time is per caught launch
    assert ms == pytest.approx(33.0 / 1e3 / 3) and len(seen) == 4
    assert len(calls) == 1 + 4 * 4
    seen.clear()
    runs[3] = runs[0]
    with pytest.raises(RuntimeError, match="device_ms"):
        cs.device_ms(lambda: None, 0.005, iters=4, warmup=1, tries=4)


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
    monkeypatch.setattr(cs, "CUT_LAYERS", cfg.num_layers)
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


def test_accuracy_phases_take_a_depth(tiny_training):
    """The default run holds phases 7, 10 and 23 (a) at ``ACC_LAYERS`` of
    the model's depth: the phases build the model at the depth asked."""
    counts = {}
    cs.phase_train_accuracy(counts, batch=2, seq=32, layers=1)
    # grads + 3 steps x 1 layer, on each side
    assert counts["phase7"]["K-DQ"] == 2 * 4 * 1
    cs.phase_packed_accuracy(counts, batch=2, seq=64, doc_lengths=(5, 25),
                             seed=3, layers=1)
    assert counts["phase10"]["K-SDQ"] == 2 * 4 * 1
    assert cs._acc_model(None) == cs.model_config()


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


def test_drill_is_bitwise_whatever_the_thread_count(tiny_training):
    """Phase 24 (c)'s training loop ends with the same params bit for bit
    whether its process runs 8 intra-op threads or 2: on the CPU a
    reduction's bits depend on how many threads split it, so
    ``drill_train`` runs on one (and restores the caller's count)."""
    import dataclasses

    from paddle_tpu_torch.utils.tree import flatten

    spec = {"model": dataclasses.asdict(cs.model_config()),
            "device": "cpu", "batch": 2, "seq": 32, "steps": 4,
            "save_every": 2}
    params = {}
    try:
        for threads in (8, 2):
            torch.set_num_threads(threads)
            t, _ = cs.drill_train(spec)
            assert torch.get_num_threads() == threads
            params[threads] = dict(flatten(t.params))
    finally:
        torch.set_num_threads(1)
    assert params[8].keys() == params[2].keys()
    assert all(torch.equal(params[8][k], params[2][k]) for k in params[8])


def test_telemetry_phase_rehearses_on_cpu(tiny_serving):
    """Phase 25 at a tiny GPT on the CPU, its HTTP checks included (the
    CUDA-only ones, device memory and the profile's K-DEC events, are
    left out by the phase itself): 5 accounted steps, the endpoint
    scraped from a thread, the serving counters, TTFT and wedged
    readiness, and the checkpoint metrics."""
    counts = {}
    m = cs.phase_telemetry(
        counts, tiny_serving,
        train=dict(steps=5, batch=2, seq=32, trials=1, trial_steps=1,
                   warmup=1),
        serve=dict(n_req=6, trials=1, ratio_req=3, serving=_TINY_SERVING,
                   trace=dict(prompt=(8, 24), new_tokens=(4, 8)),
                   stall_s=0.5))
    a, b, c = m["training"], m["serving"], m["checkpoint"]
    assert a["records"] == 5 and a["flops_source"] == "analytic_6NT"
    assert a["memory_plan_bytes"] == a["live_state_bytes"]
    assert a["healthz"] == [200, "trainer", 5]
    assert a["obs_instrumentation_overhead_ratio"] > 0
    assert counts["phase25_train"]["K-PACK"] == 5 * 2 * 2
    assert b["counter_deltas"]["serving_requests_total"] == 6
    assert b["ttft_ms_p50_tracer"] == b["ttft_ms_p50_own"]
    assert b["healthz_wedged"] == [503, True] and b["healthz_live"] == 200
    assert b["profile"]["code"] == 200 and b["ticks"] > 0
    assert b["profile"]["decode_ticks_inside"] > 0
    assert counts["phase25_serve"]["K-DEC"] == b["decode_ticks"] * 2
    assert c["deltas"]["checkpoint_saves_total"] == 1 and c["bitwise"]


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


def test_fleet_phase_rehearses_on_cpu(tiny_serving):
    """Phase 26 at a tiny GPT on the CPU, its card-only memory checks
    left out by the phase itself: loadgen's two runs and their launches,
    pool plans at a small capacity, bitwise page copies, the split run
    (fp32, int8, a truncated handoff) held to the fused replica, the
    fleet drill (a killed, b wedged) and the two tenants."""
    from paddle_tpu_torch.models.llama import llama_tiny

    counts = {}
    m = cs.phase_fleet(
        counts, load=dict(n_req=6, serving=_TINY_SERVING,
                          trace=dict(prompt=(8, 24), new_tokens=(4, 8))),
        plans=dict(plans=[("gpt_tiny", cs.model_config()),
                          ("llama_tiny", llama_tiny())],
                   capacity=64 << 20),
        n_disagg=8)
    a, d, e, f = m["loadgen"], m["disagg"], m["drill"], m["tenancy"]
    assert a["continuous"]["completed"] == a["static"]["completed"] == 6
    assert a["static_streams_equal"] == 6      # greedy, the same weights
    assert counts["phase26_static"]["K-BSHD"] == 2 * 2
    assert counts["phase26_cont"]["K-SEG"] > 0
    assert set(m["plans"]) == {"gpt_tiny_bf16", "gpt_tiny_int8",
                               "llama_tiny_bf16", "llama_tiny_int8"}
    assert m["copy"]["bf16_limit_3"]["pages"] == 3
    assert m["copy"]["int8_limit_None"]["stores"] == 3 * 2
    assert d["fp32"]["streams"]["identical"] == 8
    assert d["fp32"]["launches"]["pre"].get("K-DEC", 0) == 0
    assert d["int8"]["launches"]["dec"]["K-DEC8"] > 0
    assert d["partial"]["snapshot"]["re_prefills"] == 1
    assert e["streams"]["identical"] == 8 and e["re_dispatches"] > 0
    assert e["generation_a"] == 1 and e["mem_before_kill"] is None
    assert f["tenants"]["gold"]["preemptions"] == 0
    assert f["tenants"]["batch"]["preemptions"] > 0
    assert f["healthz_tenants"].keys() == {"gold", "batch"}
    assert counts["phase26_fleet"]["K-DEC"] > 0
    assert m["threaded"]["streams"]["identical"] == 4
    assert counts["phase26_threaded"]["K-DEC"] > 0


# phase 27 at tiny widths: each sub-phase's family, layers, layout,
# batch, dtype and steps, as MULTIRANK but sized for the CPU
_TINY_RANKS = {
    "a": ("gpt", 2, dict(mp=2, sep=2), (2, 64), "float32", 3),
    "b": ("gpt", 2, dict(dp=2, sharding=2, zero_stage=3), (4, 64),
          "float32", 3),
    "c": ("llama", 2, dict(sep=2, sharding=2, zero_stage=3), (2, 64),
          "float32", 3),
    "d": ("gpt", 2, dict(mp=2, sep=2), (2, 64), "bfloat16", 4),
    "e": ("gpt", 2, dict(dp=2, mp=2, packed_sequences=True), (4, 64),
          "float32", 3),
    "f": ("gpt", 2, dict(mp=2, sep=2, ring_attention=False), (2, 64),
          "float32", 3),
    "g": ("llama", 2, dict(sep=2, sharding=2, zero_stage=3,
                           ring_attention=False), (2, 64), "float32", 3),
    "h": ("gpt", 2, dict(dp=2, mp=2, packed_sequences=True), (4, 64),
          "bfloat16", 4),
}


def test_multirank_phase_rehearses_on_cpu(tiny_llama):
    """Phase 27 over gloo on the CPU: 4 rank processes (``chip_smoke.py
    --rank-worker``) at gpt_tiny and llama_tiny widths, each sub-phase's
    losses and gathered params against the single-rank trainer, the
    launches every rank makes equal to ``ring_launches`` (the plain
    versions counted as the kernels they stand for), the zigzag ring's
    step_lo and step_hi blocks, live state bytes equal to the plan; (e)
    packed rows over ``dp=2, mp=2`` whose batch shards hold different
    numbers of real labels, (f) and (g) with ``ring_attention=False``
    (the naive ring on contiguous shards), held to (a)'s and (c)'s zigzag
    ring losses too, each rank's launches equal to ``world_launches`` at
    its rank of ``"sep"``, (h) (e) in bf16."""
    counts = {}
    m = cs.phase_multirank(counts, runs=_TINY_RANKS, threads=1)
    assert m["world"] == 4 and all(m["collectives"].values())
    for name in ("a", "b", "c", "e", "f", "g"):
        assert m[name]["loss_gap"] <= 1e-6, name
        assert m[name]["param_gap"] <= 1e-4, name
    assert m["a"]["derived_launches"] == {"K-PACK": 48, "K-DQ": 24,
                                          "K-DKV": 24}
    assert m["b"]["derived_launches"] == {"K-PACK": 12, "K-DQ": 6,
                                          "K-DKV": 6}
    # 4 ranks' launches of (a): 4 x 3 steps x 2 layers x (2 + 2) x 2
    assert counts["phase27_a"]["K-PACK"] == 4 * 48
    assert ["K-PACK", 16, 32, False] in m["a"]["ring_blocks"]
    assert ["K-PACK", 32, 16, False] in m["a"]["ring_blocks"]
    assert m["d"]["losses"][-1] < m["d"]["losses"][0]
    assert m["d"]["step_ms"] > 0
    assert len(set(m["c"]["live_state_bytes"])) == 1
    assert m["f"]["ring_loss_gap"] <= 1e-5 and m["g"]["ring_loss_gap"] <= 1e-5
    assert m["e"]["derived_launches"] == {"K-SEG": 12, "K-SDQ": 6,
                                          "K-SDKV": 6}
    # (f): rank 0 of "sep" one causal block a layer, rank 1 two
    assert m["f"]["derived_launches_by_sep_rank"] == [
        {"K-PACK": 12, "K-DQ": 6, "K-DKV": 6},
        {"K-PACK": 24, "K-DQ": 12, "K-DKV": 12}]
    assert counts["phase27_f"]["K-PACK"] == 2 * 12 + 2 * 24
    assert counts["phase27_e"]["K-SEG"] == 4 * 12
    assert ["K-PACK", 32, 32, False] in m["g"]["ring_blocks"]
    assert len(set(m["e"]["real_labels_per_batch_shard"])) == 2
    assert m["h"]["losses"][-1] < m["h"]["losses"][0]
    assert m["h"]["real_tokens_per_s"] < m["h"]["tokens_per_s"]


# phase 30 at tiny widths: LAUNCH and DESYNC sized for the CPU
_TINY_LAUNCH = dict(cs.LAUNCH, batch=(2, 64))


def test_launch_phase_rehearses_on_cpu(tiny_training):
    """Phase 30 over gloo on the CPU at gpt_tiny, through the port's
    launcher (4 ranks, ``mp=2, sharding=2`` ZeRO 3, async saves every 2
    steps), its three runs started together as on the card: the
    reference run and its guard probe; (ab) a preemption at step 3 and a
    SIGKILL of rank 2 after step 6, each relaunched and resumed bit for
    bit; (c) the desync at 2 ranks exiting 119 at step 4; (d) (ab)'s
    checkpoint on one rank, two steps. Every rank's launches equal
    ``ring_launches`` (the plain versions counted as the kernels)."""
    counts = {}
    m = cs.phase_launch(counts, cfg=_TINY_LAUNCH)
    ab = m["ab"]
    assert ab["rc"] == 0 and ab["generations"] == 3 and ab["params_bitwise"]
    assert ab["steps"][:2] == [[1, 2, 3], [4, 5, 6]]
    assert ab["resumed_at"][0] == [3] * 4
    assert ab["resumed_at"][1] in ([4] * 4, [6] * 4)
    assert all(b > 0 for b in ab["ckpt_bytes_per_rank"])
    assert ab["kill_to_gen2_first_step_s"] > 0
    assert all(len(r) == 6 for r in ab["gen2_startup_s"])
    assert m["c"]["desync"] == [4, 4] and m["c"]["classified"]
    assert m["d"]["resumed_at"] == 6 and m["d"]["rel_gap"] <= 1e-5
    assert len(m["d"]["losses"]) == 2
    for probe in m["reference"]["probe"]:
        assert [len(v) for v in probe["step_ms"].values()] == [2, 2]
        assert probe["spans_a_step"] > 0 and probe["span_us"] > 0
    # the reference: 4 ranks x 9 steps x 2 layers x 2 forwards (remat),
    # the probe's steps apart
    assert counts["phase30_ref"]["K-PACK"] == 4 * 9 * 2 * 2
    assert counts["phase30_d"]["K-DQ"] == 2 * 2


# phase 28 at tiny widths, as PIPELINE but sized for the CPU
_TINY_PIPES = {
    "a": ("gpt", 4, dict(pp=4, micro_batches=8), (8, 64), "float32", 3),
    "b": ("gpt", 4, dict(pp=2, mp=2, pp_schedule="gpipe", micro_batches=4),
          (4, 64), "float32", 3),
    "c": ("gpt", 4, dict(pp=2, vpp=2, dp=2, micro_batches=4, remat=False),
          (8, 64), "float32", 3),
    "d": ("llama", 2, dict(pp=2, sep=2, micro_batches=2), (2, 64),
          "float32", 3),
    "e": ("gpt", 4, dict(pp=4, micro_batches=8, remat=False), (8, 64),
          "bfloat16", 3),
    "e-gpipe": ("gpt", 4, dict(pp=4, micro_batches=8, remat=False,
                               pp_schedule="gpipe"), (8, 64), "bfloat16", 2),
}


def test_pipe_launches_follow_the_schedules():
    """1F1B and interleaved forwards run twice under remat (no graph,
    then the recompute), GPipe's follow the per-layer policy; a zigzag
    ring of 2 runs 4 blocks a layer."""
    assert cs.pipe_launches(8, 4, 1, 8, 1, True, 3) == {
        "K-PACK": 96, "K-DQ": 48, "K-DKV": 48}
    assert cs.pipe_launches(8, 2, 2, 4, 1, False, 3) == {
        "K-PACK": 48, "K-DQ": 48, "K-DKV": 48}
    assert cs.pipe_launches(4, 2, 1, 2, 2, True, 3) == {
        "K-PACK": 96, "K-DQ": 48, "K-DKV": 48}
    assert cs.pipe_launches(8, 2, 1, 4, 1, True, 3, "gpipe") == {
        "K-PACK": 96, "K-DQ": 48, "K-DKV": 48}
    assert cs.pipe_launches(8, 2, 1, 4, 1, "names:attn_out_kernel,attn_lse",
                            3, "gpipe")["K-PACK"] == 48
    assert cs.world_launches(4, dict(mp=2, sep=2), 3) == cs.ring_launches(
        4, 2, 3)


def test_mesh_launches_follow_the_code():
    """Packed rows: one K-SEG, K-SDQ and K-SDKV a layer, the forward
    twice under remat and once where ``names:`` saves it; the naive ring
    (``ring_attention=False``): 1 + r blocks a layer on rank r of
    ``"sep"``, in a pipeline too."""
    packed = dict(dp=2, mp=2, packed_sequences=True)
    assert cs.mesh_launches(2, packed, 3) == {"K-SEG": 12, "K-SDQ": 6,
                                              "K-SDKV": 6}
    assert cs.mesh_launches(
        2, dict(packed, remat="names:attn_out_kernel,attn_lse"), 3) == {
        "K-SEG": 6, "K-SDQ": 6, "K-SDKV": 6}
    naive = dict(sep=4, ring_attention=False)
    assert [cs.world_launches(2, naive, 3, r)["K-DQ"]
            for r in range(4)] == [6, 12, 18, 24]
    assert cs.world_launches(4, dict(naive, sep=2, pp=2), 3, 1) == {
        k: 2 * v for k, v in cs.pipe_launches(4, 2, 1, 4, 1, True,
                                              3).items()}
    assert cs.world_launches(2, dict(sep=2), 3, 1) == cs.ring_launches(
        2, 2, 3)


def test_pipeline_phase_rehearses_on_cpu(tiny_llama):
    """Phase 28 over gloo on the CPU: 4 rank processes at gpt_tiny and
    llama_tiny widths, (a)-(d) against the single-rank trainer (the
    phase's own gates: losses 1e-6, grad norms 1e-4, params 1e-4), every
    rank's launches equal to ``pipe_launches`` (the plain versions
    counted as the kernels), its microbatches in flight to the
    schedule's law, the ring's blocks in (d), the interleaved chunk
    exchange in (c)."""
    counts = {}
    m = cs.phase_multirank(counts, runs=_TINY_PIPES, threads=1, phase=28)
    for name in ("a", "b", "c", "d"):
        assert m[name]["loss_gap"] <= 1e-6, name
        assert m[name]["param_gap"] <= 1e-4, name
    for name, (_, layers, lay, _, _, steps) in _TINY_PIPES.items():
        want = cs.world_launches(layers, lay, steps)
        assert m[name]["launches_per_rank"] == [
            {**r, **want} for r in m[name]["launches_per_rank"]], name
        assert counts[f"phase28_{name}"]["K-DQ"] == 4 * want["K-DQ"]
    assert m["a"]["derived_launches"] == {"K-PACK": 48, "K-DQ": 24,
                                          "K-DKV": 24}
    assert m["a"]["stages"] == [0, 1, 2, 3]
    assert m["a"]["in_flight"] == [4, 3, 2, 1]
    assert m["b"]["in_flight"] == [4, 4, 4, 4]
    assert m["e-gpipe"]["in_flight"] == [8] * 4
    assert min(m["c"]["chunk_bytes_sent"]) > 0
    assert ["K-PACK", 16, 32, False] in m["d"]["ring_blocks"]
    assert m["e"]["ideal_bubble"] == 3 / 11 and m["e"]["step_ms"] > 0
    assert set(m["e"]["stage0_peak_gb"]) == {"1f1b", "gpipe"}


@pytest.fixture
def tiny_bert(on_cpu, monkeypatch):
    """Phase 29 at a tiny BERT on the CPU (hidden 64, 4 heads of 16,
    vocab 512; full depth 2): each full-attention plain version counts
    itself as its kernel would, and fails if it is called causal."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    tiny = dict(hidden_size=64, num_heads=4, vocab_size=512,
                max_position_embeddings=64, num_layers=2)
    monkeypatch.setattr(cs, "bert_config",
                        lambda kind, **kw: BertConfig(**{**tiny, **kw}))
    for fn in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for mod, name, ref in (
            (fp, "K-SEG", "segment_attention_ref"),
            (fp, "K-SDQ", "segment_dq_ref"),
            (fp, "K-SDKV", "segment_dkv_ref"),
            (fa, "K-BSHD", "causal_attention_ref"),
            (fa, "K-BDQ", "bshd_dq_ref"), (fa, "K-BDKV", "bshd_dkv_ref")):
        orig = getattr(mod, ref)

        def counted(*a, _orig=orig, _name=name, _mod=mod, **kw):
            assert not kw.get("causal", True), f"{_name} ran causal"
            _mod.LAUNCHES[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, ref, counted)
    return on_cpu


def test_bert_phase_rehearses_on_cpu(tiny_bert):
    """Phase 29 at tiny widths through the plain versions: (a) the padded
    run on the segmented kernels and the unpadded one on the BSHD ones,
    every launch full attention, (b) the bench step's loss falling, (c)
    one padded bf16-shaped step, (d) varlen attention held to its plain
    version; each sub-phase's launches as derived."""
    counts = {}
    m = cs.phase_bert(counts, tiny_bert, acc_shape=(2, 32), pad_to=12,
                      bench_shape=(4, 16), bench_steps=2,
                      large_shape=(2, 32), large_steps=1,
                      varlen=(3, 40, 56, 2, 16))
    seg3 = ("K-SEG", "K-SDQ", "K-SDKV")
    bshd3 = ("K-BSHD", "K-BDQ", "K-BDKV")

    def want(on, n):
        return {**dict.fromkeys(seg3 + bshd3, 0), **dict.fromkeys(on, n)}

    assert m["a"]["padded"]["launches"] == want(seg3, 2)
    assert m["a"]["unpadded"]["launches"] == want(bshd3, 2)
    for tag in ("padded", "unpadded"):
        assert m["a"][tag]["grad_worst_ratio"] == 0.0
        assert m["a"][tag]["mlm_err"] == 0.0
    assert m["b"]["launches"] == want(bshd3, 2 * 2)
    assert m["b"]["losses"][-1] < m["b"]["losses"][0]
    assert m["b"]["flops_per_token"] == 6 * 110e6 + 12 * 12 * 768 * 16
    assert m["c"]["launches"] == want(seg3, 2)
    assert m["c"]["real_tokens"] == int(cs.bert_key_lengths(2, 32).sum())
    assert m["d"]["launches"] == want(seg3, 1)
    assert m["d"]["max_abs_err"] == 0.0
    # both sides of (a) and (d) count here
    for name in seg3 + bshd3:
        assert counts["phase29"][name] > 0


def test_bert_rows_and_keyside_edges_rehearse_on_cpu(on_cpu):
    """Phase 2's full-attention rows at tiny shapes (every key reported),
    and its key-side edge checks in fp32 at 2 heads: rows that see no key
    on both sides, the padding mask's one-key rows."""
    rows = cs.bert_rows(on_cpu, {"padded": (2, 160, 2, 64),
                                 "varlen": (3, 128, 200, 2, 64),
                                 "bshd": ((2, 70, 2, 64),)})
    assert {k: len(v) for k, v in rows.items()} == {
        "K-SEG": 2, "K-SDQ": 2, "K-SDKV": 2, "K-BSHD": 1, "K-BDQ": 1,
        "K-BDKV": 1}
    for name, rs in rows.items():
        for r in rs:
            assert _KEYS <= set(r), name
            assert r["bound_ms"] > 0 and r["max_abs_err"] <= 1e-2
    assert cs.check_keyside_edges(torch.float32, heads=2) == dict.fromkeys(
        ("K-SEG", "K-SDQ", "K-SDKV"), 0.0)
    q, k = cs.padding_ids([1, 3], 4)
    assert q.tolist() == [[0] * 4] * 2
    assert k.tolist() == [[0, -1, -1, -1], [0, 0, 0, -1]]
    ids = np.array([[3, 3, 1, 7]]), np.array([[1, 3, 3, 3, 9]])
    assert cs.visible_pairs_keys(*ids) == 2 * 3 + 1 * 1
    # queries 3, 3, 1 and keys 1, 3, 3, 3 take part; 7 and 9 do not
    assert cs.visible_tokens(*ids) == (3, 4)


@pytest.fixture
def tiny_transformer(on_cpu, monkeypatch):
    """Phase 32 at tiny widths on the CPU (d_model 32, 2 heads of 16, 6 +
    6 layers; GPT and BERT tiny): each BSHD plain version counts itself
    and its variant as its kernel would."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

    monkeypatch.setattr(cs, "TRANSFORMER_BASE", {
        **cs.TRANSFORMER_BASE, "d_model": 32, "nhead": 2,
        "dim_feedforward": 64})
    monkeypatch.setattr(cs, "TRANSFORMER_VOCAB", 512)
    monkeypatch.setattr(cs, "gpt_345m", lambda: gpt_tiny())
    monkeypatch.setattr(cs, "bert_config", lambda kind, **kw: BertConfig(
        **{**dict(hidden_size=64, num_heads=4, vocab_size=512,
                  max_position_embeddings=64, num_layers=2), **kw}))
    for fn in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for name, ref in (("K-BSHD", "causal_attention_ref"),
                      ("K-BDQ", "bshd_dq_ref"), ("K-BDKV", "bshd_dkv_ref")):
        orig = getattr(fa, ref)

        def counted(*a, _orig=orig, _name=name, **kw):
            fp._count(fa.LAUNCHES, _name, kw.get("bias"),
                      kw.get("dropout_p"))
            return _orig(*a, **kw)

        monkeypatch.setattr(fa, ref, counted)
    return on_cpu


def test_transformer_phase_rehearses_on_cpu(tiny_transformer):
    """Phase 32 at tiny widths through the plain versions: (a) card and
    CPU sides the same to the bit, every call with a mask and dropout, (b)
    18 calls of each kernel a step at full depth, the loss falling, (c)
    GPT at its default dropouts and BERT's empty row on the bias path."""
    counts = {}
    m = cs.phase_transformer(counts, acc_shape=(2, 12, 10),
                             train_shape=(4, 16), steps=3,
                             gpt_shape=(2, 16), bert_shape=(2, 16))
    assert m["a"]["out_err"] == 0.0 and m["a"]["grad_worst_ratio"] == 0.0
    assert m["a"]["variants"] == {f"{k}+bias+drop": 3 for k in cs.BSHD3}
    assert m["b"]["launches"] == dict.fromkeys(cs.BSHD3, 18 * 3)
    assert m["b"]["losses"][-1] < m["b"]["losses"][0]
    assert m["b"]["real_tokens"] > 0
    assert m["c"]["gpt"]["variants"] == {f"{k}+drop": 2 * 3
                                         for k in cs.BSHD3}
    assert m["c"]["bert"]["variants"] == {f"{k}+bias": 2 for k in cs.BSHD3}
    assert m["c"]["bert"]["grad_worst_ratio"] == 0.0
    for name in cs.BSHD3:
        assert counts["phase32"][f"{name}+bias+drop"] > 0


def test_worst_grad_holds_rounding_leaves_to_the_largest_grad():
    """A leaf whose CPU grad is at rounding level (true grad 0) is held
    to the largest grad of any leaf, with ``rounding``; the other
    leaves, and every leaf without it, to their own largest."""
    cpu = {"w": torch.tensor([1.0, -2.0]), "b": torch.tensor([1e-7, 0.0])}
    card = {"w": torch.tensor([1.0, -2.0 + 2e-5]),
            "b": torch.tensor([-1e-7, 1e-7])}
    assert cs.worst_grad(card, cpu) == (2.0, "b")
    ratio, leaf = cs.worst_grad(card, cpu, rounding=1e-5)
    assert leaf == "w" and ratio == pytest.approx(1e-5, rel=1e-2)
    card["b"] = torch.tensor([1e-3, 0.0])      # far above rounding: caught
    assert cs.worst_grad(card, cpu, rounding=1e-5)[1] == "b"


def test_feature_checks_rehearse_on_cpu(on_cpu):
    """Phase 2's DROP and BIAS rows at tiny shapes (every key reported,
    the kernels' causal flag with dropout among them), with the keep
    bits' checks, and the causal mask's end-aligned -inf entries."""
    rows = cs.feature_rows(on_cpu, {"bshd": (2, 40, 2, 64),
                                    "gpt": (2, 36, 2, 64),
                                    "seg": (2, 48, 2, 64)})
    assert set(rows) == set(cs.VARIANTS)
    for name, r in rows.items():
        assert _KEYS <= set(r), name
        assert r["bound_ms"] > 0 and r["max_abs_err"] <= 1e-2
    mask = cs.feature_bias(np.random.RandomState(0), "causal", 1, 1, 3, 5,
                           torch.device("cpu"))
    assert torch.equal(torch.isinf(mask), torch.tensor(
        [[0, 0, 0, 1, 1], [0, 0, 0, 0, 1], [0, 0, 0, 0, 0]], dtype=bool))


def _sass_listing(tag, drop_body):
    """A ``cuobjdump -sass`` listing of three flash kernels and a paged
    one, each under nvcc's per-file anonymous namespace ``tag``."""
    def fn(name, args, body):
        ns = f"_GLOBAL__N__{tag}_13_flash_fwd_cu"
        mangled = f"_ZN{len(ns)}{ns}{len(name)}{name}I{args}EEvv"
        lines = [f"\t\tFunction : {mangled}",
                 "\t.headerflags\t@\"EF_CUDA_SM90\""]
        for n, ins in enumerate(body):
            lines += [f"        /*{16 * n:04x}*/    {ins} ;"
                      f"    /* 0x{n:016x} */",
                      f"                          /* 0x{tag}00000000 */"]
        return lines
    out = ["Fatbin elf code:", "arch = sm_90a", "\tcode for sm_90a"]
    out += fn("flash_fwd_kernel_sm90", "Li64ELb0ELb0ELb0E",
              ["LDC R1, c[0x0][0x28]", "EXIT"])
    out += fn("flash_fwd_kernel_sm90", "Li64ELb0ELb1ELb0E",
              ["LDC R1, c[0x0][0x28]", *drop_body, "EXIT"])
    out += fn("flash_dkv_kernel_sm90", "Li64ELb1ELb0ELb1E",
              ["HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ", "EXIT"])
    out += fn("paged_split_kernel", "Li1ELi64ELi16E", ["BRA 0x40", "EXIT"])
    return "\n".join(out)


def test_sass_check_counts_kernels_by_drop(monkeypatch, tmp_path):
    """``sass_digests`` keys each kernel by its template arguments and
    hashes its instructions alone (addresses, encodings and the
    anonymous-namespace tag cut out); ``check_sass`` counts the kernels
    with neither DROP nor BIAS that equal the reference and the DROP or
    BIAS ones that moved (here the DROP forward; the BIAS dK/dV kept its
    body)."""
    listings = {"ref": _sass_listing("1a2b3c4d", ["IMAD.HI.U32 R2, R3"]),
                "new": _sass_listing("99887766", ["IMAD.HI.U32 R2, R4"])}
    monkeypatch.setattr(cs._build, "cuda_tool", lambda name="nvcc": name)
    monkeypatch.setattr(cs.subprocess, "run", lambda cmd, **kw: type(
        "R", (), {"stdout": listings[cmd[-1]]})())
    ref = cs.sass_digests("ref")
    assert sorted(ref) == [
        "flash_dkv_kernel_sm90<64, true, false, true>",
        "flash_fwd_kernel_sm90<64, false, false, false>",
        "flash_fwd_kernel_sm90<64, false, true, false>",
        "paged_split_kernel<1, 64, 16>"]
    path = tmp_path / "sass_reference.json"
    path.write_text(cs.json.dumps({"source": "ref", "nvcc": "v",
                                   "kernels": ref}))
    monkeypatch.setattr(cs, "SASS_REFERENCE", path)
    monkeypatch.setattr(cs, "nvcc_version", lambda: "v")
    res = cs.check_sass(cs.sass_digests("new"))
    assert (res["plain"], res["plain_equal"], res["feature"],
            res["feature_changed"], res["plain_differ"]) == (2, 2, 2, 1, [])
    assert res["feature_same"] == [
        "flash_dkv_kernel_sm90<64, true, false, true>"]

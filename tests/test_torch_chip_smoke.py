"""``chip_smoke.py``'s own logic on the CPU: it refuses to run without a
card, and its kernel checks (comparison, bound, JSON keys) work at tiny
shapes with the plain versions standing in for the kernels."""
import numpy as np
import pytest
import torch

import chip_smoke as cs

_KEYS = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
         "library_ms", "shape"}


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(cs, "DEV", torch.device("cpu"))
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=30, warmup=5:
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


@pytest.mark.parametrize("check,args", [
    ("check_dec", (torch.float32, 4, 2, 64)),
    ("check_seg", (torch.float32, 200, 2, 64)),
    ("check_bshd", (torch.float32, 2, 70, 2, 64)),
])
def test_kernel_checks_report_every_key(on_cpu, check, args):
    rng = np.random.RandomState(0)
    res = getattr(cs, check)(rng, *args, on_cpu, timed=True)
    assert _KEYS <= set(res)
    assert res["max_abs_err"] == 0.0     # plain version against itself
    assert res["bound_ms"] > 0 and res["bound_by"] in ("bytes",
                                                       "operations")


def test_segment_pairs_count_the_visible_mask():
    rng = np.random.RandomState(1)
    seg = cs.segments(rng, 300, 8)
    assert seg[0, -1] == -1 and len(np.unique(seg)) == 9
    s = seg[0]
    mask = (s[:, None] == s[None, :]) & np.tril(np.ones((300, 300), bool))
    assert cs.visible_pairs_seg(seg) == int(mask.sum())

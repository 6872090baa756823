"""The port's run-telemetry modules (``paddle_tpu_torch.observability``)
against the JAX package's, on the same inputs: the metrics registry's
Prometheus text, the JSONL sink's records, step accounting, the SLO
plane with a full burn-rate alert cycle, the serving tracer, and the
memory plan. Everything is exact; the clocks (wall, perf counter, the
SLO plane's) are injected, never read."""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu import observability as J
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.observability import tracing as Jtracing
from paddle_tpu_torch import observability as T
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.observability import tracing as Ttracing

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)


class Clock:
    """An injected clock: ``time()``, ``perf_counter()`` and a call all
    read ``t``."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def time(self):
        return self.t

    def perf_counter(self):
        return self.t


@pytest.fixture
def fresh(tmp_path):
    """Both packages' global registries emptied and their sinks pointed
    at ``tmp_path/jax`` and ``tmp_path/torch``; both restored after."""
    for pkg in (J, T):
        pkg.registry().reset()
    J.configure(str(tmp_path / "jax"), worker="w")
    T.configure(str(tmp_path / "torch"), worker="w")
    yield tmp_path
    for pkg in (J, T):
        pkg.configure("")
        pkg.configure(None)
        pkg.registry().reset()


def records(tmp_path, pkg, drop=("ts",)):
    (J if pkg == "jax" else T).sink.flush()
    with open(tmp_path / pkg / "metrics-w.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop}
                for line in f]


def drive_registry(reg):
    rng = np.random.RandomState(0)
    reg.counter("bytes_total", direction="save").inc(123)
    reg.counter("bytes_total", direction="load").inc(7.5)
    reg.counter("calls_total").inc()
    reg.gauge("tokens_per_sec", trainer="0").set(1234.5)
    reg.gauge("in_flight", root='/tmp/a"b\\c').add(2)
    h = reg.histogram("step_time_ms", reservoir_size=16, trainer="0")
    for v in rng.exponential(10.0, 200):     # past the reservoir: LCG
        h.observe(float(v))
    reg.histogram("empty_ms")
    reg.counter("9bad-name").inc(3)
    return reg


def test_prometheus_text_is_byte_identical():
    """The same operations on both registries (labels with quotes and
    backslashes, a histogram past its reservoir, an unnamed histogram, a
    name that needs sanitising) render the same text, byte for byte."""
    j = drive_registry(J.MetricsRegistry())
    t = drive_registry(T.MetricsRegistry())
    assert t.to_prometheus().encode() == j.to_prometheus().encode()
    assert t.snapshot() == j.snapshot()
    assert t.total("bytes_total") == j.total("bytes_total") == 130.5
    assert T.nearest_rank([5.0, 1.0, 9.0, 3.0], 0.5) == \
        J.nearest_rank([5.0, 1.0, 9.0, 3.0], 0.5)


def test_sink_and_step_accounting_match_jax(fresh):
    """Step accounting fed the same durations and tokens gives the same
    records, summary and JSONL lines (``ts`` aside); a span and a
    metrics snapshot land in the stream as the JAX package's do."""
    accts = {"jax": J.StepAccounting(trainer="0"),
             "torch": T.StepAccounting(trainer="0")}
    out = {}
    for name, acct in accts.items():
        acct._peak = 1e15        # one peak for both: MFU compares
        acct.set_flops(6.0e9, "analytic_6NT")
        recs = [acct.on_step(d, tokens=256, memory=m)
                for d, m in ((0.5, None), (0.125, {"bytes_in_use": 10}),
                             (0.25, None), (0.0625, None))]
        out[name] = (recs, acct.summary())
    assert out["torch"] == out["jax"]
    for pkg in (J, T):
        pkg.emit({"kind": "event", "name": "relaunch", "attempt": 2})
        pkg.flush_metrics(step=4)
    j, t = records(fresh, "jax"), records(fresh, "torch")
    assert [r["kind"] for r in t] == ["step"] * 4 + ["event", "snapshot"]
    assert t == j


def test_span_feeds_histogram_and_stream(fresh):
    """A span's JSONL record has the JAX keys and its ``<name>_ms``
    histogram counts it; it opens a ``torch.profiler`` range."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.span("checkpoint_save", event_type="PythonUserDefined",
                    shard="0"):
            pass
    with J.span("checkpoint_save", event_type="PythonUserDefined",
                shard="0"):
        pass
    drop = ("ts", "t0_us", "dur_ms")
    assert records(fresh, "torch", drop) == records(fresh, "jax", drop)
    assert T.registry().histogram("checkpoint_save_ms", shard="0").count == 1
    assert "checkpoint_save" in {e.name for e in prof.events()}


def _tick_slo(**kw):
    base = dict(name="tick_p50_50ms", sli="tick_ms", objective=0.5,
                threshold_ms=50.0, fast_window_s=10.0, slow_window_s=30.0,
                fire_burn_rate=1.0, resolve_burn_rate=0.5, min_events=1)
    base.update(kw)
    return base


def _slo_trackers():
    """A port and a JAX tracker on one injected clock, over the shipped
    DEFAULT_SLOS plus a short-window tick SLO that completes a cycle."""
    clk = Clock(100.0)
    return clk, {
        "jax": J.SLOTracker(configs=list(J.DEFAULT_SLOS)
                            + [J.SLOConfig(**_tick_slo())], clock=clk),
        "torch": T.SLOTracker(configs=list(T.DEFAULT_SLOS)
                              + [T.SLOConfig(**_tick_slo())], clock=clk)}


def test_slo_plane_matches_jax_through_an_alert_cycle(fresh):
    """The same events on the same clock: the alert fires and resolves at
    the same ticks, and the snapshots, the rendered dashboards and the
    ``slo_alert`` JSONL events are equal."""
    clk, trk = _slo_trackers()
    states = {k: [] for k in trk}
    rng = np.random.RandomState(3)
    for phase, (tick_ms, secs) in enumerate(((5.0, 24), (200.0, 31),
                                             (5.0, 31))):
        for _ in range(secs):
            ttft = float(rng.exponential(300.0))
            itl = [float(x) for x in rng.exponential(20.0, 4)]
            for k, t in trk.items():
                t.observe_tick(tick_ms)
                t.observe_ttft(ttft)
                t.observe_queue_wait(ttft / 3)
                t.observe_itl_many(itl)
                t.on_request_done("finished" if phase != 1 else "timeout",
                                  tokens=10, good_tokens=10 * (phase != 1))
                if phase == 1:
                    t.on_shed()
                states[k] += [e["state"] for e in t.maybe_evaluate()]
            clk.t += 1.0
    assert states["torch"] == states["jax"]
    assert "firing" in states["torch"] and "resolved" in states["torch"]
    snap = trk["torch"].snapshot()
    assert snap == trk["jax"].snapshot()
    assert T.render_dashboard(snap, {"role": "serving", "tick": 3}) == \
        J.render_dashboard(trk["jax"].snapshot(), {"role": "serving",
                                                   "tick": 3})
    assert T.render_dashboard(None, None) == J.render_dashboard(None, None)
    assert records(fresh, "torch") == records(fresh, "jax")


def test_windowed_rings_match_jax():
    """500 observations across many ring buckets: equal window folds
    (reservoir replacement included) and sparkline series."""
    rings = {mod: (mod.WindowedHistogram("ttft_ms"),
                   mod.WindowedCounter("shed")) for mod in (J, T)}
    values = np.random.RandomState(5).exponential(50.0, 500)
    for i, v in enumerate(values):
        for h, c in rings.values():
            h.observe(3.0 + 0.37 * i, float(v))
            c.inc(3.0 + 0.37 * i, n=1, v=float(v))
    now = 3.0 + 0.37 * 500
    (jh, jc), (th, tc) = rings[J], rings[T]
    assert th.windows(now) == jh.windows(now)
    assert tc.windows(now) == jc.windows(now)
    assert th.series(now) == jh.series(now)


def _drive_tracer(mod, clk):
    tr = mod.ServingTracer()
    slo = mod.SLOTracker(clock=clk)
    tr.slo = slo
    for rid, (prompt, new) in enumerate(((9, 5), (17, 3), (4, 8))):
        tr.on_submit(rid, prompt, new)
        clk.t += 0.001
    for tick in range(9):
        tr.begin_tick()
        clk.t += 0.0002
        tr.acc("admit_ms", 0.2)
        if tick in (0, 4):
            rids = [0, 1] if tick == 0 else [2]
            tr.on_prefill(rids, clk.t * 1e6, 3.5)
            clk.t += 0.0035
        tr.acc("evict_ms", 0.05)
        if tick == 3:
            tr.on_evict(2)
        if tick >= 1:
            tr.on_decode_tick([0, 1, 2], clk.t * 1e6, 7.25,
                              tokens=3 if tick % 2 else None,
                              spec_proposed=tick, spec_accepted=tick // 2)
            clk.t += 0.00725
        if tick == 3:
            tr.on_finish(1, latency_ms=40.0, ttft_ms=5.0, tokens=3)
        if tick == 8:
            tr.on_finish(0, latency_ms=80.0, ttft_ms=5.0, tokens=5,
                         spec_proposed=4, spec_accepted=2)
        tr.end_tick(running=2, waiting=1, pages_in_use=5, pages_total=17,
                    max_batch=4)
    return tr.snapshot(), slo.snapshot()


def test_tracer_matches_jax(fresh, monkeypatch):
    """The same request and tick events on an injected clock: equal
    ``snapshot()`` documents (in flight, preempted, finished with ITL
    percentiles), equal tick records and request traces in the stream,
    and the same ITL gaps fed to the SLO plane."""
    out = {}
    for name, mod, tmod in (("jax", J, Jtracing), ("torch", T, Ttracing)):
        clk = Clock(1000.0)
        monkeypatch.setattr(tmod, "time", clk)
        out[name] = _drive_tracer(mod, clk)
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["finished_recent"][0]["itl_ms_p50"] > 0
    assert records(fresh, "torch") == records(fresh, "jax")


def _tiny_configs():
    return [(JG.gpt_tiny(), TG.gpt_tiny()),
            (JL.llama_tiny(), TL.llama_tiny())]


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_state_memory_plan_matches_jax(arch):
    """``plan_state_memory`` on the ``meta`` device gives the JAX
    package's ``eval_shape`` bytes, GPT and LLaMA, on one device and at a
    mesh axis above 1 (``tests/test_torch_hybrid.py`` holds every
    trainer layout)."""
    jcfg, tcfg = _tiny_configs()[arch == "llama"]
    want = J.plan_state_memory(jcfg)
    got = T.plan_state_memory(tcfg)
    assert got == want and got["arch"] == arch
    assert (T.plan_state_memory(tcfg, axis_sizes={"model": 2})
            == J.plan_state_memory(jcfg, axis_sizes={"model": 2}))


def test_oom_risk_and_capacity_override_match_jax(monkeypatch):
    for args in ((10, 5, 100), (80, 15, 100, 0.9), (1, 0, None),
                 (50, None, 60, 0.5), (0, 0, 0)):
        assert T.oom_risk(*args) == J.oom_risk(*args)
    import jax

    cpu = jax.devices("cpu")[0]
    assert T.hbm_bytes("cpu") is None and J.hbm_bytes(cpu) is None
    assert T.hw.hbm_bytes("NVIDIA H100 80GB HBM3") == 80 << 30
    for env in ("123456789", "1.5e9"):
        monkeypatch.setenv("PADDLE_HBM_BYTES_PER_CHIP", env)
        assert T.hbm_bytes("cpu") == J.hbm_bytes(cpu) == int(float(env))
    monkeypatch.setenv("PADDLE_HBM_BYTES_PER_CHIP", "lots")
    assert T.hbm_bytes("cpu") is None and J.hbm_bytes(cpu) is None
    assert T.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert T.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert T.device_memory_stats("cpu") is None
    assert T.all_devices_memory_stats(["cpu"]) is None


def test_state_breakdown_specs_match_jax():
    """Per-device bytes under partition specs: the JAX package's
    ceil-division per sharded dim, on the same shapes."""
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import PartitionSpec as P

    shapes = {"a": (7, 64), "b": (5,), "c": (3, 3, 10)}
    specs = {"a": ("data", None), "b": None, "c": (None, "model", "sep")}
    axes = {"data": 2, "model": 2, "sep": 4}
    tree_t = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    tree_j = {k: jax.ShapeDtypeStruct(s, jnp.float32)
              for k, s in shapes.items()}
    specs_j = {k: (P(*v) if v is not None else P())
               for k, v in specs.items()}
    assert T.state_breakdown(tree_t, specs, axes) == \
        J.state_breakdown(tree_j, specs_j, axes)
    assert T.state_breakdown(tree_t) == J.state_breakdown(tree_j)


def test_obs_report_reads_the_port_stream(fresh):
    """``tools/obs_report.py`` (stdlib only) reads the port's JSONL
    stream unchanged and reports its steps."""
    import subprocess
    import sys

    acct = T.StepAccounting(trainer="0")
    acct.set_flops(1e9, "analytic_6NT")
    for d in (0.5, 0.1, 0.1):
        acct.on_step(d, tokens=128)
    T.flush_metrics(step=3)
    T.sink.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, os.path.join(root, "tools",
                                                     "obs_report.py"),
                        str(fresh / "torch"), "--json"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    worker = json.loads(p.stdout)["summary"]["workers"]["w"]
    assert worker["steps"] == 3 and worker["mfu"] > 0

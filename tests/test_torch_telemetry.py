"""Run telemetry wired into the port's trainer, scheduler and checkpoint
manager, held against the JAX package's on the CPU: the trainer's
``telemetry_summary()`` and guard metrics after three steps of a tiny
GPT, its ``/healthz`` and ``/metrics`` over a real socket; the
scheduler's ``serving_*`` metrics, tracer documents and SLO windows for
the same six requests (shared weights, an injected clock, a pool small
enough to evict), its ops endpoint and the wedged-loop readiness flip;
and the checkpoint metrics of one save and one load of the same state.
Counts, bytes, FLOPs and token numbers are exact; durations come from
the host clock and are compared by count only, except where the
injected clock sets them (TTFT, queue wait)."""
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as J
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.models import gpt as JM
from paddle_tpu.parallel import hybrid as jhybrid
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu.serving.scheduler import ContinuousBatchingScheduler as JSched
from paddle_tpu.serving.scheduler import Request as JRequest
from paddle_tpu_torch import observability as T
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler, Request,
                                      ServingConfig, ServingEngine)
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)


def _get(url):
    """``(status, body)`` of a GET; an HTTP error is a reply too."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _counters(reg, prefix):
    """Every counter of ``reg`` named ``prefix*``, summed over labels."""
    names = {m["name"] for m in reg.snapshot()
             if m["kind"] == "counter" and m["name"].startswith(prefix)}
    return {n: reg.total(n) for n in names}


def _moved(before, after):
    """The counters that moved between two ``_counters`` readings."""
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def _hist_counts(reg, names):
    return {n: reg.histogram(n).count for n in names}


class VClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- the trainer -------------------------------------------------------------

B, S = 2, 64


@pytest.fixture(scope="module")
def trainers():
    """Three steps of a tiny GPT trainer in each package, telemetry on,
    no sink (so the JAX trainer also takes the analytic 6NT FLOPs), a
    NaN at step 2 for the guard's metrics; the port's with
    ``http_port=0``. Yields both trainers and each registry's deltas."""
    base = dict(compute_dtype=jnp.float32, learning_rate=1e-3,
                warmup_steps=2)
    jt = jhybrid.HybridParallelTrainer(
        JM.gpt_tiny(), jhybrid.TrainerConfig(**base),
        devices=jax.devices()[:1])
    base["compute_dtype"] = torch.float32
    tt = thybrid.HybridParallelTrainer(
        TM.gpt_tiny(), thybrid.TrainerConfig(http_port=0, **base),
        device="cpu")
    rng = np.random.RandomState(3)
    tok = rng.randint(0, TM.gpt_tiny().vocab_size, (B, S)).astype(np.int32)
    lab = rng.randint(0, TM.gpt_tiny().vocab_size, (B, S)).astype(np.int32)
    old = os.environ.get("PADDLE_FI_NAN_AT_STEP")
    os.environ["PADDLE_FI_NAN_AT_STEP"] = "2"
    for mod in (J, T):
        mod.configure("")        # no sink: the JAX FLOPs stay analytic
    deltas = {}
    try:
        for name, t, reg in (("jax", jt, J.registry()),
                             ("torch", tt, T.registry())):
            before = _counters(reg, "train_")
            for _ in range(3):
                t.step(tok, lab)
            t.anomaly_state()
            deltas[name] = (_moved(before, _counters(reg, "train_")),
                            reg.gauge("loss_scale").value)
    finally:
        if old is None:
            os.environ.pop("PADDLE_FI_NAN_AT_STEP")
        else:
            os.environ["PADDLE_FI_NAN_AT_STEP"] = old
        for mod in (J, T):
            mod.configure(None)
    yield jt, tt, deltas
    tt.http.stop()


def test_telemetry_summary_matches_jax(trainers):
    """Same keys (the JAX package's compile-ledger roll-up aside), steps,
    tokens, 6NT FLOPs, step-time count and memory plan (the state's
    bytes leaf for leaf; no executable plan and no capacity on the
    CPU)."""
    jt, tt, _ = trainers
    js, ts = jt.telemetry_summary(), tt.telemetry_summary()
    assert set(ts) == set(js) - {"compile_ledger"}
    assert ts["steps"] == js["steps"] == 3
    assert ts["flops_source"] == js["flops_source"] == "analytic_6NT"
    assert ts["flops_per_step"] == js["flops_per_step"] == \
        6.0 * tt.num_params() * B * S
    assert ts["step_time_ms"]["count"] == js["step_time_ms"]["count"] == 2
    assert ts["memory_plan"] == js["memory_plan"]
    assert ts["memory_plan"]["executable"] is None
    assert ts["device_memory"] is js["device_memory"] is None
    for side in (jt, tt):
        assert side.telemetry.last_record["step"] == 3
        assert [n for _, n in side.telemetry._recent] == [B * S] * 2
    assert tt.memory_plan(compute_executable=True)["executable"] is None


def test_guard_metrics_match_jax(trainers):
    """A NaN at step 2: one skipped step counted, the loss-scale gauge
    set, in both packages."""
    _, _, deltas = trainers
    assert deltas["torch"] == deltas["jax"]
    assert deltas["torch"][0] == {"train_steps_skipped_total": 1.0}
    assert deltas["torch"][1] == 1.0


def test_trainer_endpoint_answers_over_a_socket(trainers):
    jt, tt, _ = trainers
    assert tt.http.url.startswith("http://127.0.0.1:")
    code, body = _get(tt.http.url + "/healthz")
    doc = json.loads(body)
    assert code == 200 and doc["role"] == "trainer" and doc["step"] == 3
    assert set(doc) <= set(jt._health_snapshot()) | {"status", "uptime_s",
                                                     "pid"}
    assert doc["anomaly"] == jt.anomaly_state()
    code, text = _get(tt.http.url + "/metrics")
    label = tt.telemetry.trainer
    assert code == 200
    for name in ("step_time_ms", "tokens_per_sec", "mfu"):
        assert f'{name}{{trainer="{label}"' in text
    assert "train_steps_skipped_total" in text
    code, body = _get(tt.http.url + "/debug/requests")
    assert code == 404     # a trainer has no request tracer
    code, body = _get(tt.http.url + "/debug/compiles")
    assert code == 501 and "A.7" in json.loads(body)["error"]


# -- the scheduler -----------------------------------------------------------

_CFG = dict(page_size=8, max_model_len=64, max_batch=8,
            max_prefill_tokens=128)
_SERVING_HISTS = ("serving_decode_step_ms", "serving_tick_ms",
                  "serving_ttft_ms", "serving_request_latency_ms")


@pytest.fixture(scope="module")
def served():
    """The same six requests through both schedulers, shared weights, a
    14-page pool (evictions), each with a tracer, an SLO tracker and an
    injected clock that moves 50 ms a tick. Yields per package the
    scheduler, its counter deltas, histogram count deltas, tracer
    documents and SLO snapshot."""
    paddle.seed(0)
    jm = JM.GPTForCausalLM(JM.gpt_tiny(hidden_dropout=0.0,
                                       attention_dropout=0.0))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TM.gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    tm = TM.GPTForCausalLM(cfg, device="cpu").eval()
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    rng = np.random.RandomState(1)
    protos = [(rng.randint(0, cfg.vocab_size, rng.randint(8, 24))
               .astype(np.int32), int(rng.randint(6, 18))) for _ in range(6)]
    out = {}
    for name, mod, eng, sched_cls, req_cls in (
            ("jax", J, JEngine(jm, JConfig(**_CFG, num_pages=14)), JSched,
             JRequest),
            ("torch", T, ServingEngine(tm, ServingConfig(**_CFG,
                                                         num_pages=14)),
             ContinuousBatchingScheduler, Request)):
        reg = mod.registry()
        before = _counters(reg, "serving_")
        hbefore = _hist_counts(reg, _SERVING_HISTS)
        clk = VClock(100.0)
        sched = sched_cls(eng, clock=clk, tracer=mod.ServingTracer(),
                          slo=mod.SLOTracker(clock=clk))
        for i, (p, n) in enumerate(protos):
            sched.submit(req_cls(rid=i, prompt=p, max_new_tokens=n))
        while sched.has_work:
            sched.step()
            clk.t += 0.05
        counters = _moved(before, _counters(reg, "serving_"))
        hists = {k: v - hbefore[k]
                 for k, v in _hist_counts(reg, _SERVING_HISTS).items()}
        docs = {d["rid"]: d for d in sched.tracer.snapshot()[
            "finished_recent"]}
        out[name] = (sched, counters, hists, docs, sched.slo.snapshot())
    return out


def test_serving_counters_match_jax(served):
    """Every ``serving_*`` counter the JAX scheduler moved moves by the
    same amount in the port (preemptions included), and the histograms
    hold as many observations."""
    (jsched, jc, jh, _, _), (tsched, tc, th, _, _) = (served["jax"],
                                                      served["torch"])
    assert tc == jc
    assert tc["serving_requests_total"] == 6
    assert tc["serving_requests_completed_total"] == 6
    assert tc["serving_preemptions_total"] > 0
    assert tc["serving_tokens_generated_total"] == sum(
        len(r.generated) for r in tsched.finished)
    assert th == jh and th["serving_ttft_ms"] == 6
    assert {r.rid: r.t_tokens for r in tsched.finished} == \
        {r.rid: r.t_tokens for r in jsched.finished}


def test_tracer_documents_match_jax(served):
    """Per request: the same generated-token count, decode ticks,
    preemptions, status, TTFT (on the injected clock) and phase
    sequence in both packages' request traces."""
    def view(docs):
        return {rid: (d["tokens"], d["ticks"], d["preemptions"],
                      d["status"], d["ttft_ms"], d["prompt_tokens"],
                      [p["phase"] for p in d["phases"]])
                for rid, d in docs.items()}

    jd, td = served["jax"][3], served["torch"][3]
    assert view(td) == view(jd) and len(td) == 6
    assert any("preempted" in v[6] for v in view(td).values())


def test_slo_windows_match_jax(served):
    """The SLO plane saw the same events: TTFT and queue-wait windows
    exactly (the injected clock sets them), tick and ITL windows by
    count, and the same rates and goodput."""
    js, ts = served["jax"][4], served["torch"][4]
    for sli in ("ttft_ms", "queue_wait_ms"):
        assert ts["slis"][sli] == js["slis"][sli]
    for sli in ("tick_ms", "itl_ms"):
        for w in ("1m", "5m", "30m"):
            assert ts["slis"][sli]["windows"][w]["count"] == \
                js["slis"][sli]["windows"][w]["count"]
    assert ts["rates"] == js["rates"]
    assert ts["goodput_ratio"] == js["goodput_ratio"]


def test_scheduler_endpoint_and_wedged_readiness(served):
    """``/healthz`` has the JAX scheduler's keys and flips to 503
    (``wedged``) once the tick loop has stalled past
    ``stall_threshold_s`` with work queued, while ``?live`` stays 200;
    ``/slo``, ``/dashboard``, ``/debug/requests`` and ``/metrics``
    answer; ``/slo?tenant=`` answers the global document when no tenant
    view is attached, as the JAX endpoint does; a bad
    ``secs`` is 400, a second profile capture 409, and a capture
    reports the recording window the endpoint keeps."""
    jsched, tsched = served["jax"][0], served["torch"][0]
    clk = VClock(0.0)
    s = ContinuousBatchingScheduler(tsched.engine, clock=clk,
                                    slo=T.SLOTracker(clock=clk),
                                    stall_threshold_s=10.0)
    host, port = s.start_http(port=0)
    assert host == "127.0.0.1" and s.start_http() == (host, port)
    try:
        url = s.http.url
        code, body = _get(url + "/healthz")
        doc = json.loads(body)
        assert code == 200 and doc["wedged"] is False
        assert set(doc) - {"status", "uptime_s", "pid"} == \
            set(jsched._health_snapshot())
        s.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                         max_new_tokens=6))
        s.step()
        clk.t += 11.0
        code, body = _get(url + "/healthz")
        doc = json.loads(body)
        assert code == 503 and doc["wedged"] is True
        assert doc["last_tick_age_s"] == pytest.approx(11.0)
        assert _get(url + "/healthz?live")[0] == 200
        for route in ("/slo", "/dashboard", "/debug/requests", "/metrics"):
            assert _get(url + route)[0] == 200, route
        assert json.loads(_get(url + "/debug/requests")[1])[
            "in_flight"][0]["rid"] == 0
        # no tenant view attached: the global document, as the JAX
        # endpoint answers
        assert _get(url + "/slo?tenant=a") == _get(url + "/slo")
        assert _get(url + "/slo")[0] == 200
        assert _get(url + "/debug/profile?secs=x")[0] == 400
        s.http._profile_lock.acquire()
        try:
            assert _get(url + "/debug/profile?secs=0.05")[0] == 409
        finally:
            s.http._profile_lock.release()
        code, body = _get(url + "/debug/profile?secs=0.05")
        doc = json.loads(body)
        assert code == 200 and os.path.exists(doc["path"])
        assert doc["window"] == [s.http.profile_window["open"],
                                 s.http.profile_window["close"]]
        assert doc["window"][1] - doc["window"][0] >= 0.05
        # no card: no marker kernels to run before the window opens
        assert doc["markers"] == [0, 0]
        s.run()
        assert _get(url + "/healthz")[0] == 200
    finally:
        s.stop_http()
    s.stop_http()          # idempotent
    assert s.http is None


def test_profile_window_opens_at_the_first_recorded_launch(tmp_path):
    """The profile capture's trace reader: the device kernels and the
    marker kernels among them; launches without a kernel record (a
    capture's first ones can lack it) move the window's opening to the
    first launch the trace holds a kernel for, never earlier than it
    was."""
    from paddle_tpu_torch.observability import http_endpoint as he

    def launch(ts, corr):
        return {"cat": "cuda_runtime", "ts": ts, "name": "cudaLaunchKernel",
                "args": {"correlation": corr}}

    def kernel(ts, corr, name):
        return {"cat": "kernel", "ts": ts, "name": name,
                "args": {"correlation": corr}}

    events = [launch(100.0, 1), launch(200.0, 2), launch(300.0, 3),
              kernel(310.0, 3, "spin_kernel(long)"), launch(400.0, 4),
              kernel(410.0, 4, "paged_split_kernel<1, 64, 1>"),
              {"cat": "cuda_runtime", "ts": 50.0, "name": "cudaMemcpyAsync",
               "args": {"correlation": 9}},
              {"cat": "gpu_memcpy", "ts": 60.0, "name": "Memcpy HtoD",
               "args": {"correlation": 9}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": 1_000_000_000_000,
                                "traceEvents": events}))
    window = {"open": 1000.0001}
    assert he._read_trace(str(path), window) == (2, 1)
    assert window["open"] == pytest.approx(1000.0003, abs=1e-9)
    window = {"open": 1000.0005}            # records already flowed
    he._read_trace(str(path), window)
    assert window["open"] == 1000.0005
    path.write_text(json.dumps({"traceEvents": events[:3]}))
    window = {"open": 5.0}                  # no record at all: kept
    assert he._read_trace(str(path), window) == (0, 0)
    assert window["open"] == 5.0


@pytest.mark.parametrize("keyed", [False, True],
                         ids=["global", "tenant_view"])
def test_slo_tenant_reply_matches_jax(keyed):
    """``GET /slo?tenant=gold``: with no ``slo_tenant`` callable both
    endpoints answer 200 with the global document; with one attached,
    both answer its keyed view. Status and body exact."""
    def slo():
        return {"ok": 1}

    def keyed_view(name):
        return {"tenant": name, "known": name == "gold"}

    replies = []
    for cls in (J.ObsHTTPEndpoint, T.ObsHTTPEndpoint):
        ep = cls(port=0, slo=slo,
                 slo_tenant=keyed_view if keyed else None).start()
        try:
            replies.append([_get(ep.url + q) for q in (
                "/slo?tenant=gold", "/slo?tenant=ghost", "/slo")])
        finally:
            ep.stop()
    assert replies[1] == replies[0]
    gold = json.loads(replies[1][0][1])
    assert replies[1][0][0] == 200
    assert gold == ({"tenant": "gold", "known": True} if keyed
                    else {"ok": 1})


# -- checkpoints -------------------------------------------------------------

_CKPT_HISTS = ("checkpoint_manager_save_ms", "checkpoint_save_ms",
               "checkpoint_load_ms")


def test_checkpoint_metrics_match_jax(tmp_path):
    """A sync save, two async saves (the second waits for the first),
    and a load of the same state: the same counter deltas (bytes = the
    shard files), histogram counts, in-flight gauges back at 0, and
    ``checkpoint_saved`` events in each package's stream."""
    rng = np.random.RandomState(0)
    state = {"w": rng.rand(64, 256).astype(np.float32),
             "b": rng.rand(256).astype(np.float32),
             "step": np.int32(7)}
    out = {}
    for name, mod, ck in (("jax", J, jckpt), ("torch", T, tckpt)):
        reg = mod.registry()
        root = str(tmp_path / name / "ckpt")
        mod.configure(str(tmp_path / name / "obs"), worker="w")
        try:
            before = _counters(reg, "checkpoint_")
            hbefore = _hist_counts(reg, _CKPT_HISTS)
            ck.CheckpointManager(root).save(state, 1)
            amgr = ck.AsyncCheckpointManager(root)
            amgr.save(state, 2)
            amgr.save(state, 3)
            amgr.wait()
            step, loaded = ck.CheckpointManager(root).load_latest()
            mod.sink.flush()
            with open(tmp_path / name / "obs" / "metrics-w.jsonl") as f:
                events = [json.loads(line) for line in f]
        finally:
            mod.configure("")
            mod.configure(None)
        out[name] = {
            "counters": _moved(before, _counters(reg, "checkpoint_")),
            "hists": {k: v - hbefore[k] for k, v in
                      _hist_counts(reg, _CKPT_HISTS).items()},
            "in_flight": reg.gauge("checkpoint_async_saves_in_flight",
                                   root=root).value,
            "saved": sorted((e["step"], e.get("async", False))
                            for e in events
                            if e.get("name") == "checkpoint_saved"),
            "step": step,
            "shard": os.path.getsize(os.path.join(root, "step-3",
                                                  "shard-0.pkl"))}
        assert all(np.array_equal(np.asarray(loaded[k]), v)
                   for k, v in state.items())
    assert out["torch"] == out["jax"]
    t = out["torch"]
    assert t["counters"]["checkpoint_bytes_total"] == 3 * t["shard"]
    assert t["counters"]["checkpoint_saves_total"] == 3
    assert t["counters"]["checkpoint_loads_total"] == 1
    assert t["hists"]["checkpoint_manager_save_ms"] == 3
    assert t["in_flight"] == 0 and t["step"] == 3
    assert t["saved"] == [(1, False), (2, True), (3, True)]

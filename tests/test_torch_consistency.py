"""The port's cross-rank consistency check and flight recorder against
the JAX package's, on the CPU.

- ``tree_digest64`` (numpy trees, torch tensors, bfloat16), the
  ``json_digest64``, ``float_bits``, ``compare_digests`` and
  ``format_diff`` give the JAX package's values bit for bit / string
  for string;
- a port rank and a JAX rank share one ``DigestExchange`` directory and
  each gathers the other's digest; a stalled peer raises
  ``CollectiveStallError`` after the flight dump; generations are
  isolated;
- the port's trainer and the JAX trainer digest the same params to the
  same fields; the in-process check (a mirror thread as rank 1) raises
  ``DesyncError`` at the drifted step; ``/healthz`` carries the check's
  state;
- the flight ring, watchdog and peer dump requests as the JAX tests run
  them, and ``tools/obs_report.py --flight`` reads the port's dumps;
- drills through the launcher over 2 CPU ranks (``dp=2``): a desync
  planted on rank 0 at step 3 is caught at step 4 on both ranks, names
  ``params_hash`` and rank 0, and exits 119, which the launcher
  classifies ``desync``; a stall of rank 0 at step 3 trips rank 1's
  collective watchdog, and the merged flight report names rank 0 as
  never entering the collective at that seq.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(**over):
    d = {"step": 4, "params_hash": 111, "loss_bits": 222,
         "loss_scale": 333, "data_cursor": None}
    d.update(over)
    return d


def _tree(rng):
    return {"b": {"z": rng.randn(3, 4).astype(np.float32),
                  "a": rng.randint(0, 9, (5,)).astype(np.int32)},
            "a": [rng.randn(2).astype(np.float64), 1.5, None],
            "c": np.float32(2.0)}


# -- digests and their comparison ----------------------------------------------

def test_digests_equal_the_jax_packages():
    import jax.numpy as jnp

    from paddle_tpu.distributed import consistency as jc
    from paddle_tpu_torch.distributed import consistency as tc

    rng = np.random.RandomState(0)
    tree = _tree(rng)
    assert tc.tree_digest64(tree) == jc.tree_digest64(tree)
    # tensors hash as the arrays they hold; bfloat16 as its 16-bit words
    as_torch = {"b": {k: torch.from_numpy(v) for k, v in tree["b"].items()},
                "a": tree["a"], "c": tree["c"]}
    assert tc.tree_digest64(as_torch) == jc.tree_digest64(tree)
    x = rng.randn(4, 6).astype(np.float32)
    assert tc.tree_digest64({"w": torch.from_numpy(x).bfloat16()}) == \
        jc.tree_digest64({"w": jnp.asarray(x, jnp.bfloat16)})
    assert tc.tree_digest64({"w": x}) != tc.tree_digest64({"w": x + 1e-7})
    for obj in ({"cursor": 7, "epoch": 1}, [1, "a"], None):
        assert tc.json_digest64(obj) == jc.json_digest64(obj)
    for v in (1.5, 1.5 + 1e-12, float("nan"), -0.0, torch.tensor(2.25)):
        assert tc.float_bits(v) == jc.float_bits(float(v))
    assert tc.float_bits(float("nan")) == tc.float_bits(float("nan"))
    assert tc.DIGEST_FIELDS == jc.DIGEST_FIELDS


@pytest.mark.parametrize("gathered", [
    {0: _digest(), 1: _digest()},
    {0: _digest(params_hash=999), 1: _digest(), 2: _digest()},
    {0: _digest(loss_bits=9), 1: _digest()},
    {0: _digest(step=5, data_cursor=3), 1: _digest(), 2: _digest(step=5)},
], ids=["agree", "minority", "split", "two-fields"])
def test_compare_and_format_equal_the_jax_packages(gathered):
    from paddle_tpu.distributed import consistency as jc
    from paddle_tpu_torch.distributed import consistency as tc

    got, want = tc.compare_digests(gathered), jc.compare_digests(gathered)
    assert got == want
    if got[0]:
        assert tc.format_diff(4, *got) == jc.format_diff(4, *want)


# -- the exchange --------------------------------------------------------------

def test_port_and_jax_ranks_share_one_exchange(tmp_path):
    from paddle_tpu.distributed import consistency as jc
    from paddle_tpu_torch.distributed import consistency as tc

    port = tc.DigestExchange(str(tmp_path), rank=0, world=2, generation=3)
    jax_ = jc.DigestExchange(str(tmp_path), rank=1, world=2, generation=3)
    port.publish(2, _digest(step=2))
    jax_.publish(2, _digest(step=2, params_hash=5))
    want = {0: _digest(step=2), 1: _digest(step=2, params_hash=5)}
    assert port.gather(2, timeout_s=5) == want
    assert jax_.gather(2, timeout_s=5) == want
    port.publish(4, _digest())
    port.cleanup_before(4)
    assert sorted(os.listdir(tmp_path / "gen3" / "step-2")) == ["rank-1.json"]


def test_checker_raises_desync_and_stall_dumps(tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed import collective_runtime as cr
    from paddle_tpu_torch.distributed import consistency as tc

    ex0 = tc.DigestExchange(str(tmp_path / "x"), rank=0, world=2,
                            generation=0)
    ex1 = tc.DigestExchange(str(tmp_path / "x"), rank=1, world=2,
                            generation=0)
    chk = tc.ConsistencyChecker(every=2, exchange=ex0, timeout_s=10)
    assert chk.maybe_check(3, lambda: 1 / 0) is None      # off the grid
    ex1.publish(2, _digest(step=2))
    assert set(chk.maybe_check(2, lambda: _digest(step=2))) == {0, 1}
    ex1.publish(4, _digest(params_hash=777))
    with pytest.raises(tc.DesyncError) as ei:
        chk.check(4, _digest())
    assert ei.value.exit_code == 119 and ei.value.diff["params_hash"][1] == 777
    assert "rank 1" in str(ei.value)
    # a peer that never publishes
    monkeypatch.setenv("PADDLE_OBS_DIR", str(tmp_path / "obs"))
    cr.reset_flight_recorder()
    try:
        ex0.publish(6, _digest(step=6))
        with pytest.raises(tc.CollectiveStallError) as ei:
            ex0.gather(6, timeout_s=0.3)
        assert ei.value.missing_ranks == [1]
        dump = tmp_path / "obs" / "flight" / "flight-rank0.json"
        assert "timed out" in json.loads(dump.read_text())["reason"]
    finally:
        cr.reset_flight_recorder()
    # a relaunched generation never reads the last one's digests
    old = tc.DigestExchange(str(tmp_path / "g"), rank=1, world=2,
                            generation=0)
    old.publish(2, _digest())
    new0 = tc.DigestExchange(str(tmp_path / "g"), rank=0, world=2,
                             generation=1)
    new0.publish(2, _digest())
    with pytest.raises(tc.CollectiveStallError):
        new0.gather(2, timeout_s=0.2)


# -- the trainers --------------------------------------------------------------

def _tiny(pkg):
    return pkg.GPTConfig(vocab_size=128, hidden_size=32, num_layers=1,
                         num_heads=2, max_position_embeddings=32)


def test_trainer_digests_equal_the_jax_trainers(tmp_path):
    """The same params (the JAX trainer's init) digest to the same
    fields in both trainers; ``/healthz`` carries every key of the JAX
    trainer's payload, the check's state among them."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models import gpt as JM
    from paddle_tpu.parallel import hybrid as jh
    from paddle_tpu_torch.models import gpt as TM
    from paddle_tpu_torch.parallel import hybrid as th

    jt = jh.HybridParallelTrainer(_tiny(JM), jh.TrainerConfig(
        telemetry=False, compute_dtype=jnp.float32,
        consistency_check_every=2), devices=jax.devices()[:1])
    jt._consistency.exchange.dir = str(tmp_path / "j")
    tt = th.HybridParallelTrainer(
        _tiny(TM), th.TrainerConfig(compute_dtype=torch.float32,
                                    http_port=0),
        device="cpu", params=jax.device_get(jt.params))
    tt.enable_consistency_check(2, exchange_dir=str(tmp_path / "t"))
    try:
        assert tt._consistency_digest(1.25) == jt._consistency_digest(1.25)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{tt.http.port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert set(jt._health_snapshot()) <= set(health)
        assert health["consistency_check"] is True
    finally:
        tt.http.stop()


def test_trainer_consistency_check_in_process(tmp_path, monkeypatch):
    """Rank 0 is the port trainer; 'rank 1' a mirror thread that echoes
    its digests until step 4, where it reports a drifted params hash."""
    from paddle_tpu_torch.models import gpt as TM
    from paddle_tpu_torch.parallel import hybrid as th

    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.delenv("PADDLE_RESTART_GENERATION", raising=False)
    t = th.HybridParallelTrainer(_tiny(TM), th.TrainerConfig(
        telemetry=False), device="cpu")
    t.enable_consistency_check(every=2, exchange_dir=str(tmp_path),
                               timeout_s=60)
    stop = threading.Event()

    def mirror():
        ex = t._consistency.exchange
        for step in (2, 4):
            src = ex._rank_file(step, 0)
            while not os.path.exists(src) and not stop.is_set():
                time.sleep(0.01)
            if stop.is_set():
                return
            d = json.loads(open(src).read())
            if step == 4:
                d["params_hash"] = (d["params_hash"] + 1) % 2 ** 64
            with open(f"{src}.peer", "w") as f:
                f.write(json.dumps(d))
            os.replace(f"{src}.peer", ex._rank_file(step, 1))

    th_ = threading.Thread(target=mirror, daemon=True)
    th_.start()
    tok = np.random.RandomState(0).randint(0, 128, (2, 16))
    try:
        t.step(tok, tok)
        t.step(tok, tok)
        assert t._consistency.checks == 1
        t.step(tok, tok)
        with pytest.raises(th.DesyncError) as ei:
            t.step(tok, tok)
        assert ei.value.step == 4 and "params_hash" in str(ei.value)
        assert "rank 1" in str(ei.value)
    finally:
        stop.set()
        th_.join(timeout=5)


# -- the flight recorder -------------------------------------------------------

def test_flight_ring_is_bounded_and_exception_safe():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.collective_runtime import (
        FlightRecorder, collective_span, flight_recorder)

    r = FlightRecorder(capacity=8, timeout_s=0, directory=None)
    for i in range(50):
        r.end(r.begin("all_reduce", nbytes=i))
    recs = r.records()
    assert len(recs) == 8 and recs[-1]["seq"] == 50
    assert all(x["status"] == "ok" for x in recs)
    before = obs.registry().counter("collective_errors_total",
                                    op="broadcast").value
    with pytest.raises(ValueError):
        with collective_span("broadcast", torch.zeros(4)):
            raise ValueError("injected")
    tail = flight_recorder().records()[-1]
    assert (tail["op"], tail["status"], tail["bytes"]) == (
        "broadcast", "error", 16)
    assert tail["t_end"] is not None
    assert obs.registry().counter("collective_errors_total",
                                  op="broadcast").value == before + 1


def _wait_for(path, secs=5):
    deadline = time.time() + secs
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.02)
    return os.path.exists(path)


def test_watchdog_stale_marker_and_peer_request(tmp_path, monkeypatch):
    """The watchdog marks an op past its deadline ``timeout``, dumps the
    ring (the JAX package's keys) and drops the peer marker; a marker
    older than the recorder is ignored; an idle rank dumps on a peer's
    request."""
    from paddle_tpu.distributed.collective_runtime import FlightRecorder as J
    from paddle_tpu_torch.distributed.collective_runtime import (
        FlightRecorder)

    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    d0 = tmp_path / "a"
    r = FlightRecorder(capacity=8, timeout_s=0.2, directory=str(d0),
                       poll_s=0.05)
    try:
        rec = r.begin("all_gather")
        assert _wait_for(d0 / "flight-rank0.json")
        assert rec["status"] == "timeout"
        payload = json.loads((d0 / "flight-rank0.json").read_text())
        assert payload["records"][-1]["op"] == "all_gather"
        assert "exceeded" in payload["reason"]
        assert (d0 / "dump-request").exists()
        r.end(rec)
        assert rec["status"] == "ok_after_timeout"
    finally:
        r.stop()
    jr = J(capacity=8, timeout_s=0, directory=str(tmp_path / "j"))
    jr.end(jr.begin("all_gather"))
    jr.dump("x")
    jr.stop()
    assert set(json.loads((tmp_path / "j" / "flight-rank0.json")
                          .read_text())) == set(payload)

    d1 = tmp_path / "b"
    d1.mkdir()
    (d1 / "dump-request").write_text("{}")
    old = time.time() - 30
    os.utime(d1 / "dump-request", (old, old))
    (d1 / "flight-rank0.json").write_text(json.dumps(
        {"reason": "the post-mortem", "records": []}))
    r = FlightRecorder(capacity=8, timeout_s=0, directory=str(d1),
                       poll_s=0.05)
    try:
        r.end(r.begin("all_reduce"))
        time.sleep(0.3)
        assert json.loads((d1 / "flight-rank0.json").read_text())[
            "reason"] == "the post-mortem"
        (d1 / "dump-request").write_text("{}")
        deadline = time.time() + 5
        while time.time() < deadline and json.loads(
                (d1 / "flight-rank0.json").read_text())["reason"] != \
                "peer dump request":
            time.sleep(0.02)
        payload = json.loads((d1 / "flight-rank0.json").read_text())
        assert payload["reason"] == "peer dump request"
        assert payload["records"][-1]["status"] == "ok"
    finally:
        r.stop()


def test_obs_report_reads_the_ports_flight_dumps(tmp_path, monkeypatch):
    """Two ranks' rings, rank 1 stuck in seq 3 and rank 0 never in it,
    dumped by the port's recorder: ``tools/obs_report.py --flight``
    names the stalled rank and the seq."""
    from paddle_tpu_torch.distributed.collective_runtime import (
        FlightRecorder)

    flight = tmp_path / "flight"
    for rank, n in (("0", 2), ("1", 3)):
        monkeypatch.setenv("PADDLE_TRAINER_ID", rank)
        r = FlightRecorder(capacity=8, timeout_s=0, directory=str(flight))
        for i in range(n):
            rec = r.begin("all_reduce", nbytes=64)
            if i < 2:
                r.end(rec)
        rec["status"] = "timeout" if n == 3 else rec["status"]
        r.dump(reason="test")
        r.stop()
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "obs_report.py"),
         str(tmp_path), "--flight", "--json"],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    a = json.loads(res.stdout)
    assert (a["first_divergent_seq"], a["op"], a["never_entered"],
            a["timed_out"]) == (3, "all_reduce", ["rank0"], ["rank1"])


# -- drills through the launcher ----------------------------------------------

DRILL = """
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.parallel import hybrid

dev = init_parallel_env(device="cpu")
rank = int(os.environ["PADDLE_TRAINER_ID"])
cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                max_position_embeddings=64)
t = hybrid.HybridParallelTrainer(cfg, hybrid.TrainerConfig(
    dp=2, compute_dtype=torch.float32, consistency_check_every=2),
    device=dev)
rng = np.random.RandomState(7)
try:
    for step in range(1, 7):
        t.step(rng.randint(0, 128, (4, 16)), rng.randint(0, 128, (4, 16)))
    out = {"completed": t.global_step}
except hybrid.DesyncError as e:
    out = {"detected_step": t.global_step, "error": str(e)}
    print(str(e), file=sys.stderr, flush=True)
with open(os.path.join(os.environ["WORK"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
if "error" in out:
    sys.exit(hybrid.DESYNC_EXIT_CODE)
"""


def _drill(work, **env):
    script = work / "drill.py"
    script.write_text(DRILL)
    full = dict(os.environ, OMP_NUM_THREADS="1", WORK=str(work),
                PADDLE_FI_DIR=str(work / "fi"),
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    for k in [k for k in full if k.startswith("PADDLE_") and k not in (
            "PADDLE_FI_DIR",)]:
        del full[k]
    full.update(env)
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--grace_secs", "5", str(script)],
        env=full, capture_output=True, text=True, timeout=180, cwd=str(work))
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in (0, 1)]
    return res, ranks


def test_desync_drill_exits_119_naming_rank_0(tmp_path):
    res, ranks = _drill(tmp_path, PADDLE_FI_DESYNC_AT_STEP="3")
    assert res.returncode == 1, res.stderr[-2000:]
    assert "[launch] desync:" in res.stderr
    assert "cross-rank desync (DesyncError, exit 119" in res.stderr
    for r in ranks:
        assert r["detected_step"] == 4, r
        assert "params_hash" in r["error"] and "rank 0" in r["error"]
        assert "suspect rank(s)" in r["error"]


def test_stall_drill_flight_report_names_the_stalled_rank(tmp_path):
    obs_dir = tmp_path / "obs"
    res, ranks = _drill(tmp_path, PADDLE_FI_STALL_AT_STEP="3",
                        PADDLE_FI_STALL_SECS="4",
                        PADDLE_OBS_DIR=str(obs_dir),
                        PADDLE_COLLECTIVE_TIMEOUT_S="1")
    assert res.returncode == 0, res.stderr[-2000:]
    assert ranks == [{"completed": 6}] * 2
    assert "collective watchdog" in res.stderr and "exceeded" in res.stderr
    assert sorted(os.listdir(obs_dir / "flight")) == [
        "dump-request", "flight-rank0.json", "flight-rank1.json"]
    rep = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "obs_report.py"),
         str(obs_dir), "--flight", "--json"],
        capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr
    a = json.loads(rep.stdout)
    assert a["never_entered"] == ["rank0"] and a["timed_out"] == ["rank1"]
    assert a["first_divergent_seq"] is not None and a["op"] == "all_reduce"

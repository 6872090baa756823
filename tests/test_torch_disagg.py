"""Disaggregated prefill/decode in the port against the JAX package on
the CPU: ``copy_pages`` leaves the same pool bytes as the JAX function
(fp32 and int8 pools with their scales, with and without ``limit``) and
raises the same guards; ``plan_kv_pool`` returns the JAX dict exactly for
GPT-345M, LLaMA-7B and a tiny config at fp32, bf16 and int8;
``adopt`` refuses what the JAX scheduler refuses; and a prefill replica
plus a decode replica under the router and the handoff coordinator give
the JAX run's streams exactly, cleanly and under each handoff fault
(transfer dropped, truncated, source killed or wedged mid-handoff,
decode pool too small), with no page leaked or leased on any live pool
afterwards."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.models import llama as JLM
from paddle_tpu.serving import disagg as jdisagg
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import replica as jreplica
from paddle_tpu.serving import router as jrouter
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.models import llama as TLM
from paddle_tpu_torch.serving import disagg as tdisagg
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import replica as treplica
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving.engine import ServingConfig, ServingEngine
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

_TINY = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
             max_position_embeddings=64, hidden_dropout=0.0,
             attention_dropout=0.0)
_FI = ("PADDLE_FI_HANDOFF_DROP", "PADDLE_FI_HANDOFF_PARTIAL",
       "PADDLE_FI_HANDOFF_STALL")


# -- copy_pages ---------------------------------------------------------------

def _caches(kv_dtype, num_pages=9, layers=2, ps=4, nh=2, d=8, seed=0):
    """A JAX and a port cache of one geometry holding the same random
    bytes; the port's drop pages hold a sentinel."""
    j = jkv.PagedKVCache(layers, num_pages, ps, nh, d, kv_dtype=kv_dtype)
    t = tkv.PagedKVCache(layers, num_pages, ps, nh, d, kv_dtype=kv_dtype,
                         device="cpu")
    rng = np.random.RandomState(seed)

    def fill(jpools, tstores, shape, dtype):
        out = []
        for store in tstores:
            if dtype == np.int8:
                a = rng.randint(-127, 128, shape).astype(np.int8)
            else:
                a = rng.randn(*shape).astype(dtype)
            store[:num_pages] = torch.from_numpy(a)
            store[num_pages:] = 7
            out.append(jnp.asarray(a))
        return out

    dt = np.int8 if kv_dtype == "int8" else np.float32
    shape = (num_pages, ps, nh * d)
    j.k_pools = fill(j.k_pools, t.k_stores, shape, dt)
    j.v_pools = fill(j.v_pools, t.v_stores, shape, dt)
    if kv_dtype == "int8":
        j.s_pools = fill(j.s_pools, t.s_stores, (num_pages, 2, nh),
                         np.float32)
    return j, t


def _pools(j, t):
    names = ["k_pools", "v_pools"] + (["s_pools"] if t.s_pools else [])
    jb = [np.asarray(p) for n in names for p in getattr(j, n)]
    tb = [p.numpy() for n in names for p in getattr(t, n)]
    return jb, tb


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("limit", [None, 2, 0])
def test_copy_pages_matches_jax_bytes(kv_dtype, limit):
    js, ts = _caches(kv_dtype, seed=1)
    jd, td = _caches(kv_dtype, seed=2)
    src, dst = [3, 1, 8, 5], [2, 7, 4, 6]
    n_j = jkv.copy_pages(js, jd, src, dst, limit=limit)
    n_t = tkv.copy_pages(ts, td, src, dst, limit=limit)
    assert n_t == n_j == (4 if limit is None else limit)
    for a, b in zip(*_pools(jd, td)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(*_pools(js, ts)):      # the source is untouched
        assert np.array_equal(a, b)
    stores = td.k_stores + td.v_stores + (td.s_stores or [])
    assert all(bool((s[td.num_pages:] == 7).all()) for s in stores), \
        "a drop page was written"


def test_copy_pages_guards_match_jax():
    def err(mod, *a, **kw):
        with pytest.raises(ValueError) as ei:
            mod.copy_pages(*a, **kw)
        return str(ei.value)

    bf = types.SimpleNamespace(kv_dtype="bf16")
    i8 = types.SimpleNamespace(kv_dtype="int8")
    for args in ((bf, bf, [1, 2], [3]), (bf, i8, [1], [2])):
        assert err(tkv, *args) == err(jkv, *args)
    assert tkv.copy_pages(bf, bf, [1, 2], [3, 4], limit=0) == \
        jkv.copy_pages(bf, bf, [1, 2], [3, 4], limit=0) == 0
    # the port's own guards: geometry, pages past the pool, devices
    _, a = _caches("fp32")
    _, b = _caches("fp32", ps=8)
    with pytest.raises(ValueError, match="geometry"):
        tkv.copy_pages(a, b, [1], [1])
    with pytest.raises(ValueError, match="outside the pool"):
        tkv.copy_pages(a, a, [1], [a.num_pages])
    meta = tkv.PagedKVCache(2, 9, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="device mismatch"):
        tkv.copy_pages(a, meta, [1], [1])


# -- plan_kv_pool ---------------------------------------------------------

_PLAN_CFGS = {
    "gpt_345m": (JM.gpt_345m, TM.gpt_345m),
    "llama_7b": (JLM.llama_7b, TLM.llama_7b),
    "gpt_tiny": (JM.gpt_tiny, TM.gpt_tiny),
}
_POOLS = {
    "fp32": ({}, {}),
    "bf16": ({"dtype": jnp.bfloat16}, {"dtype": torch.bfloat16}),
    "int8": ({"kv_dtype": "int8"}, {"kv_dtype": "int8"}),
}


@pytest.mark.parametrize("pool", list(_POOLS))
@pytest.mark.parametrize("model", list(_PLAN_CFGS))
def test_plan_kv_pool_matches_jax(model, pool):
    jcfg, tcfg = (f() for f in _PLAN_CFGS[model])
    jkw, tkw = _POOLS[pool]
    for cap in (80 << 30, 5 << 30):
        want = jkv.plan_kv_pool(jcfg, capacity_bytes=cap, **jkw)
        got = tkv.plan_kv_pool(tcfg, capacity_bytes=cap, **tkw)
        assert got == want
    assert tkv.plan_kv_pool(tcfg, dtype_bytes=2, page_size=32,
                            hbm_fraction=0.5, capacity_bytes=80 << 30) == \
        jkv.plan_kv_pool(jcfg, dtype_bytes=2, page_size=32,
                         hbm_fraction=0.5, capacity_bytes=80 << 30)
    # the reference values the chip check plans against
    if model != "gpt_tiny" and pool != "fp32":
        pages = {("gpt_345m", "bf16"): 15571, ("gpt_345m", "int8"): 31022,
                 ("llama_7b", "bf16"): 180, ("llama_7b", "int8"): 359}
        plan = tkv.plan_kv_pool(tcfg, capacity_bytes=80 << 30, **tkw)
        assert plan["num_pages"] == pages[model, pool]


# -- the engines ------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JM.GPTForCausalLM(JM.GPTConfig(**_TINY))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TM.GPTConfig(**_TINY)
    tm = TM.GPTForCausalLM(cfg, device="cpu").eval()
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    return jm, tm


def _side(models, which):
    """One package's modules and model, so one script drives both."""
    jm, tm = models
    if which == "jax":
        return types.SimpleNamespace(
            model=jm, Engine=JEngine, Config=JConfig, sched=jsched,
            replica=jreplica, router=jrouter, disagg=jdisagg)
    return types.SimpleNamespace(
        model=tm, Engine=ServingEngine, Config=ServingConfig, sched=tsched,
        replica=treplica, router=trouter, disagg=tdisagg)


def _p(n, seed=0):
    return ((np.arange(n) * 7 + seed * 13) % 64).astype(np.int32)


def _engine(side, **kw):
    base = dict(page_size=8, max_model_len=64, max_batch=2,
                max_prefill_tokens=128)
    base.update(kw)
    return side.Engine(side.model, side.Config(**base))


def _adoptee(side, pool, rid):
    r = side.sched.Request(rid=rid, prompt=_p(6, seed=rid),
                           max_new_tokens=4)
    r.pages = pool.allocate(1)
    r.context_len = 6
    r.generated = [1]
    return r


@pytest.mark.parametrize("case", ["after_free", "duplicate", "no_slot"])
def test_adopt_rejects_what_jax_rejects(models, case):
    out = []
    for which in ("jax", "torch"):
        side = _side(models, which)
        eng = _engine(side)
        s = side.sched.ContinuousBatchingScheduler(eng)
        if case == "after_free":
            r = _adoptee(side, eng.pool, 0)
            eng.pool.free(r.pages)
        elif case == "duplicate":
            s.adopt(_adoptee(side, eng.pool, 0))
            r = _adoptee(side, eng.pool, 0)
        else:
            s.adopt(_adoptee(side, eng.pool, 0))
            s.adopt(_adoptee(side, eng.pool, 1))
            r = _adoptee(side, eng.pool, 2)
        with pytest.raises((ValueError, RuntimeError)) as ei:
            s.adopt(r)
        out.append((type(ei.value).__name__, str(ei.value),
                    getattr(ei.value, "reason", None),
                    len(s.running), eng.pool.in_use))
    assert out[1] == out[0]
    assert case != "no_slot" or out[1][2] == "no_slot"


# -- the split run under each fault -------------------------------------------

class VClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _split_run(side, fault, kv_dtype="fp32"):
    """Three requests through one prefill and one decode replica, driven
    round by round on a virtual clock; ``fault`` arms a handoff fault or
    lands replica chaos inside a stalled handoff. Returns the streams,
    the coordinator's snapshot and the live pools' page counts."""
    clk = VClock()
    dec_pages = 5 if fault == "pressure" else None
    pre = side.replica.Replica(
        "pre0", make_engine=lambda: _engine(side, max_batch=4,
                                            kv_dtype=kv_dtype),
        clock=clk, role="prefill")
    dec = side.replica.Replica(
        "dec0", make_engine=lambda: _engine(side, max_batch=4,
                                            num_pages=dec_pages,
                                            kv_dtype=kv_dtype),
        clock=clk, role="decode")
    router = side.router.ReplicaRouter(
        [pre, dec], clock=clk, cfg=side.router.RouterConfig(
            probe_interval_s=0.0, breaker_failures=1))
    coord = side.disagg.DisaggCoordinator(router)
    lens = (18, 20, 22) if fault == "pressure" else (10, 13, 16)
    lrs = [router.submit_request(side.router.LogicalRequest(
        rid=rid, prompt=_p(n, seed=rid), max_new_tokens=6))
        for rid, n in enumerate(lens)]
    struck = False
    for rounds in range(2000):
        if not router.in_flight:
            break
        router.pump()
        if (fault in ("kill", "wedge") and not struck
                and coord._active.get(1) is not None):
            struck = True                   # rid 1's handoff is stalled
            if fault == "kill":
                pre.kill()
            else:
                pre.wedge(3600.0)
        for rep in (pre, dec):
            rep.tick()
        clk.t += 0.01
    assert not router.in_flight, "split run stalled"
    assert fault not in ("kill", "wedge") or struck
    pools = {rep.name: (rep.engine.pool.in_use, rep.engine.pool.leased)
             for rep in (pre, dec) if rep.engine is not None}
    return ({lr.rid: (lr.status, list(lr.delivered), lr.redispatches)
             for lr in lrs}, coord.snapshot(), pools)


_FAULTS = {
    "clean": {},
    "drop": {"PADDLE_FI_HANDOFF_DROP": "1"},
    "partial": {"PADDLE_FI_HANDOFF_PARTIAL": "2:1"},
    "kill": {"PADDLE_FI_HANDOFF_STALL": "1:4"},
    "wedge": {"PADDLE_FI_HANDOFF_STALL": "1:4"},
    "pressure": {},
}


@pytest.mark.parametrize("kv_dtype,fault", [
    ("fp32", f) for f in _FAULTS] + [("int8", "clean"),
                                     ("int8", "partial")])
def test_split_streams_match_jax(models, monkeypatch, kv_dtype, fault):
    for var in _FI:
        monkeypatch.delenv(var, raising=False)
    for var, val in _FAULTS[fault].items():
        monkeypatch.setenv(var, val)
    want = _split_run(_side(models, "jax"), fault, kv_dtype)
    got = _split_run(_side(models, "torch"), fault, kv_dtype)
    assert got == want
    streams, snap, pools = got
    assert all(s == "finished" and len(d) == 6
               for s, d, _ in streams.values()), streams
    assert all(v == (0, 0) for v in pools.values()), pools
    assert snap["active"] == 0
    if fault == "clean":
        assert snap["handoffs_ok"] == 3 and snap["handoffs_failed"] == 0
    else:
        assert snap["handoffs_failed"] >= 1 and snap["re_prefills"] >= 1

"""The port's int8 KV pools against the JAX package's on shared inputs:
the requantizing write path ``_requant_pages``, the int8 plain versions
of the paged kernels (K-DEC8's and K-MQ8's) against the Pallas kernels
in interpret mode and their XLA references, the scale pools' bytes and
validation, and the int8 serving engine on a tiny GPT with JAX weights
carried across; plus the query-dtype contract of int8 serving with a
bf16 model."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu.serving.kv_cache import _requant_pages as jax_requant
from paddle_tpu.serving.scheduler import ContinuousBatchingScheduler as JSched
from paddle_tpu.serving.scheduler import Request as JRequest
from paddle_tpu.serving.spec_decode import SpecDecodeConfig as JSpec
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      PagedKVCache, Request, ServingConfig,
                                      ServingEngine, SpecDecodeConfig)
from paddle_tpu_torch.serving.kv_cache import _requant_pages, _requant_plan
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

_CFG = dict(page_size=8, max_model_len=64, max_batch=4,
            max_prefill_tokens=128, num_pages=64)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- _requant_pages: the int8 write path --------------------------------------


def _case(name):
    """(pools, new values, slots, touched, touched_valid) of one write, as
    numpy: ``k``/``v`` pools (P, ps, hp) int8, scales (P, 2, nh_kv)."""
    rng = np.random.RandomState(len(name))
    if name == "fresh_page":            # fill page 1 of zero pools
        p, ps, nh, d = 4, 4, 2, 8
        kp = np.zeros((p, ps, nh * d), np.int8)
        sp = np.zeros((p, 2, nh), np.float32)
        new = rng.randn(2, 1, ps, nh, d).astype(np.float32)
        return (kp, kp, sp, new[0], new[1], np.arange(ps) + ps, [1], [0])
    if name == "stale_slots":           # a big stale tenant on page 2
        p, ps, nh, d = 3, 4, 1, 4
        kp = np.zeros((p, ps, nh * d), np.int8)
        kp[2] = 127
        sp = np.zeros((p, 2, nh), np.float32)
        sp[2] = 10.0
        new = np.full((1, 1, nh, d), 0.5, np.float32)
        return kp, kp, sp, new, new, [2 * ps], [2], [0]
    if name == "sentinels":             # slots past the pool, touched == P
        p, ps, nh, d = 3, 2, 1, 4
        kp = np.zeros((p, ps, nh * d), np.int8)
        sp = np.zeros((p, 2, nh), np.float32)
        new = np.ones((1, 2, nh, d), np.float32)
        return kp, kp, sp, new, new, [p * ps, p * ps + 1], [p], [0]
    # "mixed": live pages with valid prefixes, a verify-like window over
    # two pages, padding rows on garbage page 0 (touched twice), a slot
    # on a page outside the touched set and one past the pool, a sentinel
    p, ps, nh, d = 8, 4, 2, 8
    kp = rng.randint(-127, 128, (p, ps, nh * d)).astype(np.int8)
    vp = rng.randint(-127, 128, (p, ps, nh * d)).astype(np.int8)
    sp = rng.uniform(0.005, 0.05, (p, 2, nh)).astype(np.float32)
    slots = [3 * ps + 2, 3 * ps + 3, 5 * ps + 0, 5 * ps + 1,   # window
             6 * ps + 1,                                      # decode
             0, 1,                                            # padding
             7 * ps + 2,                                      # untouched
             p * ps + 3]                                      # past pool
    touched = [3, 5, 6, 0, 0, p]
    valid = [2, 0, 1, 0, 0, 0]
    new = rng.randn(2, 1, len(slots), nh, d).astype(np.float32) * 0.7
    return kp, vp, sp, new[0], new[1], slots, touched, valid


@pytest.mark.parametrize("name", ["fresh_page", "stale_slots", "sentinels",
                                  "mixed"])
def test_requant_pages_matches_jax(name):
    kp, vp, sp, k, v, slots, touched, valid = _case(name)
    slots = np.asarray(slots, np.int32)
    touched = np.asarray(touched, np.int32)
    valid = np.asarray(valid, np.int32)
    want = [np.asarray(x) for x in jax_requant(
        *(jnp.asarray(x) for x in (kp, vp, sp, k, v, slots, touched,
                                   valid)))]
    # the port's stores carry one drop page past the pool
    def store(x):
        return torch.cat([_t(x), torch.zeros_like(_t(x[:1]))]).contiguous()

    stores = [store(kp), store(vp), store(sp)]
    p, ps = kp.shape[:2]
    plan = _requant_plan(_t(slots.astype(np.int64)),
                         _t(touched.astype(np.int64)), _t(valid), p, ps)
    _requant_pages(*stores, _t(k), _t(v), plan)
    # garbage page 0 is written twice in "mixed": its content is never
    # read unmasked, so only the real pages are held to JAX's
    live = slice(1 if name == "mixed" else 0, p)
    for got, ref in zip(stores[:2], want[:2]):
        diff = np.abs(got[:p].numpy().astype(np.int32) - ref.astype(np.int32))
        assert diff[live].max() <= 1           # int8 codes within one step
    np.testing.assert_allclose(stores[2][:p].numpy()[live], want[2][live],
                               rtol=1e-6, atol=0)
    if name == "stale_slots":   # the new scale sees only the new token
        assert stores[2][2, 0, 0] == pytest.approx(0.5 / 127.0)
    if name == "sentinels":     # nothing lands in the pool
        assert not stores[0][:p].any() and not stores[2][:p].any()
    if name == "mixed":         # the untouched page 7 keeps its bytes
        assert np.array_equal(stores[0][7].numpy(), kp[7])
        assert np.array_equal(stores[2][7].numpy(), sp[7])


# -- the int8 plain versions of K-DEC8 and K-MQ8 ------------------------------


def _int8_pools(rng, b, ps, nh_kv, d, ctx, n_pages=12):
    ki = rng.randint(-127, 128, (n_pages, ps, nh_kv * d)).astype(np.int8)
    vi = rng.randint(-127, 128, (n_pages, ps, nh_kv * d)).astype(np.int8)
    sc = rng.uniform(0.005, 0.05, (n_pages, 2, nh_kv)).astype(np.float32)
    maxp = -(-max(ctx) // ps)
    pt = np.stack([rng.permutation(np.arange(1, n_pages))[:maxp]
                   for _ in range(b)]).astype(np.int32)
    return ki, vi, sc, pt, np.asarray(ctx, np.int32)


@pytest.mark.parametrize("qlen", [None, 3])
@pytest.mark.parametrize("nh,nh_kv", [(4, 4), (4, 2), (4, 1)])
def test_int8_refs_match_jax(qlen, nh, nh_kv):
    rng = np.random.RandomState(nh_kv + (qlen or 0))
    ki, vi, sc, pt, lens = _int8_pools(rng, 4, 8, nh_kv, 16,
                                       [9, 0, 21, 2])
    shape = (4, nh, 16) if qlen is None else (4, qlen, nh, 16)
    q = rng.randn(*shape).astype(np.float32)
    args = [jnp.asarray(x) for x in (q, ki, vi, pt, lens)]
    jsc = jnp.asarray(sc)
    if qlen is None:
        want = [jpa.paged_decode_attention(*args, scales=jsc,
                                           interpret=True),
                jpa.paged_attention_xla(*args, scales=jsc)]
        ours = (pa.paged_attention_ref, pa.paged_decode_attention)
    else:
        want = [jpa.paged_multiquery_attention(*args, scales=jsc,
                                               interpret=True),
                jpa.paged_multiquery_attention_xla(*args, scales=jsc)]
        ours = (pa.paged_multiquery_attention_ref,
                pa.paged_multiquery_attention)
    K.reset_launch_counts()
    targs = [_t(x) for x in (q, ki, vi, pt, lens)]
    for fn in ours:
        got = fn(*targs, scales=_t(sc)).numpy()
        assert got.shape == q.shape and got.dtype == np.float32
        for w in want:
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        assert np.all(got[1] == 0.0)    # seq_len 0 padding row
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def test_int8_scales_operand_validated():
    rng = np.random.RandomState(3)
    ki, vi, sc, pt, lens = _int8_pools(rng, 1, 8, 2, 8, [5], n_pages=4)
    q = _t(rng.randn(1, 4, 8).astype(np.float32))
    fp = _t(ki.astype(np.float32))
    with pytest.raises(ValueError, match="int8"):
        pa.paged_attention_ref(q, fp, fp, _t(pt), _t(lens), scales=_t(sc))
    with pytest.raises(ValueError, match="scales"):
        pa.paged_multiquery_attention_ref(
            q[:, None].repeat(1, 2, 1, 1), _t(ki), _t(vi), _t(pt), _t(lens),
            scales=_t(sc[:, :1]))


def test_kv_cache_scale_pools_bytes_and_drop_page():
    kv = PagedKVCache(num_layers=2, num_pages=8, page_size=4,
                      num_kv_heads=2, head_dim=8, device="cpu",
                      kv_dtype="int8")
    assert kv.dtype == torch.int8 and len(kv.s_pools) == 2
    assert kv.k_pools[0].dtype == torch.int8
    assert tuple(kv.s_pools[0].shape) == (8, 2, 2)
    assert kv.scale_pool_bytes() == 2 * 8 * 2 * 2 * 4
    assert kv.pool_bytes() == 2 * 2 * 8 * 4 * 2 * 8 + kv.scale_pool_bytes()
    # the stores carry one drop page past the pools, views of the same
    # storage
    assert tuple(kv.k_stores[0].shape) == (9, 4, 16)
    assert tuple(kv.s_stores[0].shape) == (9, 2, 2)
    assert kv.k_pools[0].data_ptr() == kv.k_stores[0].data_ptr()
    fp = PagedKVCache(num_layers=2, num_pages=8, page_size=4,
                      num_kv_heads=2, head_dim=8, device="cpu")
    assert fp.s_pools is None and fp.scale_pool_bytes() == 0
    assert fp.pool_bytes() == 2 * 2 * 8 * 4 * 2 * 8 * 4
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCache(num_layers=1, num_pages=4, page_size=4,
                     num_kv_heads=1, head_dim=8, kv_dtype="fp8")


# -- the int8 engine ----------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JM.GPTForCausalLM(JM.gpt_tiny(hidden_dropout=0.0,
                                       attention_dropout=0.0))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TM.gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    tm = TM.GPTForCausalLM(cfg, device="cpu").eval()
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    return jm, tm


def test_int8_engine_steps_match_jax(models):
    """A packed prefill, two decode steps and a verify window on int8
    pools: logits within 1e-4 of the JAX int8 engine's, and the pools'
    codes within one step and their scales within 1e-6 relative."""
    jm, tm = models
    rng = np.random.RandomState(4)
    seqs = [rng.randint(0, 1024, n).astype(np.int32) for n in (13, 30, 7)]
    jeng = JEngine(jm, JConfig(**_CFG, kv_dtype="int8"))
    teng = ServingEngine(tm, ServingConfig(**_CFG, kv_dtype="int8"))
    pages = [jeng.pool.allocate(-(-(len(s) + 7) // 8)) for s in seqs]
    assert pages == [teng.pool.allocate(len(p)) for p in pages]
    pt = np.zeros((3, jeng.max_pages_per_seq), np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    lens = np.asarray([len(s) for s in seqs], np.int32)
    want = jeng.prefill_packed(seqs, pages)
    np.testing.assert_allclose(teng.prefill_packed(seqs, pages), want,
                               rtol=0, atol=1e-4)
    for _ in range(2):
        nxt = np.argmax(want, -1).astype(np.int32)
        want = jeng.decode(nxt, pt, lens)
        np.testing.assert_allclose(teng.decode(nxt, pt, lens), want,
                                   rtol=0, atol=1e-4)
        lens = lens + 1
    win = rng.randint(0, 1024, (3, 5)).astype(np.int32)
    np.testing.assert_allclose(teng.verify(win, pt, lens),
                               jeng.verify(win, pt, lens), rtol=0,
                               atol=1e-4)
    used = sorted(p for pg in pages for p in pg)
    for layer in range(tm.cfg.num_layers):
        for ours, theirs in ((teng.kv.k_pools, jeng.kv.k_pools),
                             (teng.kv.v_pools, jeng.kv.v_pools)):
            a = ours[layer][used].numpy().astype(np.int32)
            b = np.asarray(theirs[layer])[used].astype(np.int32)
            assert np.abs(a - b).max() <= 1
        np.testing.assert_allclose(teng.kv.s_pools[layer][used].numpy(),
                                   np.asarray(jeng.kv.s_pools[layer])[used],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("spec", [False, True])
def test_int8_scheduler_streams_match_jax(models, spec):
    jm, tm = models
    rng = np.random.RandomState(3)
    protos = []
    for _ in range(4):
        phrase = rng.randint(0, 1024, rng.randint(3, 6))
        protos.append((np.tile(phrase, rng.randint(2, 5)).astype(np.int32),
                       int(rng.randint(4, 12))))
    out = []
    for eng_cls, cfg_cls, sched_cls, req_cls, model, sp in (
            (JEngine, JConfig, JSched, JRequest, jm, JSpec(k=4)),
            (ServingEngine, ServingConfig, ContinuousBatchingScheduler,
             Request, tm, SpecDecodeConfig(k=4))):
        eng = eng_cls(model, cfg_cls(**_CFG, kv_dtype="int8"))
        sched = sched_cls(eng, spec_decode=sp if spec else None)
        for i, (p, n) in enumerate(protos):
            sched.submit(req_cls(rid=i, prompt=p, max_new_tokens=n))
        sched.run()
        assert eng.pool.in_use == 0
        out.append({r.rid: (list(r.generated), r.spec_accepted)
                    for r in sched.finished})
    assert out[1] == out[0]
    assert all(len(g) == n for (g, _), (_, n) in zip(
        (out[1][i] for i in range(4)), protos))


def test_engine_rejects_an_unknown_kv_dtype(models):
    _, tm = models
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(tm, ServingConfig(**_CFG, kv_dtype="fp8"))


def test_int8_pools_keep_a_bf16_query(models, monkeypatch):
    """int8 serving of a bf16 model: decode and verify hand the kernels a
    bf16 query (never one cast to the pools' int8) and get bf16 back; the
    logits track the same model served from bf16 pools."""
    _, tm = models
    model = TM.GPTForCausalLM(tm.cfg, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(tm.state_dict())
    model.eval()
    seen = []
    for fn in ("paged_decode_attention", "paged_multiquery_attention"):
        orig = getattr(pa, fn)

        def spy(q, kp, *a, _orig=orig, _fn=fn, **kw):
            out = _orig(q, kp, *a, **kw)
            seen.append((_fn, q.dtype, kp.dtype, out.dtype))
            return out

        monkeypatch.setattr(pa, fn, spy)
    phrase = np.tile(np.arange(6, dtype=np.int32) * 7, 4)
    logits = {}
    for kv in ("int8", "fp32"):
        eng = ServingEngine(model, ServingConfig(**_CFG, kv_dtype=kv))
        pages = [eng.pool.allocate(5)]
        pt = np.zeros((1, eng.max_pages_per_seq), np.int32)
        pt[0, :5] = pages[0]
        first = eng.prefill_packed([phrase], pages)
        nxt = np.argmax(first, -1).astype(np.int32)
        dec = eng.decode(nxt, pt, np.asarray([24], np.int32))
        win = np.asarray([[int(np.argmax(dec)), 0, 7, 14]], np.int32)
        ver = eng.verify(win, pt, np.asarray([25], np.int32))
        logits[kv] = np.concatenate([dec, ver[0]])
    int8_calls = [c for c in seen if c[2] == torch.int8]
    assert {c[0] for c in int8_calls} == {"paged_decode_attention",
                                          "paged_multiquery_attention"}
    assert all(c[1] == c[3] == torch.bfloat16 for c in int8_calls), seen
    assert np.isfinite(logits["int8"]).all()
    scale = np.abs(logits["fp32"]).max()
    assert np.abs(logits["int8"] - logits["fp32"]).max() <= 0.05 * scale
    # and a scheduler run, plain and speculative, completes on int8 pools
    for spec in (None, SpecDecodeConfig(k=4)):
        eng = ServingEngine(model, ServingConfig(**_CFG, kv_dtype="int8"))
        sched = ContinuousBatchingScheduler(eng, spec_decode=spec)
        sched.submit(Request(rid=0, prompt=phrase, max_new_tokens=10))
        sched.run()
        assert sched.finished[0].status == "finished"
        assert eng.pool.in_use == 0

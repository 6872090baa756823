"""The port's LLaMA model and its serving path against the JAX package's
on a tiny LLaMA with shared weights (``from_llama_state``): rotary
embedding and RMSNorm, the no-cache forward (GQA and MHA), the
continuous-batching scheduler's greedy tokens with and without
evictions, one packed prefill and decode step, speculative decoding
(k=4) and int8 pools. ``llama_tiny`` has 4 heads over 2 kv heads (g = 2)
at head dim 32; its MHA variant has 4 kv heads. Logits are held within
1e-4 (fp32), tokens exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as JL
from paddle_tpu.nn import functional as JF
from paddle_tpu.serving.engine import ServingConfig as JConfig
from paddle_tpu.serving.engine import ServingEngine as JEngine
from paddle_tpu.serving.scheduler import ContinuousBatchingScheduler as JSched
from paddle_tpu.serving.scheduler import Request as JRequest
from paddle_tpu.serving.spec_decode import SpecDecodeConfig as JSpec
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler, Request,
                                      ServingConfig, ServingEngine,
                                      SpecDecodeConfig)
from paddle_tpu_torch.utils.convert import (expected_llama_leaves,
                                            from_llama_state)

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

_CFG = dict(page_size=8, max_model_len=64, max_batch=8,
            max_prefill_tokens=128)


def _pair(kv_heads):
    paddle.seed(0)
    jcfg = JL.llama_tiny()
    jcfg.num_kv_heads = kv_heads
    jm = JL.LlamaForCausalLM(jcfg)
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = dataclasses.replace(TL.llama_tiny(), num_kv_heads=kv_heads)
    tm = TL.LlamaForCausalLM(cfg, device="cpu").eval()
    tm.load_state_dict(from_llama_state(state, cfg))
    return jm, tm, state


@pytest.fixture(scope="module")
def gqa():
    return _pair(2)


@pytest.fixture(scope="module")
def mha():
    return _pair(None)


@pytest.mark.parametrize("shift", [0, 37])
def test_rope_matches_jax(shift):
    rng = np.random.RandomState(shift)
    q = rng.randn(2, 9, 4, 32).astype(np.float32)
    k = rng.randn(2, 9, 2, 32).astype(np.float32)
    pos = (np.arange(9)[None] + np.array([[shift], [3 * shift + 1]])
           ).astype(np.int32)
    want = JL._rope(jnp.asarray(q), jnp.asarray(pos), 10000.0)
    got = TL._rope(torch.from_numpy(q), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    jq, jk = JL.apply_rotary_pos_emb(paddle.to_tensor(q), paddle.to_tensor(k),
                                     paddle.to_tensor(pos))
    tq, tk = TL.apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(pos))
    np.testing.assert_allclose(tq.numpy(), jq.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), jk.numpy(), rtol=0, atol=1e-5)
    # interleaved pairs: a rotation by position 0 is the identity, and the
    # pair (x[2i], x[2i+1]) keeps its norm
    np.testing.assert_allclose(
        TL._rope(torch.from_numpy(q), torch.zeros(2, 9), 1e4).numpy(), q,
        atol=1e-6)
    n = np.hypot(tq.numpy()[..., 0::2], tq.numpy()[..., 1::2])
    np.testing.assert_allclose(n, np.hypot(q[..., 0::2], q[..., 1::2]),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 64).astype(np.float32) * 3
    w = rng.randn(64).astype(np.float32)
    jx = paddle.to_tensor(x).astype(dtype)
    want = JF.rms_norm(jx, paddle.to_tensor(w), 1e-6).astype("float32")
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TL.rms_norm(tx, torch.from_numpy(w), 1e-6).float()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=tol * np.abs(want.numpy()).max())
    mod = TL.RMSNorm(64)
    assert torch.equal(mod.weight, torch.ones(64))


@pytest.mark.parametrize("which", ["gqa", "mha"])
def test_no_cache_forward_matches_jax(which, request):
    jm, tm, _ = request.getfixturevalue(which)
    ids = np.random.RandomState(2).randint(0, 1024, (2, 40)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert tm.model.layers[0].self_attn.k_proj.weight.shape == (
        tm.cfg.kv_heads * 32, 128)


def test_from_llama_state_round_trip_and_errors(gqa):
    jm, tm, state = gqa
    cfg = tm.cfg
    got = tm.state_dict()
    assert set(got) == set(state) == set(expected_llama_leaves(cfg))
    for name, arr in state.items():
        back = got[name].numpy()
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            back = back.T      # Paddle's (in, out) against torch's (out, in)
        np.testing.assert_array_equal(back, arr, err_msg=name)
    with pytest.raises(KeyError, match="unknown"):
        from_llama_state(dict(state, extra=np.zeros(3, np.float32)), cfg)
    short = {k: v for k, v in state.items() if k != "lm_head.weight"}
    with pytest.raises(KeyError, match="missing"):
        from_llama_state(short, cfg)
    bad = dict(state)
    bad["model.norm.weight"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="model.norm.weight"):
        from_llama_state(bad, cfg)


def _serve(eng, sched, req_cls, protos):
    for i, (p, n) in enumerate(protos):
        sched.submit(req_cls(rid=i, prompt=p, max_new_tokens=n))
    sched.run()
    assert eng.pool.in_use == 0, "leaked pages after completion"
    return sched


def _both(models, protos, num_pages=None, spec=None, **serving):
    jm, tm, _ = models
    cfg = dict(_CFG, num_pages=num_pages, **serving)
    jeng = JEngine(jm, JConfig(**cfg))
    teng = ServingEngine(tm, ServingConfig(**cfg))
    assert teng.num_kv_heads == tm.cfg.kv_heads == jeng.num_kv_heads
    js = _serve(jeng, JSched(jeng, spec_decode=spec and JSpec(k=spec)),
                JRequest, protos)
    ts = _serve(teng, ContinuousBatchingScheduler(
        teng, spec_decode=spec and SpecDecodeConfig(k=spec)), Request, protos)
    return js, ts


def _streams(s):
    return {r.rid: (list(r.generated), r.spec_accepted, r.status)
            for r in s.finished}


def _protos(vocab, repetitious=False):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(6):
        if repetitious:
            p = np.tile(rng.randint(0, vocab, rng.randint(3, 6)),
                        rng.randint(3, 5))
        else:
            p = rng.randint(0, vocab, rng.randint(8, 24))
        out.append((p.astype(np.int32), int(rng.randint(6, 18))))
    return out


@pytest.mark.parametrize("num_pages", [200, 14])  # 14: forces evictions
def test_scheduler_tokens_match_jax(gqa, num_pages):
    js, ts = _both(gqa, _protos(1024), num_pages)
    assert _streams(ts) == _streams(js)
    assert all(r.status == "finished" for r in ts.finished)
    pre = sum(r.preemptions for r in ts.finished)
    assert pre == sum(r.preemptions for r in js.finished)
    if num_pages == 14:
        assert pre > 0, "tight pool never evicted: the case is vacuous"


@pytest.mark.parametrize("which", ["gqa", "mha"])
def test_prefill_packed_and_decode_logits_match_jax(which, request):
    jm, tm, _ = request.getfixturevalue(which)
    rng = np.random.RandomState(2)
    seqs = [rng.randint(0, 1024, n).astype(np.int32) for n in (13, 30, 7)]
    jeng = JEngine(jm, JConfig(**_CFG))
    teng = ServingEngine(tm, ServingConfig(**_CFG))
    ps = _CFG["page_size"]
    pages = [jeng.pool.allocate(-(-(len(s) + 1) // ps)) for s in seqs]
    assert pages == [teng.pool.allocate(-(-(len(s) + 1) // ps))
                     for s in seqs]
    want = jeng.prefill_packed(seqs, pages)
    np.testing.assert_allclose(teng.prefill_packed(seqs, pages), want,
                               rtol=0, atol=1e-4)
    # one teacher-forced decode step at each request's next position
    nxt = np.argmax(want, -1).astype(np.int32)
    pt = np.zeros((3, jeng.max_pages_per_seq), np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    lens = np.asarray([len(s) for s in seqs], np.int32)
    np.testing.assert_allclose(teng.decode(nxt, pt, lens),
                               jeng.decode(nxt, pt, lens), rtol=0, atol=1e-4)


def test_speculative_tokens_match_jax(gqa):
    js, ts = _both(gqa, _protos(1024, repetitious=True), spec=4)
    assert _streams(ts) == _streams(js)
    assert ts.verify_ticks, "speculation never engaged"


def test_int8_pool_tokens_match_jax(gqa):
    js, ts = _both(gqa, _protos(1024), kv_dtype="int8")
    assert _streams(ts) == _streams(js)
    assert ts.engine.kv.s_pools[0].shape[-1] == 2     # scales per kv head

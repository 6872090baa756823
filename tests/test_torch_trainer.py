"""The port's training step against the JAX package's, on the CPU: the
functional GPT core (``gpt_loss`` and its grads) with the JAX
``gpt_init`` params carried over by ``from_gpt_params``, AdamW, and the
single-device ``HybridParallelTrainer`` with its anomaly guard, on the
same numpy batches. fp32 tolerances: loss and grads atol 1e-5, params
after 3 steps 2e-5; bf16 loss atol 2e-2 (bf16 rounds at other places in
the two frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.parallel import hybrid as jhybrid
from paddle_tpu.parallel import transformer_core as jcore
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.parallel import transformer_core as tcore
from paddle_tpu_torch.utils.convert import (expected_gpt_params,
                                            from_gpt_params)
from paddle_tpu_torch.utils.tree import flatten

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

B, S = 2, 64


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_gpt_tiny()
    return jax.device_get(jcore.gpt_init(cfg, jax.random.PRNGKey(0)))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    v = gpt_tiny().vocab_size
    return (rng.randint(0, v, (B, S)).astype(np.int32),
            rng.randint(0, v, (B, S)).astype(np.int32))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, sub in tree.items():
            out.update(_leaves(sub, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _port_loss_and_grads(params, tok, lab, dtype, remat):
    cfg = gpt_tiny()
    leaves = _leaves(params)
    req = {k: torch.from_numpy(np.array(v)).requires_grad_()
           for k, v in leaves.items()}
    tree = {"blocks": {}}
    for k, t in req.items():
        if k.startswith("blocks/"):
            tree["blocks"][k[7:]] = t
        else:
            tree[k] = t
    loss = tcore.gpt_loss(cfg, tree, torch.from_numpy(tok).long(),
                          torch.from_numpy(lab).long(), compute_dtype=dtype,
                          remat=remat)
    grads = torch.autograd.grad(loss, list(req.values()))
    return float(loss.detach()), dict(zip(req, (g.numpy() for g in grads)))


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_params):
    tok, lab = _batch()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jcore.gpt_loss(jax_gpt_tiny(), p, jnp.asarray(tok),
                                 jnp.asarray(lab), compute_dtype=jnp.float32,
                                 remat=False)))(jax_params)
    return float(loss), _leaves(jax.device_get(grads))


@pytest.mark.parametrize("remat", [True, False])
def test_gpt_loss_and_grads_match_jax_fp32(jax_params, jax_loss_and_grads,
                                           remat):
    tok, lab = _batch()
    want_loss, want = jax_loss_and_grads
    params = from_gpt_params(jax_params, gpt_tiny())
    loss, grads = _port_loss_and_grads(params, tok, lab, torch.float32,
                                       remat)
    assert abs(loss - want_loss) <= 1e-5, (loss, want_loss)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_gpt_loss_matches_jax_bf16(jax_params):
    tok, lab = _batch(1)
    want = jcore.gpt_loss(jax_gpt_tiny(), jax_params, jnp.asarray(tok),
                          jnp.asarray(lab), compute_dtype=jnp.bfloat16)
    loss, grads = _port_loss_and_grads(
        from_gpt_params(jax_params, gpt_tiny()), tok, lab, torch.bfloat16,
        True)
    assert abs(loss - float(want)) <= 2e-2, (loss, float(want))
    assert all(np.isfinite(g).all() for g in grads.values())


def test_logits_forward_matches_jax(jax_params):
    tok, _ = _batch(2)
    want = np.asarray(jcore.gpt_forward(jax_gpt_tiny(), jax_params,
                                        jnp.asarray(tok),
                                        compute_dtype=jnp.float32))
    params = from_gpt_params(jax_params, gpt_tiny())
    with torch.no_grad():
        got = tcore.gpt_forward(gpt_tiny(), params,
                                torch.from_numpy(tok).long(),
                                compute_dtype=torch.float32).numpy()
        xent = tcore.softmax_xent(torch.from_numpy(got),
                                  torch.from_numpy(tok))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert abs(float(xent) - float(jcore.softmax_xent(
        jnp.asarray(want), jnp.asarray(tok)))) <= 1e-5


def test_chunked_xent_ragged_chunks_keep_the_mean():
    rng = np.random.RandomState(3)
    h = rng.randn(2, 37, 16).astype(np.float32)
    w = rng.randn(16, 50).astype(np.float32)
    lab = rng.randint(0, 50, (2, 37)).astype(np.int32)
    want = float(jcore.chunked_xent_on(jnp.asarray(h), jnp.asarray(w),
                                       jnp.asarray(lab),
                                       compute_dtype=jnp.float32, chunk=16))
    for chunk in (16, 4096):
        got = float(tcore.chunked_xent_on(
            torch.from_numpy(h), torch.from_numpy(w),
            torch.from_numpy(lab), compute_dtype=torch.float32, chunk=chunk))
        assert abs(got - want) <= 1e-5, (chunk, got, want)


def test_adamw_update_decays_by_leaf_rank_as_jax():
    """Weight decay goes to every leaf with ndim >= 2: in the stacked
    layout that includes the (L, h) LayerNorm gains and biases; the
    (h,) final norm is not decayed. A (3, 4) and a (4,) leaf, with a
    strong decay and a zero-grad step, hold both sides of the rule."""
    rng = np.random.RandomState(4)
    shapes = {"w": (3, 4, 5), "ln_g": (3, 4), "lnf_g": (4,)}
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    cfgs = (jhybrid.TrainerConfig(learning_rate=1e-2, warmup_steps=2,
                                  weight_decay=0.5, grad_clip=0.3),
            thybrid.TrainerConfig(learning_rate=1e-2, warmup_steps=2,
                                  weight_decay=0.5, grad_clip=0.3))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jo, to = jhybrid.adamw_init(jp), thybrid.adamw_init(tp)
    for step in range(3):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        if step == 1:
            g = {k: np.zeros_like(v) for k, v in g.items()}  # decay only
        jp, jo, jn = jhybrid.adamw_update(cfgs[0], jp, {
            k: jnp.asarray(v) for k, v in g.items()}, jo)
        tp, to, tn = thybrid.adamw_update(cfgs[1], tp, {
            k: torch.from_numpy(v) for k, v in g.items()}, to)
        assert abs(float(tn) - float(jn)) <= 1e-5
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    assert int(to["step"]) == int(jo["step"]) == 3


def test_lr_schedule_matches_jax():
    jc = jhybrid.TrainerConfig(learning_rate=3e-4, warmup_steps=3,
                               total_steps=11)
    tc = thybrid.TrainerConfig(learning_rate=3e-4, warmup_steps=3,
                               total_steps=11)
    for step in range(14):
        want = float(jhybrid._lr_at(jc, jnp.float32(step)))
        got = float(thybrid._lr_at(tc, torch.tensor(float(step))))
        assert abs(got - want) <= 1e-10, (step, got, want)


# Adam's eps for the trainer comparisons. With the default 1e-8 the
# first step divides a grad of ~1e-9 by ~1e-8, so the ~1e-8 fp32
# rounding by which the two frameworks' grads differ moves such a param
# by up to lr * dg / eps (3.7e-5 on one qkv_w element of this batch).
# At 1e-5 that amplification is 1e3 times smaller and the params are
# held to 2e-5 everywhere.
EPS = 1e-5


def _trainers(jax_params, **kw):
    base = dict(compute_dtype=jnp.float32, learning_rate=1e-3,
                warmup_steps=2, eps=EPS)
    base.update(kw)
    jt = jhybrid.HybridParallelTrainer(
        jax_gpt_tiny(), jhybrid.TrainerConfig(telemetry=False,
                                              compile_ledger=False, **base),
        devices=jax.devices()[:1])
    base["compute_dtype"] = torch.float32
    tt = thybrid.HybridParallelTrainer(
        gpt_tiny(), thybrid.TrainerConfig(**base), device="cpu")
    tt.params = from_gpt_params(jax.device_get(jt.params), gpt_tiny())
    return jt, tt


def _max_param_diff(jt, tt):
    want = _leaves(jax.device_get(jt.params))
    got = {"/".join(path): t.numpy() for path, t in flatten(tt.params)}
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


@pytest.mark.parametrize("eps", [EPS, 1e-8])
def test_trainer_three_steps_match_jax(jax_params, monkeypatch, eps):
    monkeypatch.delenv("PADDLE_FI_NAN_AT_STEP", raising=False)
    jt, tt = _trainers(jax_params, eps=eps)
    tok, lab = _batch(5)
    for _ in range(3):
        want, got = float(jt.step(tok, lab)), float(tt.step(tok, lab))
        assert abs(got - want) <= 1e-5, (got, want)
    if eps == EPS:       # see EPS for why the default eps is not held here
        assert _max_param_diff(jt, tt) <= 2e-5
    assert int(tt.opt["step"]) == int(jt.opt["step"]) == 3
    assert tt.anomaly_state() == jt.anomaly_state()
    assert tt.num_params() == jt.num_params()


def test_guard_skips_a_poisoned_step_as_jax(jax_params, monkeypatch):
    monkeypatch.setenv("PADDLE_FI_NAN_AT_STEP", "2")
    jt, tt = _trainers(jax_params)
    tok, lab = _batch(6)
    jt.step(tok, lab), tt.step(tok, lab)
    before = {k: v.clone() for k, v in flatten({"p": tt.params,
                                                "o": tt.opt})}
    jt.step(tok, lab), tt.step(tok, lab)               # step 2: NaN
    after = dict(flatten({"p": tt.params, "o": tt.opt}))
    assert all(torch.equal(before[k], after[k]) for k in before)
    for side in (jt, tt):
        st = side.anomaly_state()
        assert st["skips_total"] == 1 and st["last_skipped"]
    assert int(tt.guard["skips_total"]) == int(jt.guard["skips_total"]) == 1
    want, got = float(jt.step(tok, lab)), float(tt.step(tok, lab))
    assert abs(got - want) <= 1e-5 and np.isfinite(got)
    assert _max_param_diff(jt, tt) <= 2e-5


def test_divergence_abort_raises_as_jax(jax_params, monkeypatch):
    monkeypatch.setenv("PADDLE_FI_NAN_AT_STEP", "1+")
    jt, tt = _trainers(jax_params, max_consecutive_skips=2)
    tok, lab = _batch(7)
    raised_at = []
    for side, err in ((jt, jhybrid.NumericalDivergenceError),
                      (tt, thybrid.NumericalDivergenceError)):
        with pytest.raises(err, match="NOT rolled back") as info:
            for _ in range(5):
                side.step(tok, lab)
        assert info.value.rolled_back_to is None
        raised_at.append(side.global_step)
    assert raised_at[0] == raised_at[1] == 3   # lag-1 read of step 2


def test_from_gpt_params_rejects_unknown_missing_and_misshapen(jax_params):
    cfg = gpt_tiny()
    got = from_gpt_params(jax_params, cfg)
    assert set(_leaves(got)) == set(_leaves(expected_gpt_params(cfg)))
    for name, arr in _leaves(got).items():
        np.testing.assert_array_equal(np.asarray(arr),
                                      _leaves(jax_params)[name])
    extra = dict(jax_params, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="unknown"):
        from_gpt_params(extra, cfg)
    short = dict(jax_params)
    short["blocks"] = {k: v for k, v in jax_params["blocks"].items()
                       if k != "fc_out_b"}
    with pytest.raises(KeyError, match="missing"):
        from_gpt_params(short, cfg)
    bad = dict(jax_params, lnf_g=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="lnf_g"):
        from_gpt_params(bad, cfg)


@pytest.mark.parametrize("kw", [
    {"sep": 2, "ring_attention": False},
    {"pp": 2, "sep": 2, "ring_attention": False},
    {"mp": 2, "sep": 2, "ring_attention": False}])
def test_trainer_rejects_what_is_not_ported(kw):
    """sep > 1 without the ring (in a pipeline stage, beside tensor
    parallelism), which raised ``NotImplementedError`` until the naive
    ring took it, now builds (on the last rank of a mesh that needs no
    world to build): its batches cut in contiguous shards, not in the
    zigzag order the zigzag ring takes, and its attention the naive ring
    (dp, pp, sharding, mp and sep with and without the ring
    train against the JAX trainer in ``tests/test_torch_hybrid.py``,
    ``tests/test_torch_pipeline.py`` and
    ``tests/test_torch_mesh_packed.py``)."""
    from paddle_tpu_torch.distributed.mesh import AXES, Mesh

    sizes = dict.fromkeys(AXES, 1)
    sizes.update(pipe=kw.get("pp", 1), sep=2, model=kw.get("mp", 1))
    world = sizes["pipe"] * 2 * sizes["model"]
    tok = np.arange(64)[None]
    for ring in (False, True):
        mesh = Mesh(sizes, world - 1, "gloo", torch.device("cpu"), {})
        t = thybrid.HybridParallelTrainer(
            gpt_tiny(), thybrid.TrainerConfig(**{**kw, "ring_attention":
                                                 ring}),
            device="cpu", mesh=mesh)
        got, _ = t.shard_batch(tok, tok)
        if ring:
            assert t._ring_for(got) == (mesh, "sep", "zigzag")
            assert got.tolist() == [list(range(16, 48))]
        else:
            assert t._ring_for(got) == (mesh, "sep")
            assert got.tolist() == [list(range(32, 64))]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_param_shapes_equal_the_inits(family):
    """``param_shapes`` (the layout's and the memory plan's shapes,
    without running an init) holds the init's tree, leaf for leaf."""
    from paddle_tpu_torch.models.llama import llama_tiny
    from paddle_tpu_torch.utils.tree import flatten

    cfg = gpt_tiny() if family == "gpt" else llama_tiny()
    init = thybrid._arch_for(cfg)[0](cfg, torch.Generator().manual_seed(0))
    got = [(p, tuple(x.shape), x.dtype, x.device.type)
           for p, x in flatten(thybrid.param_shapes(cfg))]
    assert got == [(p, tuple(x.shape), x.dtype, "meta")
                   for p, x in flatten(init)]


def test_vpp_without_pp_trains_as_pp_1():
    """``vpp=2`` at ``pp == 1`` is not pipelined (the JAX trainer only
    pipelines ``pp > 1``): one rank, the plain trainer's step bit for
    bit."""
    sides = []
    for kw in ({"vpp": 2}, {}):
        t = thybrid.HybridParallelTrainer(
            gpt_tiny(), thybrid.TrainerConfig(compute_dtype=torch.float32,
                                              **kw), device="cpu")
        assert t.mesh is None
        sides.append((float(t.step(*_batch())), t.params))
    assert sides[0][0] == sides[1][0]
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(sides[0][1]), flatten(sides[1][1])))


@pytest.mark.parametrize("kw", [{"dp": 2}, {"mp": 2}, {"sep": 2},
                                {"pp": 2}])
def test_trainer_over_a_mesh_needs_a_world(kw):
    """A mesh axis above 1 builds a mesh over the initialised
    torch.distributed world; without one the trainer says how to make
    it."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        thybrid.HybridParallelTrainer(gpt_tiny(), thybrid.TrainerConfig(**kw),
                                      device="cpu")


def test_trainer_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    t = thybrid.HybridParallelTrainer(gpt_tiny(), thybrid.TrainerConfig(),
                                      device="cpu")
    assert t.params["wte"].device.type == "cpu"
    t.step(*_batch())
    root = str(tmp_path / "ckpt")
    assert t.save_checkpoint(root, 1) == str(tmp_path / "ckpt" / "step-1")
    fresh = thybrid.HybridParallelTrainer(gpt_tiny(), thybrid.TrainerConfig(),
                                          device="cpu")
    assert fresh.load_checkpoint(root) == 1 and fresh.global_step == 1
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten({"p": t.params, "o": t.opt}),
                   flatten({"p": fresh.params, "o": fresh.opt})))
    with pytest.raises(ValueError, match="packed_sequences"):
        t.step(*_batch(), segment_ids=np.zeros((B, S), np.int32))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thybrid.HybridParallelTrainer(gpt_tiny(), thybrid.TrainerConfig())

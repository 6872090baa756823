"""The port's LLaMA training against the JAX package's on the CPU: the
functional core (``llama_init``, ``llama_loss`` and its grads) with the
JAX ``llama_init`` params carried over by ``from_llama_params``, the
single-device ``HybridParallelTrainer`` over a ``LlamaConfig``, and the
nn model's grads through ``backward()``, on the same numpy batches, at
``llama_tiny`` (4 heads over 2 kv heads, head dim 32). fp32 tolerances:
loss and grads atol 1e-5, params after 3 steps 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import hybrid as jhybrid
from paddle_tpu.parallel import llama_core as jcore
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.parallel import llama_core as tcore
from paddle_tpu_torch.utils.convert import (expected_llama_params,
                                            from_llama_params,
                                            from_llama_state)
from paddle_tpu_torch.utils.tree import flatten, unflatten

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

B, S = 2, 48
ATOL = 1e-5
# Adam's eps for the trainer comparison, as tests/test_torch_trainer.py
# sets it: at 1e-8 the first step divides ~1e-9 grads by ~1e-8, which
# magnifies the frameworks' ~1e-8 grad rounding past the param tolerance
EPS = 1e-5


def _leaves(tree):
    return {"/".join(p): np.asarray(v) for p, v in flatten(tree)}


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jcore.llama_init(JL.llama_tiny(),
                                           jax.random.PRNGKey(0)))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (B, S)).astype(np.int32),
            rng.randint(0, 1024, (B, S)).astype(np.int32))


def test_llama_init_shapes_and_scales():
    cfg = dataclasses.replace(TL.llama_tiny(), num_layers=4)
    p = tcore.llama_init(cfg, torch.Generator().manual_seed(0))
    want = _leaves(expected_llama_params(cfg))
    got = _leaves(p)
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    assert got["blocks/k_w"].shape == (4, 128, 2 * 32)      # kv heads only
    for name in ("ln1_g", "ln2_g"):
        assert (got["blocks/" + name] == 1).all()
    assert (got["lnf_g"] == 1).all()
    for name in ("wte", "lm_w", "blocks/q_w", "blocks/gate_w"):
        assert abs(got[name].std() - 0.02) < 1e-3, name
    for name in ("blocks/o_w", "blocks/down_w"):          # 0.02 / sqrt(2L)
        assert abs(got[name].std() - 0.02 / np.sqrt(8)) < 5e-4, name
    # the JAX init draws the same shapes at the same scales
    j = _leaves(jax.device_get(jcore.llama_init(
        dataclasses.replace(JL.llama_tiny(), num_layers=4),
        jax.random.PRNGKey(0))))
    assert {k: v.shape for k, v in j.items()} == {
        k: v.shape for k, v in got.items()}
    assert abs(j["blocks/o_w"].std() - got["blocks/o_w"].std()) < 5e-4


def test_from_llama_params_round_trip_and_errors(jax_params):
    cfg = TL.llama_tiny()
    got = from_llama_params(jax_params, cfg)
    want = _leaves(jax_params)
    assert set(_leaves(got)) == set(want)
    for name, arr in _leaves(got).items():
        np.testing.assert_array_equal(arr, want[name], err_msg=name)
    with pytest.raises(KeyError, match="unknown"):
        from_llama_params(dict(jax_params, wpe=np.zeros(3, np.float32)), cfg)
    short = dict(jax_params)
    short["blocks"] = {k: v for k, v in jax_params["blocks"].items()
                       if k != "down_w"}
    with pytest.raises(KeyError, match="missing"):
        from_llama_params(short, cfg)
    with pytest.raises(ValueError, match="lm_w"):
        from_llama_params(dict(jax_params, lm_w=np.zeros((3, 4))), cfg)


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_params):
    tok, lab = _batch()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jcore.llama_loss(JL.llama_tiny(), p, jnp.asarray(tok),
                                   jnp.asarray(lab),
                                   compute_dtype=jnp.float32,
                                   remat=False)))(jax_params)
    return float(loss), _leaves(jax.device_get(grads))


@pytest.mark.parametrize("remat", [True, False])
def test_llama_loss_and_grads_match_jax(jax_params, jax_loss_and_grads,
                                        remat):
    tok, lab = _batch()
    want_loss, want = jax_loss_and_grads
    flat = flatten(from_llama_params(jax_params, TL.llama_tiny()))
    paths = [p for p, _ in flat]
    leaves = [t.requires_grad_() for _, t in flat]
    loss = tcore.llama_loss(TL.llama_tiny(), unflatten(zip(paths, leaves)),
                            torch.from_numpy(tok).long(),
                            torch.from_numpy(lab).long(),
                            compute_dtype=torch.float32, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    got_loss = float(loss.detach())
    assert abs(got_loss - want_loss) <= ATOL, (got_loss, want_loss)
    got = {"/".join(p): g.numpy() for p, g in zip(paths, grads)}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=ATOL,
                                   err_msg=name)
    assert np.abs(got["blocks/k_w"]).max() > 0     # through the GQA expand


def _trainers(**kw):
    base = dict(compute_dtype=jnp.float32, learning_rate=1e-3,
                warmup_steps=2, eps=EPS)
    base.update(kw)
    jt = jhybrid.HybridParallelTrainer(
        JL.llama_tiny(), jhybrid.TrainerConfig(telemetry=False,
                                               compile_ledger=False, **base),
        devices=jax.devices()[:1])
    base["compute_dtype"] = torch.float32
    tt = thybrid.HybridParallelTrainer(
        TL.llama_tiny(), thybrid.TrainerConfig(**base), device="cpu")
    tt.params = from_llama_params(jax.device_get(jt.params), TL.llama_tiny())
    return jt, tt


def test_trainer_three_steps_match_jax(monkeypatch):
    monkeypatch.delenv("PADDLE_FI_NAN_AT_STEP", raising=False)
    jt, tt = _trainers()
    assert tt.arch == "llama"
    tok, lab = _batch(5)
    for _ in range(3):
        want, got = float(jt.step(tok, lab)), float(tt.step(tok, lab))
        assert abs(got - want) <= ATOL, (got, want)
    want = _leaves(jax.device_get(jt.params))
    got = _leaves(tt.params)
    assert set(got) == set(want)
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 2e-5
    assert int(tt.opt["step"]) == int(jt.opt["step"]) == 3
    assert tt.anomaly_state() == jt.anomaly_state()
    assert tt.num_params() == jt.num_params()


def test_packed_llama_raises_in_both_packages():
    with pytest.raises(ValueError, match="packed_sequences"):
        jhybrid.HybridParallelTrainer(
            JL.llama_tiny(), jhybrid.TrainerConfig(packed_sequences=True,
                                                   telemetry=False),
            devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="packed_sequences"):
        thybrid.HybridParallelTrainer(
            TL.llama_tiny(), thybrid.TrainerConfig(packed_sequences=True),
            device="cpu")
    # packed rows cannot ride the ring either (sep > 1), in both packages
    with pytest.raises(ValueError, match="packed_sequences"):
        jhybrid.HybridParallelTrainer(
            JL.llama_tiny(), jhybrid.TrainerConfig(
                packed_sequences=True, sep=2, telemetry=False),
            devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="packed_sequences"):
        thybrid.HybridParallelTrainer(
            TL.llama_tiny(), thybrid.TrainerConfig(packed_sequences=True,
                                                   sep=2), device="cpu")


def test_nn_model_grads_match_jax_backward():
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    ids, lab = _batch(3)
    jloss = JM.GPTPretrainingCriterion()(jm(paddle.to_tensor(ids)),
                                         paddle.to_tensor(lab))
    jloss.backward()
    jgrads = {k: np.asarray(v.grad.numpy())
              for k, v in jm.state_dict().items()}

    cfg = TL.llama_tiny()
    port = TL.LlamaForCausalLM(cfg, device="cpu").train()
    port.load_state_dict(from_llama_state(state, cfg))
    loss = TM.GPTPretrainingCriterion()(port(torch.from_numpy(ids).long()),
                                        torch.from_numpy(lab))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    want = from_llama_state(jgrads, cfg)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    # k_proj and v_proj reach the loss only through the GQA repeat
    attn = port.model.layers[0].self_attn
    assert float(attn.k_proj.weight.grad.abs().max()) > 0
    assert float(attn.v_proj.weight.grad.abs().max()) > 0

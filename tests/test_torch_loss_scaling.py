"""The port trainer's dynamic loss scaling against the JAX trainer's on
the CPU (GPT tiny and LLaMA tiny, fp32): with ``loss_scaling=True``,
``scale_incr_every=2`` and NaNs injected by ``PADDLE_FI_NAN_AT_STEP``,
the loss scale and the guard's counters follow the JAX trainer's exactly
after every step (grown after two finite steps in a row, halved on a
skip, floored at 1.0), the losses agree within 1e-5 and the params after
the run within 2e-5; a scale of 2^127 overflows the grads, so both
packages skip that step where a trainer without loss scaling steps;
autograd's grads are the plain ones times the scale;
``grad_scaler_state_dict`` round-trips and matches the JAX trainer's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as JM
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import hybrid as jhybrid
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.utils.convert import from_gpt_params, from_llama_params
from paddle_tpu_torch.utils.tree import flatten

B, S = 2, 32
EPS = 1e-5      # Adam's eps, as tests/test_torch_trainer.py sets it
ARCHS = {"gpt": (JM.gpt_tiny, TM.gpt_tiny, from_gpt_params),
         "llama": (JL.llama_tiny, TL.llama_tiny, from_llama_params)}
GUARD = ("loss_scale", "good_steps", "skip_count", "skips_total")


def _trainers(arch, **kw):
    jcfg, tcfg, convert = ARCHS[arch]
    base = dict(compute_dtype=jnp.float32, learning_rate=1e-3,
                warmup_steps=2, eps=EPS, loss_scaling=True,
                scale_incr_every=2)
    base.update(kw)
    jt = jhybrid.HybridParallelTrainer(
        jcfg(), jhybrid.TrainerConfig(telemetry=False, compile_ledger=False,
                                      **base), devices=jax.devices()[:1])
    base["compute_dtype"] = torch.float32
    tt = thybrid.HybridParallelTrainer(tcfg(), thybrid.TrainerConfig(**base),
                                       device="cpu")
    tt.params = convert(jax.device_get(jt.params), tcfg())
    return jt, tt


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 1024, (B, S)).astype(np.int32),
             rng.randint(0, 1024, (B, S)).astype(np.int32))
            for _ in range(n)]


def _guard(t):
    return {k: float(np.asarray(t.guard[k])) for k in GUARD}


def _max_param_diff(jt, tt):
    want = {"/".join(p): np.asarray(v)
            for p, v in flatten(jax.device_get(jt.params))}
    got = {"/".join(p): v.numpy() for p, v in flatten(tt.params)}
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("nan_at", ["3", "2,3", "4"])
def test_scale_trajectory_and_counters_match_jax(monkeypatch, arch, nan_at):
    monkeypatch.setenv("PADDLE_FI_NAN_AT_STEP", nan_at)
    jt, tt = _trainers(arch)
    trajectory = []
    for tok, lab in _batches(7):
        want, got = float(jt.step(tok, lab)), float(tt.step(tok, lab))
        assert np.isnan(want) == np.isnan(got)
        if not np.isnan(want):
            assert abs(got - want) <= 1e-5, (got, want)
        assert _guard(tt) == _guard(jt)
        trajectory.append(_guard(tt)["loss_scale"])
    assert tt.anomaly_state() == jt.anomaly_state()
    assert _max_param_diff(jt, tt) <= 2e-5
    bad = {int(s) for s in nan_at.split(",")}
    assert trajectory[0] == 2.0 ** 15
    assert trajectory[max(bad) - 1] < trajectory[min(bad) - 2]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_scale_backs_off_to_its_floor_as_jax(monkeypatch, arch):
    monkeypatch.setenv("PADDLE_FI_NAN_AT_STEP", "1+")
    jt, tt = _trainers(arch, init_loss_scale=4.0, max_consecutive_skips=0)
    scales = []
    for tok, lab in _batches(4, 1):
        jt.step(tok, lab), tt.step(tok, lab)
        assert _guard(tt) == _guard(jt)
        scales.append(_guard(tt)["loss_scale"])
    assert scales == [2.0, 1.0, 1.0, 1.0]
    assert tt.anomaly_state()["skips_total"] == 4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_an_overflowing_scale_skips_the_step_as_jax(monkeypatch, arch):
    """The scale reaches the backward pass: at 2^127 the scaled grads
    overflow, so both packages skip step 1 and back the scale off (to
    2^27, by a ratio of 2^-100), while the same batch without loss
    scaling steps; the later steps agree with the JAX trainer's."""
    monkeypatch.delenv("PADDLE_FI_NAN_AT_STEP", raising=False)
    jt, tt = _trainers(arch, init_loss_scale=2.0 ** 127,
                       scale_decr_ratio=2.0 ** -100)
    batches = _batches(3, 5)
    tok, lab = batches[0]
    plain = thybrid.HybridParallelTrainer(
        ARCHS[arch][1](), thybrid.TrainerConfig(compute_dtype=torch.float32),
        device="cpu")
    plain.params = tt.params
    assert np.isfinite(float(plain.step(tok, lab)))
    assert plain.anomaly_state()["skips_total"] == 0
    start = {k: v.clone() for k, v in flatten(tt.params)}
    for i, (tok, lab) in enumerate(batches):
        want, got = float(jt.step(tok, lab)), float(tt.step(tok, lab))
        assert abs(got - want) <= 1e-5, (i, got, want)
        assert _guard(tt) == _guard(jt)
        if i == 0:
            assert _guard(tt)["skips_total"] == 1
            assert _guard(tt)["loss_scale"] == 2.0 ** 27
            assert all(torch.equal(v, start[k]) for k, v in flatten(tt.params))
    assert _guard(tt)["skips_total"] == 1
    assert _max_param_diff(jt, tt) <= 2e-5


def test_autograd_sees_the_scaled_grads(monkeypatch):
    """The grads autograd returns under loss scaling are the plain grads
    times the scale, exactly (a power of two); the trainer's are the
    plain ones."""
    seen = []
    grad = torch.autograd.grad

    def spy(*args, **kwargs):
        out = grad(*args, **kwargs)
        seen.append([g.clone() for g in out])
        return out

    t = thybrid.HybridParallelTrainer(
        TM.gpt_tiny(), thybrid.TrainerConfig(compute_dtype=torch.float32,
                                             loss_scaling=True),
        device="cpu")
    tok, lab = t.shard_batch(*_batches(1, 6)[0])
    scale = t.guard["loss_scale"]
    monkeypatch.setattr(torch.autograd, "grad", spy)
    _, plain = t.loss_and_grads(t.params, tok, lab)
    _, unscaled = t.loss_and_grads(t.params, tok, lab, scale=scale)
    assert float(scale) == 2.0 ** 15
    assert all(torch.equal(s, p * 2.0 ** 15)
               for s, p in zip(seen[1], seen[0]))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(unscaled), flatten(plain)))


def test_unscaled_grads_equal_the_plain_step(monkeypatch):
    """A power-of-two scale and its inverse are exact: with loss scaling
    on, every step's loss and the params equal, bitwise, a trainer's
    without it."""
    monkeypatch.delenv("PADDLE_FI_NAN_AT_STEP", raising=False)
    cfgs = [thybrid.TrainerConfig(compute_dtype=torch.float32,
                                  loss_scaling=on, scale_incr_every=2)
            for on in (True, False)]
    scaled, plain = (thybrid.HybridParallelTrainer(TM.gpt_tiny(), c,
                                                   device="cpu")
                     for c in cfgs)
    for tok, lab in _batches(3, 2):
        assert float(scaled.step(tok, lab)) == float(plain.step(tok, lab))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(scaled.params), flatten(plain.params)))
    assert float(scaled.guard["loss_scale"]) == 2.0 ** 16
    assert float(plain.guard["loss_scale"]) == 1.0


def test_grad_scaler_state_dict_round_trips_and_matches_jax(monkeypatch):
    monkeypatch.setenv("PADDLE_FI_NAN_AT_STEP", "2")
    jt, tt = _trainers("gpt", scale_incr_every=3)
    for tok, lab in _batches(4, 3):
        jt.step(tok, lab), tt.step(tok, lab)
    sd = tt.grad_scaler_state_dict()
    assert sd == jt.grad_scaler_state_dict()
    assert sd == {"scale": 2.0 ** 14, "incr_ratio": 2.0, "decr_ratio": 0.5,
                  "incr_count": 2, "decr_count": 0}
    fresh = thybrid.HybridParallelTrainer(
        TM.gpt_tiny(), thybrid.TrainerConfig(loss_scaling=True,
                                             scale_incr_every=3),
        device="cpu")
    fresh.load_grad_scaler_state_dict(sd)
    assert fresh.grad_scaler_state_dict() == sd
    assert fresh.anomaly["loss_scale"] == 2.0 ** 14
    assert fresh.guard["loss_scale"].dtype == torch.float32
    assert fresh.guard["good_steps"].dtype == torch.int32
    # one more finite step grows the adopted scale, as the JAX trainer's
    jt.load_grad_scaler_state_dict(sd)
    tok, lab = _batches(1, 4)[0]
    fresh.params = tt.params
    jt.step(tok, lab), fresh.step(tok, lab)
    assert fresh.grad_scaler_state_dict() == jt.grad_scaler_state_dict()
    assert fresh.grad_scaler_state_dict()["scale"] == 2.0 ** 15

"""Training through the nn API against the JAX package's, on the CPU, on
the same numpy inputs:

- the BSHD backward kernels' plain versions (K-BDQ, K-BDKV) against
  ``_flash_bwd_call`` in interpret mode, and ``FlashAttentionBSHD``'s
  grads against ``jax.grad`` of ``flash_attention_bshd(interpret=True)``
  (fp32, atol 1e-5);
- ``GPTForCausalLM`` -> ``GPTPretrainingCriterion`` -> ``backward()``:
  every parameter's ``.grad`` against the JAX model's ``loss.backward()``
  on weights carried across by ``from_paddle_tpu_state`` (atol 1e-5),
  and the ``qkv_proj`` gradient flows through ``FlashAttentionBSHD``;
- ``GPTForCausalLM`` in training at attention dropout 0.1: the JAX model
  fed the port's Philox bits, loss and grads;
- every new wrapper raises on a tensor off the CPU that has no kernel,
  rather than falling back to its plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu.ops.pallas.flash_attention import (_flash_bwd_call,
                                                   _flash_call)
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention_bshd as jax_flash_bshd)
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.ops import attention_dispatch as disp
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp
from paddle_tpu_torch.utils.convert import from_paddle_tpu_state
from test_torch_attention_dropout import jax_bits, port_bits

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ATOL = 1e-5
B, S, H, D, BLOCK = 2, 256, 2, 64, 128


def _t(x):
    return torch.from_numpy(np.array(x))


def _bshd(seed):
    rng = np.random.RandomState(seed)
    q, k = ((rng.randn(B, S, H, D) * 0.5).astype(np.float32)
            for _ in range(2))
    v, do = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _bhsd(x):
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))


def _from_bhsd(x):
    return np.asarray(x).reshape(B, H, S, -1).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
def test_bshd_refs_match_pallas_interpret(causal):
    q, k, v, do = _bshd(3 + causal)
    scale = 1.0 / D ** 0.5
    want_o, want_lse = _flash_call(_bhsd(q), _bhsd(k), _bhsd(v), scale,
                                   causal, BLOCK, BLOCK, True)
    o, lse = fa.causal_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), _from_bhsd(want_o), atol=ATOL)
    lse_np = _from_bhsd(want_lse)[..., 0]                    # (B, S, H)
    np.testing.assert_allclose(lse.numpy(), lse_np, atol=ATOL)

    delta = (do * _from_bhsd(want_o)).sum(-1)                # (B, S, H)

    def col(x):                       # (B, S, H) -> (B*H, S, 1)
        return jnp.asarray(x.transpose(0, 2, 1).reshape(B * H, S, 1))

    want = _flash_bwd_call(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do),
                           col(lse_np), col(delta), scale, causal, BLOCK,
                           BLOCK, True)
    args = (_t(q), _t(k), _t(v), _t(do), _t(lse_np), _t(delta))
    dq = fa.bshd_dq_ref(*args, causal=causal)
    dk, dv = fa.bshd_dkv_ref(*args, causal=causal)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), _from_bhsd(w), atol=ATOL,
                                   err_msg=name)
    # the wrappers take the plain versions on CPU tensors, launching none
    K.reset_launch_counts()
    assert torch.equal(fa.bshd_dq(*args, causal=causal), dq)
    assert all(torch.equal(a, b) for a, b in zip(
        fa.bshd_dkv(*args, causal=causal), (dk, dv)))
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def test_attention_bshd_grads_match_jax_through_unbind_views():
    """q, k, v as the ``unbind`` views of one (B, S, 3, H, D) tensor,
    the layout ``GPTAttention`` hands over (row stride 3*H*D)."""
    q, k, v, do = _bshd(7)

    def loss_j(q, k, v):
        o = jax_flash_bshd(q, k, v, causal=True, block_q=BLOCK,
                           block_k=BLOCK, interpret=True)
        return (o * jnp.asarray(do)).sum(), o

    (_, want_o), want = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    qkv = _t(np.stack([q, k, v], 2)).requires_grad_()
    tq, tk, tv = qkv.unbind(2)
    o = disp.causal_attention(tq, tk, tv)
    assert o.grad_fn.name() == "FlashAttentionBSHDBackward"
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               atol=ATOL)
    (g,) = torch.autograd.grad(o, qkv, _t(do))
    for i, (name, w) in enumerate(zip("qkv", want)):
        np.testing.assert_allclose(g[:, :, i].numpy(), np.asarray(w),
                                   atol=ATOL, err_msg=f"d{name}")


# -- GPTForCausalLM + GPTPretrainingCriterion --------------------------------

def _jax_model():
    paddle.seed(0)
    return JM.GPTForCausalLM(JM.gpt_tiny(hidden_dropout=0.0,
                                         attention_dropout=0.0))


def _port(state):
    cfg = TM.gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    m = TM.GPTForCausalLM(cfg, device="cpu")
    m.load_state_dict(from_paddle_tpu_state(state, cfg), strict=True)
    return m.train()


def _batch(seed, b=2, s=24):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int32)
    lab = rng.randint(0, 1024, (b, s)).astype(np.int32)
    mask = (rng.rand(b, s) > 0.3).astype(np.float32)
    return ids, lab, mask


def _qkv_grad_flows_through_the_kernel(loss, weight):
    """Walk the backward graph from ``loss``: a FlashAttentionBSHD node
    exists and ``weight``'s accumulator lies below it."""
    seen, todo, below = set(), [loss.grad_fn], False
    attn = []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if fn.name() == "FlashAttentionBSHDBackward":
            attn.append(fn)
        todo += [nxt for nxt, _ in fn.next_functions]
    for root in attn:
        stack, visited = [root], set()
        while stack:
            fn = stack.pop()
            if fn is None or fn in visited:
                continue
            visited.add(fn)
            below |= getattr(fn, "variable", None) is weight
            stack += [nxt for nxt, _ in fn.next_functions]
    return bool(attn) and below


@pytest.mark.parametrize("masked", [False, True])
def test_nn_api_grads_match_jax_backward(masked):
    jm = _jax_model()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    ids, lab, mask = _batch(1 + masked)
    jcrit = JM.GPTPretrainingCriterion(jm.cfg)
    jloss = jcrit(jm(paddle.to_tensor(ids)), paddle.to_tensor(lab),
                  paddle.to_tensor(mask) if masked else None)
    jloss.backward()
    jgrads = {k: np.asarray(v.grad.numpy())
              for k, v in jm.state_dict().items()}

    port = _port(state)
    crit = TM.GPTPretrainingCriterion(port.cfg)
    loss = crit(port(_t(ids).long()), _t(lab),
                _t(mask) if masked else None)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    want = from_paddle_tpu_state(jgrads, port.cfg)
    got = {name: p.grad for name, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    w = port.gpt.h[0].attn.qkv_proj.weight
    assert float(w.grad.abs().max()) > 0
    loss2 = crit(port(_t(ids).long()), _t(lab))
    assert _qkv_grad_flows_through_the_kernel(loss2, w)


def test_attention_dropout_in_training_still_raises():
    """Attention dropout 0.1 in training (the models' default): the port
    drops inside K-BSHD's plain version with its Philox bits, one key a
    layer; the JAX model, fed those bits in place of its own, gives the
    same loss and grads (atol 1e-5)."""
    paddle.seed(0)
    jm = JM.GPTForCausalLM(JM.gpt_tiny(hidden_dropout=0.0,
                                       attention_dropout=0.1))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TM.gpt_tiny(hidden_dropout=0.0, attention_dropout=0.1)
    port = TM.GPTForCausalLM(cfg, device="cpu")
    port.load_state_dict(from_paddle_tpu_state(state, cfg), strict=True)
    ids, lab, _ = _batch(5)
    crit = TM.GPTPretrainingCriterion(cfg)
    with port_bits() as seen:
        loss = crit(port.train()(_t(ids).long()), _t(lab))
        loss.backward()
    assert len(seen) == cfg.num_layers
    with jax_bits([m.numpy() for m in seen.values()]):
        jloss = JM.GPTPretrainingCriterion(jm.cfg)(
            jm.train()(paddle.to_tensor(ids)), paddle.to_tensor(lab))
    jloss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    want = from_paddle_tpu_state({k: np.asarray(v.grad.numpy())
                                  for k, v in jm.state_dict().items()}, cfg)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=ATOL, err_msg=name)


# -- no fallback off the CPU --------------------------------------------------

def _meta_calls():
    meta = torch.device("meta")
    x = torch.empty(1, 64, 2 * 64, device=meta)
    lse = torch.empty(1, 64, 2, device=meta)
    seg = torch.empty(1, 64, dtype=torch.int32, device=meta)
    y = torch.empty(1, 64, 2, 64, device=meta)
    return {
        "seg_fwd": lambda: fp.seg_fwd(x, x, x, seg, 2),
        "seg_dq": lambda: fp.seg_dq(x, x, x, x, lse, lse, seg, 2),
        "seg_dkv": lambda: fp.seg_dkv(x, x, x, x, lse, lse, seg, 2),
        "flash_attention_packed_seg": lambda: fp.flash_attention_packed_seg(
            x, x, x, seg, 2),
        "bshd_fwd": lambda: fa.bshd_fwd(y, y, y),
        "bshd_dq": lambda: fa.bshd_dq(y, y, y, y, lse, lse),
        "bshd_dkv": lambda: fa.bshd_dkv(y, y, y, y, lse, lse),
        "attention_bshd": lambda: fa.attention_bshd(y, y, y),
    }


@pytest.mark.parametrize("name", sorted(_meta_calls()))
def test_new_wrappers_never_fall_back_off_the_cpu(name):
    with pytest.raises(ValueError, match="no kernel"):
        _meta_calls()[name]()

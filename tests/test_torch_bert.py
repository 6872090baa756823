"""The port's BERT (``models.bert``) against the JAX package's, on the CPU:
a tiny ``BertForPretraining`` (2 layers, hidden 64, 4 heads, vocab 512,
dropouts 0) built by the JAX package from ``paddle.seed(0)`` and carried
across by ``utils.convert.from_bert_state``, fed the same numpy batches:

- MLM and NSP logits and the loss (atol 1e-5), and every parameter's
  grad after ``backward()`` (1e-4 of the leaf's largest), unpadded (the
  K-BSHD path), with a 2-D padding mask (the K-SEG path with key-side
  ids) and with a 4-D additive mask (K-BSHD with the mask added inside
  the kernels);
- a padding-mask row with no real token: the JAX model's additive mask,
  the row attending uniformly to every key;
- attention dropout in training, the JAX model fed the port's Philox
  bits, for each kind of mask;
- 3 momentum-SGD steps (lr 0.01, momentum 0.9: ``torch.optim.SGD``
  against ``paddle.optimizer.Momentum``), losses and params.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as JB
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp
from paddle_tpu_torch.utils.convert import (expected_bert_leaves,
                                            from_bert_state)
from test_torch_attention_dropout import jax_bits, port_bits

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ATOL = 1e-5
KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=512,
          hidden_dropout=0.0, attention_dropout=0.0)
B, S = 2, 24


@pytest.fixture(scope="module")
def models():
    """The JAX model, its state as numpy, and a builder of the port's
    model on that state."""
    paddle.seed(0)
    jm = JB.BertForPretraining(JB.bert_base(**KW))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TB.bert_base(**KW)

    def port():
        m = TB.BertForPretraining(cfg, device="cpu")
        m.load_state_dict(from_bert_state(state, cfg), strict=True)
        return m.train()

    return jm, state, port


def _batch(seed, mask_kind):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, (B, S)).astype(np.int32)
    types = rng.randint(0, 2, (B, S)).astype(np.int32)
    mlm_y = rng.randint(0, 512, (B, S)).astype(np.int32)
    mlm_y[0, :3] = -100                    # ignored positions
    nsp_y = np.asarray([0, 1], np.int32)
    mask = None
    if mask_kind == "padding":
        mask = np.ones((B, S), np.int64)
        mask[0, 17:] = 0
        mask[1, 5:9] = 0                   # a hole, not only a tail
    elif mask_kind == "additive":
        keep = rng.rand(B, S) > 0.25
        keep[:, 0] = True
        mask = ((keep - 1.0) * 1e9).astype(np.float32)[:, None, None, :]
    return ids, types, mlm_y, nsp_y, mask


def _jax_step(jm, batch):
    ids, types, mlm_y, nsp_y, mask = batch
    mlm, nsp = jm(paddle.to_tensor(ids),
                  token_type_ids=paddle.to_tensor(types),
                  attention_mask=None if mask is None
                  else paddle.to_tensor(mask))
    loss = jm.loss(mlm, nsp, paddle.to_tensor(mlm_y),
                   paddle.to_tensor(nsp_y))
    return mlm, nsp, loss


def _port_step(tm, batch):
    ids, types, mlm_y, nsp_y, mask = batch
    mlm, nsp = tm(torch.from_numpy(ids).long(),
                  token_type_ids=torch.from_numpy(types).long(),
                  attention_mask=None if mask is None
                  else torch.from_numpy(mask))
    loss = tm.loss(mlm, nsp, torch.from_numpy(mlm_y),
                   torch.from_numpy(nsp_y))
    return mlm, nsp, loss


def _attention_nodes(loss):
    names, seen, todo = set(), set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(fn.name())
        todo += [nxt for nxt, _ in fn.next_functions]
    return {n for n in names if n.startswith("FlashAttention")}


@pytest.mark.parametrize("mask_kind", [None, "padding", "additive"])
def test_bert_matches_jax_logits_loss_and_grads(models, mask_kind):
    jm, state, port = models
    batch = _batch(1, mask_kind)
    jm.clear_gradients()
    jmlm, jnsp, jloss = _jax_step(jm, batch)
    jloss.backward()
    jgrads = {k: np.asarray(v.grad.numpy())
              for k, v in jm.state_dict().items()}
    jm.clear_gradients()

    tm = port()
    seg_calls = fp.PLAIN_CALLS["K-SEG"]
    mlm, nsp, loss = _port_step(tm, batch)
    np.testing.assert_allclose(mlm.detach().numpy(), jmlm.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(nsp.detach().numpy(), jnsp.numpy(),
                               atol=ATOL)
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    # the attention each mask takes: K-SEG's plain version once a layer
    # for the padding mask, K-BSHD's without a mask and (its BIAS
    # variant) with the 4-D one
    want_nodes = {None: {"FlashAttentionBSHDBackward"},
                  "padding": {"FlashAttentionPackedSegBackward"},
                  "additive": {"FlashAttentionBSHDBackward"}}[mask_kind]
    assert _attention_nodes(loss) == want_nodes
    assert fp.PLAIN_CALLS["K-SEG"] - seg_calls == (
        KW["num_layers"] if mask_kind == "padding" else 0)
    loss.backward()
    want = from_bert_state(jgrads, tm.cfg)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want) == set(expected_bert_leaves(tm.cfg))
    for name, g in got.items():
        top = max(float(want[name].abs().max()), 1e-30)
        err = float((g - want[name]).abs().max()) / top
        assert err <= 1e-4, (name, err)


def test_padding_row_with_no_token_raises(models):
    """A padding mask whose row 1 has no real token: the port takes the
    JAX model's additive ``(m - 1) * 1e9`` mask for that batch (K-BSHD's
    BIAS variant), so the row attends uniformly to every key, as there;
    MLM logits, NSP logits and loss within 1e-5 of the JAX model's."""
    jm, _, port = models
    ids, types, mlm_y, nsp_y, mask = _batch(2, "padding")
    mask[1, :] = 0
    batch = (ids, types, mlm_y, nsp_y, mask)
    jmlm, jnsp, jloss = _jax_step(jm, batch)
    tm = port()
    mlm, nsp, loss = _port_step(tm, batch)
    np.testing.assert_allclose(mlm.detach().numpy(), jmlm.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(nsp.detach().numpy(), jnsp.numpy(),
                               atol=ATOL)
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    assert _attention_nodes(loss) == {"FlashAttentionBSHDBackward"}
    jm.clear_gradients()


@pytest.mark.parametrize("mask_kind", [None, "padding", "additive"])
def test_attention_dropout_in_training_raises(models, mask_kind):
    """Attention dropout 0.1 in training: the port drops inside the
    kernels' plain versions with its Philox bits (one key a layer), the
    JAX model is fed those bits in place of its own; logits and loss
    (1e-5) and every grad (1e-4 of its leaf's largest). Eval drops
    nothing."""
    _, state, _ = models
    kw = {**KW, "attention_dropout": 0.1}
    jm = JB.BertForPretraining(JB.bert_base(**kw))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    cfg = TB.bert_base(**kw)
    tm = TB.BertForPretraining(cfg, device="cpu")
    tm.load_state_dict(from_bert_state(state, cfg), strict=True)
    batch = _batch(3, mask_kind)
    with port_bits() as seen:
        mlm, nsp, loss = _port_step(tm.train(), batch)
        loss.backward()
    assert len(seen) == KW["num_layers"]
    with jax_bits([m.numpy() for m in seen.values()]):
        jmlm, jnsp, jloss = _jax_step(jm.train(), batch)
    jloss.backward()
    np.testing.assert_allclose(mlm.detach().numpy(), jmlm.numpy(),
                               atol=ATOL)
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    want = from_bert_state({k: np.asarray(v.grad.numpy())
                            for k, v in jm.state_dict().items()}, cfg)
    for name, p in tm.named_parameters():
        top = max(float(want[name].abs().max()), 1e-30)
        err = float((p.grad - want[name]).abs().max()) / top
        assert err <= 1e-4, (name, err)
    with port_bits() as seen:
        emlm, _, _ = _port_step(tm.eval(), batch)
    assert not seen
    ejmlm, _, _ = _jax_step(jm.eval(), batch)
    np.testing.assert_allclose(emlm.detach().numpy(), ejmlm.numpy(),
                               atol=ATOL)


def test_momentum_sgd_steps_match_jax(models):
    _, state, port = models
    paddle.seed(0)
    jm = JB.BertForPretraining(JB.bert_base(**KW))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jopt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                     parameters=jm.parameters())
    tm = port()
    topt = torch.optim.SGD(tm.parameters(), lr=0.01, momentum=0.9)
    for step in range(3):
        batch = _batch(10 + step, "padding")
        _, _, jloss = _jax_step(jm, batch)
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        _, _, loss = _port_step(tm, batch)
        loss.backward()
        topt.step()
        topt.zero_grad(set_to_none=True)
        assert abs(float(loss.detach()) - float(jloss)) <= ATOL, step
    jstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    want = from_bert_state(jstate, tm.cfg)
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)

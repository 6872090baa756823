"""The port's transformer layers (``nn.layer.transformer``,
``incubate.nn``) against their JAX twins, on the CPU, at the JAX tests'
sizes (d_model 16, 2-4 heads), weights carried across by
``utils.convert.from_transformer_state`` /
``from_fused_transformer_state``, the same numpy inputs:

- every class's outputs in eval mode, and with dropout 0 its inputs' and
  parameters' grads, with each kind of mask the layers take;
- incremental decoding with ``Cache`` and ``StaticCache``, step by step
  against the JAX layers' and against the full forward under the causal
  mask;
- ``Transformer`` in training at attention dropout 0.1, the JAX model fed
  the port's Philox bits;
- the layers default to the card.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import incubate as jinc
from paddle_tpu import nn as jnn
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.utils.convert import (from_fused_transformer_state,
                                            from_transformer_state)
from test_torch_attention_dropout import jax_bits, port_bits

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ATOL = 1e-5
B, SRC, TGT = 2, 7, 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _padding(s, seed=0):
    """A ``(B, 1, 1, S)`` -1e9 padding mask: row 0's last 3 keys, row 1's
    last key."""
    m = np.zeros((B, 1, 1, s), np.float32)
    m[0, ..., s - 3:] = -1e9
    m[1, ..., s - 1:] = -1e9
    return m


def _square(s):
    return np.triu(np.full((s, s), -np.inf, np.float32), k=1)


def _bool(sq, sk, seed=1):
    m = np.random.RandomState(seed).rand(B, 1, sq, sk) > 0.4
    return m


def _carry(jlayer, tlayer, convert):
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(convert(state, tlayer), strict=True)
    return tlayer


def _hold(jlayer, tlayer, convert, call, inputs, masks=(), grads=True):
    """``call(layer, *inputs, *masks)`` in both packages: outputs, and
    with ``grads`` the inputs' grads and every parameter's (1e-5 of its
    leaf's largest) under the cotangent of a random ``do``."""
    tlayer.zero_grad(set_to_none=True)
    jlayer.clear_gradients()
    jts = [paddle.to_tensor(x, stop_gradient=not grads) for x in inputs]
    tts = [_t(x).requires_grad_(grads) for x in inputs]
    jm = [None if m is None else paddle.to_tensor(m) for m in masks]
    tm = [None if m is None else _t(m) for m in masks]
    want = call(jlayer, *jts, *jm)
    got = call(tlayer, *tts, *tm)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=ATOL)
    if not grads:
        return got
    do = _x(99, *got.shape)
    (want * paddle.to_tensor(do)).sum().backward()
    (got * _t(do)).sum().backward()
    for j, t in zip(jts, tts):
        np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(),
                                   atol=ATOL)
    _hold_grads(jlayer, tlayer, convert)
    return got


def _hold_grads(jlayer, tlayer, convert):
    """Every parameter's grad (none counts as zeros: a LayerNorm the
    configuration leaves out) within 1e-5 of its leaf's largest."""
    jgrads = convert({k: np.zeros(v.shape, np.float32) if v.grad is None
                      else np.asarray(v.grad.numpy())
                      for k, v in jlayer.state_dict().items()}, tlayer)
    for name, p in tlayer.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        top = max(float(jgrads[name].abs().max()), 1.0)
        err = float((g - jgrads[name]).abs().max()) / top
        assert err <= ATOL, (name, err)


# -- MultiHeadAttention ------------------------------------------------------

@pytest.mark.parametrize("mask", [None, "square", "padding", "bool"])
def test_multi_head_attention_matches_jax(mask):
    paddle.seed(1)
    jl = jnn.MultiHeadAttention(16, 4)
    tl = _carry(jl, tnn.MultiHeadAttention(16, 4, device="cpu"),
                from_transformer_state)
    m = {None: None, "square": _square(SRC), "padding": _padding(SRC),
         "bool": _bool(SRC, SRC)}[mask]
    _hold(jl, tl, from_transformer_state,
          lambda layer, x, *mk: layer(x, x, x, *mk), [_x(0, B, SRC, 16)],
          [m])


def test_cross_attention_with_kdim_vdim_matches_jax():
    paddle.seed(2)
    jl = jnn.MultiHeadAttention(16, 2, kdim=8, vdim=12)
    tl = _carry(jl, tnn.MultiHeadAttention(16, 2, kdim=8, vdim=12,
                                           device="cpu"),
                from_transformer_state)
    _hold(jl, tl, from_transformer_state,
          lambda layer, q, k, v, *mk: layer(q, k, v, *mk),
          [_x(1, B, TGT, 16), _x(2, B, SRC, 8), _x(3, B, SRC, 12)],
          [_padding(SRC)])


def test_multi_head_attention_caches_match_jax():
    """``Cache`` grows by each step's key and value; ``StaticCache``
    holds a memory's projections: step by step against the JAX layer, and
    the cached steps against one forward under the causal mask."""
    paddle.seed(3)
    jl = jnn.MultiHeadAttention(16, 4).eval()
    tl = _carry(jl, tnn.MultiHeadAttention(16, 4, device="cpu"),
                from_transformer_state).eval()
    x, mem = _x(4, B, TGT, 16), _x(5, B, SRC, 16)
    jc = jl.gen_cache(paddle.to_tensor(x))
    tc = tl.gen_cache(_t(x))
    assert isinstance(tc, tnn.MultiHeadAttention.Cache)
    assert tuple(tc.k.shape) == (B, 0, 4, 4)
    steps = []
    for i in range(TGT):
        jo, jc = jl(paddle.to_tensor(x[:, i:i + 1]), cache=jc)
        to, tc = tl(_t(x[:, i:i + 1]), cache=tc)
        np.testing.assert_allclose(to.detach().numpy(), jo.numpy(),
                                   atol=ATOL)
        steps.append(to.detach())
    assert tuple(tc.k.shape) == (B, TGT, 4, 4)
    full = tl(_t(x), attn_mask=_t(_square(TGT))).detach()
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=ATOL)
    js = jl.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem),
                      jnn.MultiHeadAttention.StaticCache)
    ts = tl.gen_cache(_t(mem), _t(mem), tnn.MultiHeadAttention.StaticCache)
    jo, js2 = jl(paddle.to_tensor(x), cache=js)
    to, ts2 = tl(_t(x), cache=ts)
    assert ts2 is ts
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), atol=ATOL)


# -- encoder and decoder layers, stacks, Transformer -------------------------

@pytest.mark.parametrize("pre,act", [(False, "relu"), (True, "gelu")])
def test_encoder_layer_and_stack_match_jax(pre, act):
    paddle.seed(4)
    kw = dict(dropout=0.0, activation=act, normalize_before=pre)
    jl = jnn.TransformerEncoderLayer(16, 2, 32, **kw)
    tl = _carry(jl, tnn.TransformerEncoderLayer(16, 2, 32, device="cpu",
                                                **kw),
                from_transformer_state)
    src = _x(6, B, SRC, 16)
    _hold(jl, tl, from_transformer_state,
          lambda layer, x, *mk: layer(x, *mk), [src], [_padding(SRC)])
    jenc = jnn.TransformerEncoder(jl, 2, jnn.LayerNorm(16))
    tenc = _carry(jenc, tnn.TransformerEncoder(
        tl, 2, torch.nn.LayerNorm(16)), from_transformer_state)
    assert tenc.layers[0].linear1.weight is not tenc.layers[1].linear1.weight
    _hold(jenc, tenc, from_transformer_state,
          lambda layer, x, *mk: layer(x, *mk), [src], [_padding(SRC)])


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_layer_and_stack_match_jax(pre):
    paddle.seed(5)
    kw = dict(dropout=0.0, normalize_before=pre)
    jl = jnn.TransformerDecoderLayer(16, 2, 32, **kw)
    tl = _carry(jl, tnn.TransformerDecoderLayer(16, 2, 32, device="cpu",
                                                **kw),
                from_transformer_state)
    tgt, mem = _x(7, B, TGT, 16), _x(8, B, SRC, 16)
    masks = [_square(TGT), _padding(SRC)]
    _hold(jl, tl, from_transformer_state,
          lambda layer, t, m, *mk: layer(t, m, *mk), [tgt, mem], masks)
    jdec = jnn.TransformerDecoder(jl, 2)
    tdec = _carry(jdec, tnn.TransformerDecoder(tl, 2),
                  from_transformer_state)
    _hold(jdec, tdec, from_transformer_state,
          lambda layer, t, m, *mk: layer(t, m, *mk), [tgt, mem], masks)


@pytest.mark.parametrize("pre", [False, True])
def test_transformer_matches_jax(pre):
    paddle.seed(6)
    kw = dict(d_model=16, nhead=2, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=32, dropout=0.0,
              normalize_before=pre)
    jm = jnn.Transformer(**kw)
    tm = _carry(jm, tnn.Transformer(device="cpu", **kw),
                from_transformer_state)
    sq = tnn.Transformer.generate_square_subsequent_mask(TGT, device="cpu")
    np.testing.assert_array_equal(
        sq.numpy(), jnn.Transformer.generate_square_subsequent_mask(
            TGT).numpy())
    _hold(jm, tm, from_transformer_state,
          lambda layer, s, t, *mk: layer(s, t, *mk),
          [_x(9, B, SRC, 16), _x(10, B, TGT, 16)],
          [_padding(SRC), sq.numpy(), _padding(SRC)])


def test_incremental_decoding_matches_jax():
    """``TransformerDecoder.gen_cache``: an incremental ``Cache`` and a
    ``StaticCache`` of the memory a layer, one target token a step, the
    JAX decoder's steps and the full causal forward."""
    paddle.seed(7)
    kw = dict(dropout=0.0)
    jdec = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(16, 2, 32,
                                                              **kw), 2)
    tdec = _carry(jdec, tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(16, 2, 32, device="cpu", **kw), 2),
        from_transformer_state).eval()
    jdec.eval()
    tgt, mem = _x(11, B, TGT, 16), _x(12, B, SRC, 16)
    pad = _padding(SRC)
    jc = jdec.gen_cache(paddle.to_tensor(mem))
    tc = tdec.gen_cache(_t(mem))
    assert isinstance(tc[0][1], tnn.MultiHeadAttention.StaticCache)
    steps = []
    for i in range(TGT):
        jo, jc = jdec(paddle.to_tensor(tgt[:, i:i + 1]),
                      paddle.to_tensor(mem), None, paddle.to_tensor(pad),
                      jc)
        to, tc = tdec(_t(tgt[:, i:i + 1]), _t(mem), None, _t(pad), tc)
        np.testing.assert_allclose(to.detach().numpy(), jo.numpy(),
                                   atol=ATOL)
        steps.append(to.detach())
    full = tdec(_t(tgt), _t(mem), _t(_square(TGT)), _t(pad)).detach()
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=ATOL)


def test_transformer_attention_dropout_matches_jax_fed_the_same_bits():
    """Training at attention dropout 0.1 (hidden dropout 0): the port's
    Philox bits, one key per attention call (2 encoder self, 2 decoder
    self, 2 cross), fed to the JAX model in the same order; output and
    every grad."""
    paddle.seed(8)
    kw = dict(d_model=16, nhead=2, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=32, dropout=0.0,
              attn_dropout=0.1)
    jm = jnn.Transformer(**kw)
    tm = _carry(jm, tnn.Transformer(device="cpu", **kw),
                from_transformer_state).train()
    src, tgt = _x(13, B, SRC, 16), _x(14, B, TGT, 16)
    masks = [_padding(SRC), _square(TGT), _padding(SRC)]
    do = _x(15, B, TGT, 16)
    with port_bits() as seen:
        got = tm(_t(src), _t(tgt), *(_t(m) for m in masks))
        (got * _t(do)).sum().backward()
    assert len(seen) == 6
    with jax_bits([m.numpy() for m in seen.values()]):
        want = jm.train()(paddle.to_tensor(src), paddle.to_tensor(tgt),
                          *(paddle.to_tensor(m) for m in masks))
    (want * paddle.to_tensor(do)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=ATOL)
    _hold_grads(jm, tm, from_transformer_state)


# -- the fused layers --------------------------------------------------------

@pytest.mark.parametrize("pre,causal,mask", [(False, False, None),
                                             (True, False, "padding"),
                                             (True, True, None),
                                             (False, True, "square")])
def test_fused_multi_head_attention_matches_jax(pre, causal, mask):
    paddle.seed(9)
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0,
              normalize_before=pre, causal=causal)
    jl = jinc.nn.FusedMultiHeadAttention(16, 2, **kw)
    tl = _carry(jl, tinc.nn.FusedMultiHeadAttention(16, 2, device="cpu",
                                                    **kw),
                from_fused_transformer_state)
    m = {None: None, "padding": _padding(SRC), "square": _square(SRC)}[mask]
    _hold(jl, tl, from_fused_transformer_state,
          lambda layer, x, *mk: layer(x, attn_mask=mk[0]),
          [_x(16, B, SRC, 16)], [m])


@pytest.mark.parametrize("pre,act", [(False, "relu"), (True, "gelu")])
def test_fused_feed_forward_and_encoder_layer_match_jax(pre, act):
    paddle.seed(10)
    jf = jinc.nn.FusedFeedForward(16, 32, dropout_rate=0.0, activation=act,
                                  normalize_before=pre)
    tf = _carry(jf, tinc.nn.FusedFeedForward(16, 32, dropout_rate=0.0,
                                             activation=act,
                                             normalize_before=pre,
                                             device="cpu"),
                from_fused_transformer_state)
    x = _x(17, B, SRC, 16)
    _hold(jf, tf, from_fused_transformer_state, lambda layer, v: layer(v),
          [x])
    kw = dict(dropout_rate=0.0, activation=act, normalize_before=pre)
    je = jinc.nn.FusedTransformerEncoderLayer(16, 2, 32, **kw)
    te = _carry(je, tinc.nn.FusedTransformerEncoderLayer(16, 2, 32,
                                                         device="cpu", **kw),
                from_fused_transformer_state)
    _hold(je, te, from_fused_transformer_state,
          lambda layer, v, *mk: layer(v, *mk), [x], [_padding(SRC)])


@pytest.mark.parametrize("causal", [True, False])
def test_fused_multi_transformer_matches_jax(causal):
    paddle.seed(11)
    jm = jinc.nn.FusedMultiTransformer(16, 2, 32, num_layers=2,
                                       causal=causal)
    tm = _carry(jm, tinc.nn.FusedMultiTransformer(16, 2, 32, num_layers=2,
                                                  causal=causal,
                                                  device="cpu"),
                from_fused_transformer_state)
    assert [f"layer_{i}" for i in range(2)] == [
        n for n, _ in tm.named_children()]
    _hold(jm, tm, from_fused_transformer_state, lambda layer, v: layer(v),
          [_x(18, B, SRC, 16)])


def test_layers_default_to_the_card():
    if torch.cuda.is_available():
        assert next(tnn.MultiHeadAttention(16, 2).parameters()
                    ).device.type == "cuda"
        return
    for build in (lambda: tnn.MultiHeadAttention(16, 2),
                  lambda: tnn.Transformer(16, 2, 1, 1, 32),
                  lambda: tinc.nn.FusedMultiTransformer(16, 2, 32),
                  lambda: tnn.Transformer.generate_square_subsequent_mask(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()

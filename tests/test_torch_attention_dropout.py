"""Attention dropout and additive masks in the port's flash attention,
against the JAX package on the CPU:

- ``ops.kernels.philox`` against the Random123 known answers (Salmon et
  al., SC'11), its keep fraction, and the bits' dependence on nothing
  but the key and the element's (b, h, i, j);
- ``framework.random``: keys from a generator of its own, reproducible,
  folded in an ``rng_context``, PyTorch's global RNG untouched;
- the plain versions fed the JAX package's ``jax.random.bernoulli`` bits
  through ``keep=`` against ``_sdpa_ref`` and ``xla_segment_attention``;
- the plain forward, dQ and dK/dV with dropout and a mask against
  autograd through the dense plain attention under the same bits;
- ``scaled_dot_product_attention`` against the JAX function for each
  mask shape, bool masks and rectangular causal attention, outputs and
  grads, and with dropout, the JAX function fed the port's Philox bits.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import _sdpa_ref as jax_sdpa_ref
from paddle_tpu.ops.attention_dispatch import xla_segment_attention
import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional.attention import (
    _sdpa_ref as port_sdpa_ref)
from paddle_tpu_torch.ops import attention_dispatch as disp
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp
from paddle_tpu_torch.ops.kernels import philox

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

B, H, D = 2, 2, 16
P = 0.1
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(sq, sk, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, sq, H, D) * 0.5).astype(np.float32)
    k = (rng.randn(B, sk, H, D) * 0.5).astype(np.float32)
    v = rng.randn(B, sk, H, D).astype(np.float32)
    do = rng.randn(B, sq, H, D).astype(np.float32)
    return q, k, v, do


def _mask(kind, sq, sk, seed=0):
    """A mask of each shape the layers pass, as numpy."""
    rng = np.random.RandomState(seed)
    if kind == "square":          # generate_square_subsequent_mask's
        return np.triu(np.full((sq, sk), -np.inf, np.float32), k=1)
    if kind == "padding":         # BERT's (m - 1) * 1e9, (B, 1, 1, Sk)
        m = np.ones((B, sk), np.float32)
        m[0, sk // 2:] = 0
        m[1, sk - 3:] = 0
        return ((m - 1.0) * 1e9)[:, None, None, :]
    if kind == "full":            # a random (B, H, Sq, Sk) bias
        return rng.randn(B, H, sq, sk).astype(np.float32)
    if kind == "bool":            # added as 1.0 / 0.0, as in the JAX package
        return rng.rand(B, 1, sq, sk) > 0.5
    return None


@contextlib.contextmanager
def jax_bits(masks):
    """``jax.random.bernoulli`` answers with ``masks`` in order: the JAX
    package's dropout fed the port's Philox bits."""
    it = iter(masks)

    def bits(key, p=0.5, shape=None):
        m = np.asarray(next(it))
        assert tuple(m.shape) == tuple(shape), (m.shape, shape)
        return jnp.asarray(m)

    with mock.patch.object(jax.random, "bernoulli", bits):
        yield


@contextlib.contextmanager
def port_bits():
    """Records each distinct key's Philox mask the port's plain versions
    build, in the order of first use."""
    seen = {}
    real = philox.keep_mask

    def record(rng, dropout_p, shape, device=None):
        m = real(rng, dropout_p, shape, device)
        seen.setdefault(tuple(rng), m)
        return m

    with mock.patch.object(philox, "keep_mask", record):
        yield seen


# -- Philox and the random stream --------------------------------------------

# Random123's kat_vectors for philox4x32 10 rounds: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert tuple(int(w) for w in philox.philox4x32_10(ctr, key)) == want


def test_keep_bits_depend_on_the_key_and_the_element_only():
    shape = (2, 3, 70, 101)
    m = philox.keep_mask((7, 9), P, shape)
    n = m.numel()
    frac = float(m.float().mean())
    assert abs(frac - (1 - P)) <= 4 * (P * (1 - P) / n) ** 0.5
    assert torch.equal(m, philox.keep_mask((7, 9), P, shape))
    for other in ((7, 10), (8, 9), (7, 9 + 2 ** 32), (7 + 2 ** 40, 9)):
        assert not torch.equal(m, philox.keep_mask(other, P, shape))
    # a tile of the mask is the mask of the smaller call: the counter is
    # the logical (b, h, i, j), not a position in a tiling
    assert torch.equal(m[:, :, :33, :57],
                       philox.keep_mask((7, 9), P, (2, 3, 33, 57)))
    assert philox.threshold(P) == int((1 - float(np.float32(P))) * 2 ** 32)


def test_random_stream_is_its_own():
    torch_state = torch.get_rng_state()
    ptt.seed(5)
    a = [trandom.next_rng_key() for _ in range(3)]
    state = ptt.get_rng_state()
    b = [trandom.next_rng_key() for _ in range(2)]
    ptt.set_rng_state(state)
    assert [trandom.next_rng_key() for _ in range(2)] == b
    ptt.seed(5)
    assert [trandom.next_rng_key() for _ in range(3)] == a
    assert len(set(a + b)) == 5
    assert all(0 <= x < 2 ** 64 for key in a for x in key)
    with trandom.rng_context((1, 2)):
        ctx = [trandom.next_rng_key() for _ in range(3)]
    with trandom.rng_context((1, 2)):
        assert [trandom.next_rng_key() for _ in range(3)] == ctx
    assert len(set(ctx)) == 3 and ctx[0] == philox.fold_in((1, 2), 0)
    assert torch.equal(torch.get_rng_state(), torch_state)
    assert trandom.default_generator().initial_seed == 5


# -- the plain versions fed the JAX package's bits ---------------------------

@pytest.mark.parametrize("kind,causal", [(None, False), (None, True),
                                         ("padding", False), ("full", True),
                                         ("bool", False)])
def test_sdpa_ref_with_keep_matches_jax(kind, causal):
    sq, sk = 24, 40 if causal else 24
    q, k, v, _ = _inputs(sq, sk, 1)
    m = _mask(kind, sq, sk)
    jkey = jax.random.PRNGKey(3)
    bits = np.asarray(jax.random.bernoulli(jkey, 1 - P, (B, H, sq, sk)))
    want = jax_sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        None if m is None else jnp.asarray(m), causal,
                        dropout_p=P, key=jkey)
    got = port_sdpa_ref(_t(q), _t(k), _t(v), None if m is None else _t(m),
                        causal, dropout_p=P, keep=_t(bits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("case", ["self_causal", "keys_full",
                                  "keys_causal"])
def test_segment_refs_with_keep_match_jax(case):
    rng = np.random.RandomState(4)
    sq, sk = 32, 32 if case == "self_causal" else 48
    seg_q = np.sort(rng.randint(0, 4, (B, sq)), axis=1).astype(np.int32)
    seg_k = (None if case == "self_causal" else
             np.sort(rng.randint(0, 4, (B, sk)), axis=1).astype(np.int32))
    causal = case.endswith("causal")
    q, k, v, _ = _inputs(sq, sk, 5)
    jkey = jax.random.PRNGKey(6)
    bits = np.asarray(jax.random.bernoulli(jkey, 1 - P, (B, H, sq, sk)))
    want = xla_segment_attention(
        *(jnp.asarray(x) for x in (q, k, v, seg_q)),
        None if seg_k is None else jnp.asarray(seg_k), causal=causal,
        dropout_p=P, dropout_key=jkey)
    flat = [_t(x).flatten(2) for x in (q, k, v)]
    kid = None if seg_k is None else _t(seg_k)
    if case == "keys_causal":
        got = disp.dense_segment_attention(*flat, H, _t(seg_q), kid,
                                           dropout_p=P, keep=_t(bits))
    else:
        got, _ = fp.segment_attention_ref(*flat, _t(seg_q), H,
                                          segment_ids_k=kid, causal=causal,
                                          dropout_p=P, keep=_t(bits))
    np.testing.assert_allclose(got.reshape(B, sq, H, D).numpy(),
                               np.asarray(want), atol=1e-6)


# -- the plain backward against autograd under the same bits -----------------

@pytest.mark.parametrize("kind,p", [("square", 0.0), ("padding", 0.0),
                                    ("full", 0.0), (None, P),
                                    ("square", P), ("padding", P)])
def test_plain_backward_matches_autograd(kind, p):
    """K-BSHD's, K-BDQ's and K-BDKV's plain versions (the kernels'
    arithmetic: lse undropped, delta over the dropped output,
    FlashAttention-2's dS) against autograd through the dense ``_sdpa_ref`` with the same
    mask and keep bits; then ``attention_bshd``'s backward."""
    s = 24
    q, k, v, do = _inputs(s, s, 7)
    m = _mask(kind, s, s)
    bias = None if m is None else _t(m)
    rngk = (11, 13) if p else None
    keep = philox.keep_mask(rngk, p, (B, H, s, s)) if p else None
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    ref = port_sdpa_ref(qt, kt, vt, bias, dropout_p=p, keep=keep)
    ref.backward(_t(do))
    kw = dict(causal=False, bias=bias, dropout_p=p, rng=rngk)
    o, lse = fa.causal_attention_ref(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(o.numpy(), ref.detach().numpy(), atol=ATOL)
    delta = (_t(do) * o).sum(-1)
    dq = fa.bshd_dq_ref(_t(q), _t(k), _t(v), _t(do), lse, delta, **kw)
    dk, dv = fa.bshd_dkv_ref(_t(q), _t(k), _t(v), _t(do), lse, delta, **kw)
    for got, want in ((dq, qt.grad), (dk, kt.grad), (dv, vt.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    q2, k2, v2 = (_t(x).requires_grad_() for x in (q, k, v))
    out = fa.attention_bshd(q2, k2, v2, causal=False, bias=bias,
                            dropout_p=p, rng=rngk)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=ATOL)
    for got, want in ((q2, qt), (k2, kt), (v2, vt)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_segment_backward_with_dropout_matches_autograd(causal):
    """K-SDQ's and K-SDKV's plain versions with dropout against autograd
    through K-SEG's (a dense differentiable softmax) under the same
    bits, and ``flash_attention_packed_seg``'s backward."""
    rng = np.random.RandomState(8)
    s = 48
    seg_q = np.sort(rng.randint(0, 3, (B, s)), axis=1).astype(np.int32)
    seg_k = None if causal else np.where(rng.rand(B, s) < 0.2, -1,
                                         0).astype(np.int32)
    if seg_k is not None:
        seg_q = np.zeros_like(seg_q)
    q, k, v, do = (_t(x).flatten(2) for x in _inputs(s, s, 9))
    kw = dict(segment_ids_k=None if seg_k is None else _t(seg_k),
              causal=causal, dropout_p=P, rng=(3, 4))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    ref, lse = fp.segment_attention_ref(qt, kt, vt, _t(seg_q), H, **kw)
    ref.backward(do)
    delta = fp._delta(do, ref.detach(), H)
    dq = fp.segment_dq_ref(q, k, v, do, lse.detach(), delta, _t(seg_q), H,
                           **kw)
    dk, dv = fp.segment_dkv_ref(q, k, v, do, lse.detach(), delta,
                                _t(seg_q), H, **kw)
    for got, want in ((dq, qt), (dk, kt), (dv, vt)):
        np.testing.assert_allclose(got.numpy(), want.grad.numpy(),
                                   atol=ATOL)
    q2, k2, v2 = (x.clone().requires_grad_() for x in (q, k, v))
    out = fp.flash_attention_packed_seg(q2, k2, v2, _t(seg_q), H, **kw)
    out.backward(do)
    for got, want in ((q2, qt), (k2, kt), (v2, vt)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   atol=ATOL)


# -- scaled_dot_product_attention against the JAX function -------------------

SDPA_CASES = {   # (mask kind, is_causal, Sq, Sk)
    "square_mask": ("square", False, 24, 24),
    "padding": ("padding", False, 24, 40),
    "full": ("full", False, 24, 40),
    "bool": ("bool", False, 24, 24),
    "causal_and_padding": ("padding", True, 24, 24),
    "rect_causal": (None, True, 24, 40),
    "rect_causal_and_padding": ("padding", True, 24, 40),
}


def _jax_sdpa_vjp(m, causal, args, do, bits=()):
    """``jax.vjp`` of the function the JAX package's SDPA runs on the CPU
    (``_sdpa_ref``), fed ``bits`` as its dropout."""
    with jax_bits(bits):
        return jax.vjp(
            lambda q, k, v: jax_sdpa_ref(
                q, k, v, None if m is None else jnp.asarray(m), causal,
                dropout_p=P if bits else 0.0,
                key=jax.random.PRNGKey(0) if bits else None),
            *(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_sdpa_matches_jax_for_each_mask(case):
    kind, causal, sq, sk = SDPA_CASES[case]
    q, k, v, do = _inputs(sq, sk, len(case))
    m = _mask(kind, sq, sk)
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=None if m is None else paddle.to_tensor(m),
        is_causal=causal)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = TF.scaled_dot_product_attention(
        *ts, attn_mask=None if m is None else _t(m), is_causal=causal)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                               atol=ATOL)
    _, vjp = _jax_sdpa_vjp(m, causal, (q, k, v), do)
    for t, g in zip(ts, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL)


@pytest.mark.parametrize("case", ["padding", "rect_causal_and_padding",
                                  "square_mask"])
def test_sdpa_dropout_matches_jax_fed_the_same_bits(case):
    """Active dropout: the port's Philox bits, recorded from its plain
    versions, fed to the JAX package's SDPA in place of its own; outputs
    and grads."""
    kind, causal, sq, sk = SDPA_CASES[case]
    q, k, v, do = _inputs(sq, sk, 3)
    m = _mask(kind, sq, sk)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    with port_bits() as seen, trandom.rng_context((21, 22)):
        out = TF.scaled_dot_product_attention(
            *ts, attn_mask=None if m is None else _t(m), dropout_p=P,
            is_causal=causal, training=True)
        out.backward(_t(do))
    assert len(seen) == 1
    bits = [mk.numpy() for mk in seen.values()]
    with jax_bits(bits):
        want = JF.scaled_dot_product_attention(
            *(paddle.to_tensor(x) for x in (q, k, v)),
            attn_mask=None if m is None else paddle.to_tensor(m),
            dropout_p=P, is_causal=causal, training=True)
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                               atol=ATOL)
    _, vjp = _jax_sdpa_vjp(m, causal, (q, k, v), do, bits)
    for t, g in zip(ts, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL)
    # inactive dropout (eval) draws no key and drops nothing
    with port_bits() as seen:
        eval_out = TF.scaled_dot_product_attention(
            *(_t(a) for a in (q, k, v)),
            attn_mask=None if m is None else _t(m), dropout_p=P,
            is_causal=causal, training=False)
    assert not seen
    np.testing.assert_allclose(
        eval_out.numpy(), JF.scaled_dot_product_attention(
            *(paddle.to_tensor(x) for x in (q, k, v)),
            attn_mask=None if m is None else paddle.to_tensor(m),
            is_causal=causal, training=False).numpy(), atol=ATOL)


@pytest.mark.parametrize("shape,p", [((B, H, 24, 40), 0.0),
                                     ((1, H, 24, 40), 0.0),
                                     ((1, H, 24, 40), P)])
def test_learnable_mask_grad_matches_jax_on_the_cpu(shape, p):
    """A mask with ``requires_grad`` (a relative-position bias) trains on
    the CPU: its grad and q's, k's, v's match ``jax.vjp`` of the JAX
    package's ``_sdpa_ref`` through the mask, dropout fed the port's
    bits."""
    q, k, v, do = _inputs(shape[2], shape[3], 7)
    m = np.random.RandomState(8).randn(*shape).astype(np.float32)
    ts = [_t(a).requires_grad_() for a in (q, k, v, m)]
    with port_bits() as seen, trandom.rng_context((5, 6)):
        out = TF.scaled_dot_product_attention(*ts[:3], attn_mask=ts[3],
                                              dropout_p=p, training=True)
        out.backward(_t(do))
    bits = [mk.numpy() for mk in seen.values()]
    assert len(bits) == (1 if p else 0)
    with jax_bits(bits):
        want, vjp = jax.vjp(
            lambda q, k, v, m: jax_sdpa_ref(
                q, k, v, m, False, dropout_p=p,
                key=jax.random.PRNGKey(0) if p else None),
            *(jnp.asarray(a) for a in (q, k, v, m)))
        grads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL)


def test_masks_take_no_gradient_and_cuda_takes_no_plain_version():
    """Off the CPU the kernels give a mask no gradient: one with
    ``requires_grad`` raises; no CUDA tensor reaches a plain version."""
    x = torch.zeros(B, 8, H, D, device="meta")
    with pytest.raises(ValueError, match="no gradient"):
        TF.scaled_dot_product_attention(
            x, x, x, attn_mask=torch.zeros(8, 8, device="meta",
                                           requires_grad=True))
    x = torch.zeros(B, 8, H, D)
    with pytest.raises(ValueError, match="rng"):
        fa.bshd_fwd(x, x, x, causal=False, dropout_p=P)
    # a tensor off the CPU never reaches a plain version: the wrappers
    # launch a kernel or raise (meta has none)
    meta = torch.empty(B, 64, H, 64, device="meta")
    mask = torch.zeros(64, 64, device="meta")
    seg = torch.zeros(1, 64, dtype=torch.int32, device="meta")
    packed = torch.empty(1, 64, H * 64, device="meta")
    lse = torch.empty(1, 64, H, device="meta")
    for call in (
            lambda: TF.scaled_dot_product_attention(meta, meta, meta,
                                                    attn_mask=mask),
            lambda: TF.scaled_dot_product_attention(meta, meta, meta,
                                                    dropout_p=P),
            lambda: fa.bshd_dq(meta, meta, meta, meta, lse, lse,
                               causal=False, bias=mask),
            lambda: fp.seg_dq(packed, packed, packed, packed, lse, lse,
                              seg, H, dropout_p=P, rng=(1, 2))):
        with pytest.raises(ValueError, match="no kernel"):
            call()

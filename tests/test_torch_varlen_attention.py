"""Full (non-causal) and varlen attention against the JAX package's, on the
CPU, on the same numpy inputs:

- the plain versions of K-SEG, K-SDQ and K-SDKV with ``causal=False``,
  with and without distinct key-side ids, at ``Sq != Sk`` (256 x 384),
  over unsorted and colliding ids and rows that see no key, against the
  Pallas ``_fwd_call_seg`` / ``_dq_call_seg`` / ``_dkv_call_seg`` in
  interpret mode (block 128, 2 heads of 64; fp32, atol 1e-5), and the
  wrappers equal to them on CPU tensors;
- ``nn.functional``'s ``flash_attn_unpadded``, ``flash_attention(
  segment_ids=...)``, ``scaled_dot_product_attention`` and
  ``sequence_mask`` against the JAX functions (outputs, and the grads
  against ``jax.vjp`` of the dense function the JAX package runs on the
  CPU), causal attention with distinct key ids included (the dense plain
  version here; CUDA raises);
- every C entry's parameters against its ctypes signature in
  ``ops/kernels/_build.py``.
"""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import _sdpa_ref as jax_sdpa_ref
from paddle_tpu.ops.attention_dispatch import xla_segment_attention
from paddle_tpu.ops.pallas.flash_attention_packed import (
    _dkv_call_seg, _dq_call_seg, _fwd_call_seg,
    cu_seqlens_to_segment_ids as jax_cu_to_ids)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import attention_dispatch as disp
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp
from test_torch_attention_dropout import jax_bits, port_bits

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

NH, D, BLOCK = 2, 64, 128
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _ids(cu, total):
    return np.asarray(jax_cu_to_ids(jnp.asarray(cu, jnp.int32), total))


# (seg_q, seg_k or None, sq, sk) per case, B = 2
def _case(name):
    if name == "self":
        # unsorted runs, a recurring id, ids sharing their low 10 bits
        # (1023 and -1, 7 and 1031) and the int32 extremes
        ids = np.array([5, 2, 9, 2, 1023, -1, 7, 1031, 2 ** 31 - 1,
                        -2 ** 31], np.int64)
        rng = np.random.RandomState(7)
        row0 = np.repeat(ids, rng.multinomial(246, np.ones(10) / 10) + 1)
        row1 = rng.choice(ids, 256)
        return np.stack([row0, row1]).astype(np.int32), None, 256, 256
    if name == "padding":
        # BERT's padding mask: queries 0, keys 0 on real tokens, -1 on pads
        k = np.zeros((2, 256), np.int32)
        k[0, 200:] = -1
        k[1, 37:] = -1
        return np.zeros((2, 256), np.int32), k, 256, 256
    # varlen, Sq != Sk: row 0's q pad tail (-1) sees no key (the keys
    # have no pad), row 1's sequence 2 has one query and no key
    q = np.stack([_ids([0, 100, 150, 150, 230], 256),
                  _ids([0, 1, 128, 129, 256], 256)])
    k = np.stack([_ids([0, 200, 260, 260, 384], 384),
                  _ids([0, 64, 300, 300, 384], 384)])
    return q, k, 256, 384


def _qkvdo(sq, sk, seed):
    rng = np.random.RandomState(seed)
    hp = NH * D
    q = (rng.randn(2, sq, hp) * 0.5).astype(np.float32)
    k = (rng.randn(2, sk, hp) * 0.5).astype(np.float32)
    v = rng.randn(2, sk, hp).astype(np.float32)
    do = rng.randn(2, sq, hp).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("name", ["self", "padding", "varlen"])
def test_full_segment_refs_match_pallas_interpret(name):
    seg_q, seg_k, sq, sk = _case(name)
    q, k, v, do = _qkvdo(sq, sk, len(name))
    scale = 1.0 / D ** 0.5
    jseg_q = jnp.asarray(seg_q)
    jseg_k = jseg_q if seg_k is None else jnp.asarray(seg_k)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    want_o, want_lse = _fwd_call_seg(jq, jk, jv, jseg_q, jseg_k, NH, scale,
                                     False, BLOCK, BLOCK, True)
    kid = None if seg_k is None else _t(seg_k)
    o, lse = fp.segment_attention_ref(_t(q), _t(k), _t(v), _t(seg_q), NH,
                                      segment_ids_k=kid, causal=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)
    if name == "varlen":
        # rows that see no key: o 0 and the Pallas kernel's lse, exactly
        empty = np.asarray(want_lse)[..., 0] < -1e29
        assert empty.sum() == 26 + 1
        assert np.all(o.numpy()[empty] == 0.0)
        assert np.all(lse.numpy()[empty] == fp.EMPTY_LSE)

    lse_np = np.asarray(want_lse)
    delta = (do * np.asarray(want_o)).reshape(2, sq, NH, D).sum(-1)
    want_dq = _dq_call_seg(jq, jk, jv, jdo, jnp.asarray(lse_np),
                           jnp.asarray(delta), jseg_q, jseg_k, NH, scale,
                           False, BLOCK, BLOCK, True)
    want_dk, want_dv = _dkv_call_seg(
        jq, jk, jv, jdo, jnp.asarray(lse_np.transpose(0, 2, 1)),
        jnp.asarray(delta.transpose(0, 2, 1)), jseg_q, jseg_k, NH, scale,
        False, BLOCK, BLOCK, True)
    args = (_t(q), _t(k), _t(v), _t(do), _t(lse_np), _t(delta), _t(seg_q),
            NH)
    kw = dict(segment_ids_k=kid, causal=False)
    dq = fp.segment_dq_ref(*args, **kw)
    dk, dv = fp.segment_dkv_ref(*args, **kw)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=ATOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), atol=ATOL)

    # the wrappers take the plain versions on CPU tensors, launching none
    K.reset_launch_counts()
    assert torch.equal(fp.seg_dq(*args, **kw), dq)
    assert all(torch.equal(a, b) for a, b in zip(fp.seg_dkv(*args, **kw),
                                                 (dk, dv)))
    o2, lse2 = fp.seg_fwd(_t(q), _t(k), _t(v), _t(seg_q), NH, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def test_causal_with_key_ids_raises_in_the_kernel_wrappers():
    """As the Pallas kernel's entry does: its triangle compares global
    positions, where varlen causality is aligned per sequence."""
    x = torch.zeros(1, 128, NH * D)
    ids = torch.zeros(1, 128, dtype=torch.int32)
    lse = torch.zeros(1, 128, NH)
    for call in (lambda: fp.seg_fwd(x, x, x, ids, NH, segment_ids_k=ids),
                 lambda: fp.seg_dq(x, x, x, x, lse, lse, ids, NH,
                                   segment_ids_k=ids),
                 lambda: fp.seg_dkv(x, x, x, x, lse, lse, ids, NH,
                                    segment_ids_k=ids),
                 lambda: fp.flash_attention_packed_seg(
                     x, x, x, ids, NH, segment_ids_k=ids)):
        with pytest.raises(ValueError, match="distinct key-side"):
            call()


def test_cu_seqlens_to_segment_ids_matches_jax():
    for cu, total in (([0, 3, 3, 10], 12), ([0, 5], 5), ([0, 1, 2], 7)):
        want = _ids(cu, total)
        got = fp.cu_seqlens_to_segment_ids(torch.tensor(cu), total)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# -- nn.functional against the JAX package -----------------------------------

def _grads_vs_jax(fn_port, fn_jax, args, do):
    """The port's output and its grads through autograd against
    ``jax.vjp`` of the JAX function, on the same inputs and cotangent."""
    ts = [_t(a).requires_grad_() for a in args]
    out = fn_port(*ts)
    out.backward(_t(do))
    want, vjp = jax.vjp(fn_jax, *(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    for t, g in zip(ts, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL)
    return out.detach()


@pytest.mark.parametrize("same_cu,causal", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_flash_attn_unpadded_matches_jax(same_cu, causal):
    rng = np.random.RandomState(3 + 2 * same_cu + causal)
    cu_q = np.asarray([0, 50, 51, 120, 180], np.int32)
    cu_k = cu_q if same_cu else np.asarray([0, 70, 71, 160, 256], np.int32)
    tq, tk = 192, 192 if same_cu else 256
    q = (rng.randn(tq, NH, 32) * 0.5).astype(np.float32)
    k = (rng.randn(tk, NH, 32) * 0.5).astype(np.float32)
    v = rng.randn(tk, NH, 32).astype(np.float32)
    do = rng.randn(tq, NH, 32).astype(np.float32)
    scale = 0.2
    jcu_q = paddle.to_tensor(cu_q)
    jcu_k = jcu_q if same_cu else paddle.to_tensor(cu_k)
    want, none = JF.flash_attn_unpadded(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        jcu_q, jcu_k, 80, 90, scale, causal=causal)
    assert none is None
    tcu_q = _t(cu_q)
    tcu_k = tcu_q if same_cu else _t(cu_k)
    seg_q = jnp.asarray(_ids(cu_q, tq))[None]
    seg_k = None if same_cu else jnp.asarray(_ids(cu_k, tk))[None]

    def port(q, k, v):
        out, none = TF.flash_attn_unpadded(q, k, v, tcu_q, tcu_k, 80, 90,
                                           scale, causal=causal)
        assert none is None
        return out

    def dense(q, k, v):     # what the JAX function runs on the CPU
        return xla_segment_attention(q[None], k[None], v[None], seg_q,
                                     seg_k, scale=scale, causal=causal)[0]

    got = _grads_vs_jax(port, dense, (q, k, v), do)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    if not same_cu:         # q pads (past cu_q[-1]) see no key: 0
        assert float(got[180:].abs().max()) == 0.0


def test_causal_varlen_with_distinct_ids_raises_on_the_card():
    """The one varlen case no kernel computes: the CPU takes the dense
    plain version (above), any other device raises, never falling back."""
    meta = torch.empty(1, 64, NH * D, device="meta")
    ids = torch.zeros(1, 64, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md B.2"):
        disp.segment_attention_packed(meta, meta, meta, NH, ids, ids + 1,
                                      causal=True)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_segment_ids_matches_jax(causal):
    rng = np.random.RandomState(11 + causal)
    b, s = 2, 96
    q, k, v = ((rng.randn(b, s, NH, 32) * 0.5).astype(np.float32)
               for _ in range(3))
    seg = np.stack([np.repeat([0, 1, 2, -1], [30, 20, 40, 6]),
                    np.repeat([4, 4, 3, 9], [10, 30, 50, 6])]
                   ).astype(np.int32)
    want, _ = JF.flash_attention(*(paddle.to_tensor(x) for x in (q, k, v)),
                                 causal=causal,
                                 segment_ids=paddle.to_tensor(seg))
    got, none = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                   segment_ids=_t(seg))
    assert none is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    # key-side ids of their own (BERT's padding mask), full attention
    kid = np.where(np.arange(s)[None] < np.array([[70], [96]]), 0, -1)
    zeros = np.zeros((b, s), np.int32)
    got, _ = TF.flash_attention(_t(q), _t(k), _t(v), segment_ids=_t(zeros),
                                segment_ids_k=_t(kid.astype(np.int32)))
    want = xla_segment_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(zeros),
                                 jnp.asarray(kid), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("case", ["full", "causal", "full_rect",
                                  "causal_rect", "mask"])
def test_sdpa_matches_jax(case):
    rng = np.random.RandomState(len(case))
    b, sq, sk = 2, 48, 80 if case.endswith("rect") else 48
    q = (rng.randn(b, sq, NH, 32) * 0.5).astype(np.float32)
    k = (rng.randn(b, sk, NH, 32) * 0.5).astype(np.float32)
    v = rng.randn(b, sk, NH, 32).astype(np.float32)
    do = rng.randn(b, sq, NH, 32).astype(np.float32)
    causal = case.startswith("causal")
    mask = ((rng.rand(b, 1, 1, sk) > 0.3) - 1.0).astype(np.float32) * 1e9
    m = mask if case == "mask" else None
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=None if m is None else paddle.to_tensor(m),
        is_causal=causal)

    def port(q, k, v):
        return TF.scaled_dot_product_attention(
            q, k, v, attn_mask=None if m is None else _t(m),
            is_causal=causal)

    def dense(q, k, v):     # what the JAX function runs on the CPU
        return jax_sdpa_ref(q, k, v, None if m is None else jnp.asarray(m),
                            causal)

    got = _grads_vs_jax(port, dense, (q, k, v), do)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_unported_options_raise_on_every_device():
    """Attention dropout in ``scaled_dot_product_attention``,
    ``flash_attention`` (segment ids) and ``flash_attn_unpadded``: the
    port drops with its Philox bits (the kernels' DROP variants, their
    plain versions here), the JAX functions are fed those bits in place
    of their own; outputs and grads (atol 1e-5). ``return_softmax=True``
    still raises, as in the JAX package."""
    rng = np.random.RandomState(12)
    s, d = 40, 32
    q = (rng.randn(1, s, NH, d) * 0.5).astype(np.float32)
    k = (rng.randn(1, s, NH, d) * 0.5).astype(np.float32)
    v, do = (rng.randn(1, s, NH, d).astype(np.float32) for _ in range(2))
    seg = np.repeat(np.arange(4), 10)[None].astype(np.int32)
    cu = np.asarray([0, 13, 27, 40], np.int32)
    calls = {
        "sdpa": (lambda f, x: f.scaled_dot_product_attention(
            *x, dropout_p=0.1, is_causal=True)),
        "flash_attention": (lambda f, x: f.flash_attention(
            *x, dropout=0.1, causal=True,
            segment_ids=(paddle.to_tensor(seg) if f is JF else _t(seg)))[0]),
        "flash_attn_unpadded": (lambda f, x: f.flash_attn_unpadded(
            *(t[0] for t in x), *((paddle.to_tensor(cu),) * 2 if f is JF
                                  else (_t(cu),) * 2), s, s, 0.2,
            dropout=0.1, causal=True)[0]),
    }
    for name, call in calls.items():
        ts = [_t(a).requires_grad_() for a in (q, k, v)]
        with port_bits() as seen:
            out = call(TF, ts)
            out.backward(_t(do[0] if name == "flash_attn_unpadded" else do))
        assert len(seen) == 1, name
        js = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        with jax_bits([m.numpy() for m in seen.values()]):
            want = call(JF, js)
        want.backward(paddle.to_tensor(
            do[0] if name == "flash_attn_unpadded" else do))
        np.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                                   atol=ATOL, err_msg=name)
        for t, j in zip(ts, js):
            np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(),
                                       atol=ATOL, err_msg=name)
    x = torch.zeros(1, 8, NH, D)
    cu8 = torch.tensor([0, 8])
    for call in (lambda: TF.flash_attention(x, x, x, return_softmax=True),
                 lambda: TF.flash_attn_unpadded(x[0], x[0], x[0], cu8, cu8,
                                                8, 8, 0.1,
                                                return_softmax=True)):
        with pytest.raises(NotImplementedError, match="return_softmax"):
            call()
    # dropout that is not active (eval) draws no key and drops nothing
    with port_bits() as seen:
        got = TF.scaled_dot_product_attention(
            *(_t(a) for a in (q, k, v)), dropout_p=0.1, training=False)
    assert not seen
    np.testing.assert_allclose(got.numpy(), JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), dropout_p=0.1,
        training=False).numpy(), atol=ATOL)
    # a mask on a tensor with no kernel (meta) raises, never computed dense
    meta = torch.empty(1, 8, NH, D, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TF.scaled_dot_product_attention(meta, meta, meta,
                                        attn_mask=torch.zeros(1, 1, 1, 8))


def test_sequence_mask_matches_jax():
    """The JAX package's exact 0/1 mask in every dtype its
    ``framework.dtype`` knows (the 16-bit floats and 8-bit ints
    included)."""
    from paddle_tpu.framework.dtype import _BY_NAME

    lens = np.asarray([[3, 0], [5, 1]], np.int64)
    assert set(_BY_NAME) == set(TF.attention._DTYPES)
    cases = [(None, "int64"), (7, "float32"), (4, "bool")] + [
        (6, name) for name in sorted(_BY_NAME)]
    for maxlen, dtype in cases:
        want = JF.sequence_mask(paddle.to_tensor(lens), maxlen=maxlen,
                                dtype=dtype).numpy()
        got = TF.sequence_mask(_t(lens), maxlen=maxlen, dtype=dtype)
        np.testing.assert_array_equal(
            got.to(torch.complex128 if got.is_complex() else
                   torch.float64).numpy(), want.astype(
                np.complex128 if np.iscomplexobj(want) else np.float64))
        assert got.dtype == TF.attention._DTYPES[dtype], dtype


# -- the C entries and their ctypes signatures -------------------------------

_CTYPE = {"const void*": "P", "void*": "P", "int": "I", "float": "F",
          "unsigned long long": "U"}


def test_c_entries_match_their_ctypes_signatures():
    """Each ``extern "C"`` entry of ``csrc/*.cu``, parameter by
    parameter, against ``_build._SIGNATURES``: a pointer passed where the
    C side takes an int (or the reverse) is cut or misread on the card."""
    names = {"P": "c_void_p", "I": "c_int", "F": "c_float",
             "U": ctypes.c_uint64.__name__}
    entries = {}
    for src in _build.sources():
        text = Path(src).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()[:-1]) for p in
                      m.group(2).replace("\n", " ").split(",")]
            entries[m.group(1)] = [_CTYPE[p] for p in params]
    assert set(entries) == set(_build._SIGNATURES)
    for name, kinds in entries.items():
        got = [t.__name__ for t in _build._SIGNATURES[name]]
        assert got == [names[k] for k in kinds], name

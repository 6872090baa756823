"""The training kernels' plain PyTorch versions (K-PACK, K-DQ, K-DKV)
and ``FlashAttentionPacked`` against the JAX package's packed flash
kernels run in interpret mode, on the same numpy inputs (fp32, atol
1e-5). On the CPU every wrapper takes its plain version, so nothing here
launches a kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention_packed import (
    _dkv_call, _dq_call, _fwd_call)
from paddle_tpu.ops.pallas.flash_attention_packed import (
    flash_attention_packed as jax_flash_packed)
from paddle_tpu_torch.ops import attention_dispatch as disp
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

B, NH, D, BLOCK = 2, 2, 64, 128
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(sq, sk, seed):
    rng = np.random.RandomState(seed)
    hp = NH * D
    q = (rng.randn(B, sq, hp) * 0.5).astype(np.float32)
    k = (rng.randn(B, sk, hp) * 0.5).astype(np.float32)
    v = rng.randn(B, sk, hp).astype(np.float32)
    do = rng.randn(B, sq, hp).astype(np.float32)
    return q, k, v, do


# (Sq, Sk, causal): causal self-attention, full self-attention, and full
# attention with Sq != Sk (ring attention's off-diagonal blocks)
CASES = [(256, 256, True), (256, 256, False), (128, 256, False)]


@pytest.mark.parametrize("sq,sk,causal", CASES)
def test_packed_refs_match_pallas_interpret(sq, sk, causal):
    q, k, v, do = _data(sq, sk, seed=sq + sk + causal)
    scale = 1.0 / D ** 0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    want_o, want_lse = _fwd_call(jq, jk, jv, NH, scale, causal, BLOCK,
                                 BLOCK, True)
    o, lse = fp.packed_attention_ref(_t(q), _t(k), _t(v), NH, causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)

    # the backward pair on the SAME lse and delta on both sides
    delta = (do * np.asarray(want_o)).reshape(B, sq, NH, D).sum(-1)
    lse_np = np.asarray(want_lse)
    want_dq = _dq_call(jq, jk, jv, jdo, jnp.asarray(lse_np),
                       jnp.asarray(delta), NH, scale, causal, BLOCK, BLOCK,
                       True)
    want_dk, want_dv = _dkv_call(
        jq, jk, jv, jdo, jnp.asarray(lse_np.transpose(0, 2, 1)),
        jnp.asarray(delta.transpose(0, 2, 1)), NH, scale, causal, BLOCK,
        BLOCK, True)
    args = (_t(q), _t(k), _t(v), _t(do), _t(lse_np), _t(delta), NH)
    dq = fp.packed_dq_ref(*args, causal=causal)
    dk, dv = fp.packed_dkv_ref(*args, causal=causal)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=ATOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), atol=ATOL)

    # the wrappers take the plain versions on CPU tensors, launching none
    K.reset_launch_counts()
    o2, lse2 = fp.packed_fwd(_t(q), _t(k), _t(v), NH, causal=causal)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(fp.packed_dq(*args, causal=causal), dq)
    assert all(torch.equal(a, b) for a, b in
               zip(fp.packed_dkv(*args, causal=causal), (dk, dv)))
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_packed_grads_match_jax(causal):
    s = 256
    q, k, v, do = _data(s, s, seed=7 + causal)

    def loss_j(q, k, v):
        o = jax_flash_packed(q, k, v, NH, causal=causal, block_q=BLOCK,
                             block_k=BLOCK, bwd_block=BLOCK, interpret=True)
        return (o * jnp.asarray(do)).sum()

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                 for x in (q, k, v)))
    want_o = jax_flash_packed(*(jnp.asarray(x) for x in (q, k, v)), NH,
                              causal=causal, block_q=BLOCK, block_k=BLOCK,
                              interpret=True)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o = fp.flash_attention_packed(tq, tk, tv, NH, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               atol=ATOL)
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=f"d{name}")


def test_fused_qkv_slices_and_dispatch():
    """The training layout: q, k, v as column slices of one fused qkv
    (row stride 3*NH*D). Gradients reach the fused tensor through the
    slices, and ``causal_attention_packed`` is the same function."""
    rng = np.random.RandomState(11)
    s, hp = 96, NH * D                     # ragged: not a multiple of 64
    qkv = _t((rng.randn(B, s, 3 * hp) * 0.5).astype(np.float32))
    do = _t(rng.randn(B, s, hp).astype(np.float32))

    def run(fn, x):
        x = x.clone().requires_grad_()
        o = fn(x[..., :hp], x[..., hp:2 * hp], x[..., 2 * hp:], NH)
        return o, torch.autograd.grad(o, x, do)[0]

    o1, g1 = run(fp.flash_attention_packed, qkv)
    o2, g2 = run(disp.causal_attention_packed, qkv)
    dense = [t.contiguous() for t in qkv.split(hp, dim=-1)]
    o3, _ = fp.packed_attention_ref(*dense, NH)
    assert torch.equal(o1, o2) and torch.equal(g1, g2)
    np.testing.assert_allclose(o1.detach().numpy(), o3.numpy(), atol=ATOL)
    assert g1.shape == qkv.shape and bool(torch.isfinite(g1).all())


def test_dispatch_rejects_what_is_not_ported():
    x = torch.zeros(1, 64, NH * D)
    with pytest.raises(NotImplementedError, match="ring"):
        disp.causal_attention_packed(x, x, x, NH, ring=("mesh", "sep"))
    seg = torch.zeros(1, 64, dtype=torch.int32)
    # segment ids with a gradient now run the segmented backward (K-SDQ,
    # K-SDKV; their plain versions on the CPU): grads reach q, k and v
    xs = [torch.randn(1, 64, NH * D, generator=torch.Generator()
                      .manual_seed(i)).requires_grad_() for i in range(3)]
    o = disp.causal_attention_packed(*xs, NH, segment_ids=seg)
    grads = torch.autograd.grad(o.sum(), xs)
    assert o.shape == x.shape
    assert all(g.shape == x.shape and bool(torch.isfinite(g).all())
               and float(g.abs().max()) > 0 for g in grads)


def test_training_wrappers_never_fall_back_off_the_cpu():
    meta = torch.device("meta")
    x = torch.empty(1, 64, NH * D, device=meta)
    lse = torch.empty(1, 64, NH, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        fp.packed_fwd(x, x, x, NH)
    with pytest.raises(ValueError, match="no kernel"):
        fp.packed_dq(x, x, x, x, lse, lse, NH)
    with pytest.raises(ValueError, match="no kernel"):
        fp.packed_dkv(x, x, x, x, lse, lse, NH)


def test_row_layout_keeps_slices_and_copies_the_rest():
    qkv = torch.zeros(2, 5, 3 * 8)
    q = qkv[..., :8]
    t, rs = fp._rows(q, "t")
    assert t.data_ptr() == q.data_ptr() and rs == 24
    tr = torch.zeros(5, 2, 8).transpose(0, 1)      # batches interleaved
    t, rs = fp._rows(tr, "t")
    assert t.is_contiguous() and rs == 8
    one = torch.zeros(3, 1, 8)
    assert fp._rows(one, "t")[1] == 8

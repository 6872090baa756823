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
    _dkv_call, _dq_call, _fwd_call, _fwd_call_seg)
from paddle_tpu.ops.pallas.flash_attention_packed import (
    flash_attention_packed as jax_flash_packed)
from paddle_tpu_torch.ops import attention_dispatch as disp
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

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
    """Segment ids and a ring do not combine (as in the JAX package: the
    ring shards the sequence, the mask is per token); the ring itself is
    ported (``tests/test_torch_ring_attention.py``)."""
    x = torch.zeros(1, 64, NH * D)
    seg = torch.zeros(1, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="ring"):
        disp.causal_attention_packed(x, x, x, NH, ring=("mesh", "sep"),
                                     segment_ids=seg)
    # segment ids with a gradient now run the segmented backward (K-SDQ,
    # K-SDKV; their plain versions on the CPU): grads reach q, k and v
    xs = [torch.randn(1, 64, NH * D, generator=torch.Generator()
                      .manual_seed(i)).requires_grad_() for i in range(3)]
    o = disp.causal_attention_packed(*xs, NH, segment_ids=seg)
    grads = torch.autograd.grad(o.sum(), xs)
    assert o.shape == x.shape
    assert all(g.shape == x.shape and bool(torch.isfinite(g).all())
               and float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("wrapper", [
    "packed_fwd", "packed_dq", "packed_dkv", "seg_dq", "seg_dkv", "bshd_dq",
    "bshd_dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_wrappers_never_fall_back_off_the_cpu(monkeypatch, wrapper,
                                                       dtype):
    """A tensor that is not on the CPU never reaches a plain version: each
    training wrapper, the six backward ones included, goes to its launch
    path, which raises where there is no kernel."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version was called off the CPU")

    for mod, ref in ((fp, "packed_attention_ref"), (fp, "packed_dq_ref"),
                     (fp, "packed_dkv_ref"), (fp, "segment_dq_ref"),
                     (fp, "segment_dkv_ref"), (fa, "bshd_dq_ref"),
                     (fa, "bshd_dkv_ref")):
        monkeypatch.setattr(mod, ref, refuse)
    meta = torch.device("meta")
    x = torch.empty(1, 64, NH * D, dtype=dtype, device=meta)
    y = torch.empty(1, 64, NH, D, dtype=dtype, device=meta)
    lse = torch.empty(1, 64, NH, device=meta)
    seg = torch.empty(1, 64, dtype=torch.int32, device=meta)
    call = {
        "packed_fwd": lambda: fp.packed_fwd(x, x, x, NH),
        "packed_dq": lambda: fp.packed_dq(x, x, x, x, lse, lse, NH),
        "packed_dkv": lambda: fp.packed_dkv(x, x, x, x, lse, lse, NH),
        "seg_dq": lambda: fp.seg_dq(x, x, x, x, lse, lse, seg, NH),
        "seg_dkv": lambda: fp.seg_dkv(x, x, x, x, lse, lse, seg, NH),
        "bshd_dq": lambda: fa.bshd_dq(y, y, y, y, lse, lse),
        "bshd_dkv": lambda: fa.bshd_dkv(y, y, y, y, lse, lse),
    }[wrapper]
    with pytest.raises(ValueError, match="no kernel"):
        call()


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


def _seg_row(kind, s, rng):
    """Segment ids of one row of length ``s`` (256) at the edges of the
    card's 128-key tiles: segments starting mid-tile, single-token ones
    and a pad tail; unsorted runs with a recurring id, ids sharing their
    low 10 bits (1023 and -1, 7 and 1031) and the int32 extremes; or each
    token's id drawn from those ids."""
    ids = np.array([5, 2, 9, 2, 1023, -1, 7, 1031, 2 ** 31 - 1, -2 ** 31],
                   np.int64)
    if kind == "mid-tile":
        row = np.full(s, -1, np.int64)
        cuts = [0, 1, 2, 3, 50, 127, 128, 129, 200]
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            row[lo:hi] = i
    elif kind == "unsorted":
        lens = rng.multinomial(s - len(ids), np.ones(len(ids)) / len(ids))
        row = np.repeat(ids, lens + 1)
    else:
        row = rng.choice(ids, s)
    return row.astype(np.int32)[None]


@pytest.mark.parametrize("kind", ["mid-tile", "unsorted", "per-token"])
def test_segment_ref_matches_pallas_on_arbitrary_ids(kind):
    """K-SEG's plain version, which the card's kernel is held to, against
    the Pallas segmented forward in interpret mode on ids that are not
    sorted runs (fp32, atol 1e-5)."""
    rng = np.random.RandomState(21)
    s, nh, d = 256, 2, 64
    q, k, v = (rng.randn(1, s, nh * d).astype(np.float32) for _ in range(3))
    seg = _seg_row(kind, s, rng)
    want_o, want_lse = _fwd_call_seg(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), nh, 1.0 / d ** 0.5, True, BLOCK, BLOCK, True)
    o, lse = fp.seg_fwd(_t(q), _t(k), _t(v), _t(seg), nh)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_layout_keeps_fused_qkv_and_unbind_views_in_place(dtype):
    """The layouts the main path hands over are read where they lie: the
    fused qkv's column slices and the ``unbind`` views of
    ``(B, S, 3, H, D)``, row stride 3*H*D."""
    h, d = 4, 64
    qkv = torch.zeros(2, 5, 3 * h * d, dtype=dtype)
    for i in range(3):
        part = qkv[..., i * h * d:(i + 1) * h * d]
        t, rs = fp._rows(part, "t")
        assert t.data_ptr() == part.data_ptr() and rs == 3 * h * d
    views = fa._flat(*torch.zeros(2, 5, 3, h, d, dtype=dtype).unbind(2))
    for view in views:
        t, rs = fp._rows(view, "t")
        assert t.data_ptr() == view.data_ptr() and rs == 3 * h * d
    one_row = qkv[:, :1, :h * d]     # S = 1: rows step by the batch stride
    t, rs = fp._rows(one_row, "t")
    assert t.data_ptr() == one_row.data_ptr() and rs == 5 * 3 * h * d


@pytest.mark.parametrize("what", ["base", "stride", "slice offset"])
def test_row_layout_copies_what_tma_cannot_read(what):
    """A base address or row stride that is not a multiple of 16 bytes
    (the Hopper forward's TMA copies need both) is copied into a fresh
    dense tensor with the same values."""
    n = 2 * 5 * 64
    if what == "base":                # 2 bytes past an aligned allocation
        t = torch.arange(n + 1, dtype=torch.bfloat16)[1:].view(2, 5, 64)
    elif what == "stride":            # rows 68 elements = 136 bytes apart
        t = torch.arange(2 * 5 * 68, dtype=torch.bfloat16).view(
            2, 5, 68)[..., :64]
    else:                             # a column slice 8 bytes in
        t = torch.arange(2 * 5 * 192, dtype=torch.float32).view(
            2, 5, 192)[..., 2:66]
    assert t.data_ptr() % 16 or t.stride(1) * t.element_size() % 16
    out, rs = fp._rows(t, "t")
    assert out.data_ptr() != t.data_ptr() and out.is_contiguous()
    assert out.data_ptr() % 16 == 0 and rs == 64 and torch.equal(out, t)


def test_forward_wrappers_take_the_plain_version_only_on_the_cpu(
        monkeypatch):
    """A tensor that is not on the CPU never reaches a plain version: it
    goes to the launch path, which raises where there is no kernel."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version was called off the CPU")

    for mod, ref in ((fp, "packed_attention_ref"),
                     (fp, "segment_attention_ref"),
                     (fa, "causal_attention_ref")):
        monkeypatch.setattr(mod, ref, refuse)
    meta = torch.device("meta")
    x = torch.empty(1, 64, NH * D, dtype=torch.bfloat16, device=meta)
    seg = torch.empty(1, 64, dtype=torch.int32, device=meta)
    y = torch.empty(1, 64, NH, D, dtype=torch.bfloat16, device=meta)
    for call in (lambda: fp.packed_fwd(x, x, x, NH),
                 lambda: fp.packed_fwd(x, x, x, NH, causal=False),
                 lambda: fp.seg_fwd(x, x, x, seg, NH),
                 lambda: fa.bshd_fwd(y, y, y)):
        with pytest.raises(ValueError, match="no kernel"):
            call()

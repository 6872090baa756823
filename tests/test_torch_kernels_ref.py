"""The port's kernels' plain PyTorch versions against the JAX package's
functions they replace, on the same numpy inputs: the Pallas kernels in
interpret mode and their XLA references. On the CPU each wrapper takes
its plain version; a tensor on any other non-CUDA device raises, it
never falls back."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.attention_dispatch import (xla_causal_attention,
                                               xla_segment_attention)
from paddle_tpu.ops.pallas.flash_attention import (_flash_call,
                                                   flash_attention_bshd)
from paddle_tpu.ops.pallas.flash_attention_packed import _fwd_call_seg
from paddle_tpu.ops.pallas.paged_attention import (paged_attention_xla,
                                                   paged_decode_attention)
from paddle_tpu_torch.ops import attention_dispatch as disp
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp
from paddle_tpu_torch.ops.kernels import paged_attention as pa

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("nh,nh_kv", [(4, 4), (4, 2)])
def test_paged_attention_ref_matches_jax(nh, nh_kv):
    rng = np.random.RandomState(0)
    b, d, ps, maxp = 3, 16, 4, 4
    P = 1 + b * maxp
    q = rng.randn(b, nh, d).astype(np.float32)
    kp = rng.randn(P, ps, nh_kv * d).astype(np.float32)
    vp = rng.randn(P, ps, nh_kv * d).astype(np.float32)
    lens = np.asarray([13, 4, 0], np.int32)  # multi-page, 1-page, pad row
    pt = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, P))  # random non-contiguous pages
    i = 0
    for r in range(b):
        n = -(-int(lens[r]) // ps)
        pt[r, :n] = perm[i:i + n]
        i += n
    args = [jnp.asarray(x) for x in (q, kp, vp, pt, lens)]
    want_kernel = np.asarray(paged_decode_attention(*args, interpret=True))
    want_xla = np.asarray(paged_attention_xla(*args))
    K.reset_launch_counts()
    targs = [_t(x) for x in (q, kp, vp, pt, lens)]
    for got in (pa.paged_attention_ref(*targs),
                pa.paged_decode_attention(*targs),
                disp.paged_attention(*targs)):
        got = got.numpy()
        np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want_xla, rtol=2e-5, atol=2e-5)
        assert np.all(got[2] == 0.0)  # seq_len 0 padding row -> zeros
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    assert {"K-DEC", "K-SEG", "K-BSHD"} <= set(K.KERNELS)


def _segments(s, bounds):
    seg = np.full((1, s), -1, np.int32)   # -1: the pad tail
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[0, lo:hi] = i
    return seg


def test_segment_ref_matches_pallas_seg_kernel_interpret():
    rng = np.random.RandomState(1)
    s, nh, d = 128, 2, 64
    q, k, v = (rng.randn(1, s, nh * d).astype(np.float32) for _ in range(3))
    seg = _segments(s, [0, 37, 70, 110])  # three segments + pad tail
    scale = 1.0 / d ** 0.5
    want_o, want_lse = _fwd_call_seg(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), nh, scale, True, 64, 64, True)
    o, lse = fp.flash_attention_packed_segmented(_t(q), _t(k), _t(v),
                                                 _t(seg), nh)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)
    oo = disp.segment_attention_packed(_t(q), _t(k), _t(v), nh, _t(seg))
    assert torch.equal(oo, o)
    # causal with distinct key-side ids has no kernel: the CPU takes the
    # dense plain version (the JAX package's dense path), CUDA raises
    want_dense = np.asarray(xla_segment_attention(
        *(jnp.asarray(x).reshape(1, s, nh, d) for x in (q, k, v)),
        jnp.asarray(seg), jnp.asarray(seg)))
    od = disp.segment_attention_packed(_t(q), _t(k), _t(v), nh, _t(seg),
                                       seg_k=_t(seg))
    np.testing.assert_allclose(od.numpy().reshape(1, s, nh, d), want_dense,
                               rtol=1e-5, atol=1e-5)
    meta = torch.empty(1, s, nh * d, device="meta")
    with pytest.raises(NotImplementedError):
        disp.segment_attention_packed(meta, meta, meta, nh, _t(seg),
                                      seg_k=_t(seg))


def test_segment_ref_matches_xla_segment_attention_ragged():
    rng = np.random.RandomState(2)
    s, nh, d = 96, 2, 32
    q, k, v = (rng.randn(1, s, nh, d).astype(np.float32) for _ in range(3))
    seg = _segments(s, [0, 20, 61, 90])
    want = np.asarray(xla_segment_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg)))
    o, lse = fp.segment_attention_ref(_t(q).reshape(1, s, nh * d),
                                      _t(k).reshape(1, s, nh * d),
                                      _t(v).reshape(1, s, nh * d),
                                      _t(seg), nh)
    np.testing.assert_allclose(o.numpy().reshape(1, s, nh, d), want,
                               rtol=1e-5, atol=1e-5)
    # lse: the log of each row's masked softmax normaliser, in numpy
    lg = np.einsum("bqhd,bkhd->bhqk", q / np.sqrt(d), k)
    ok = (seg[:, :, None] == seg[:, None, :]) & np.tril(
        np.ones((s, s), bool))[None]
    lg = np.where(ok[:, None], lg, -np.inf)
    mx = lg.max(-1, keepdims=True)
    want_lse = (mx + np.log(np.exp(lg - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse.transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)


def test_bshd_ref_matches_pallas_flash_interpret():
    rng = np.random.RandomState(3)
    b, s, h, d = 2, 128, 2, 64
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    want = np.asarray(flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))

    def bhsd(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))

    _, want_lse = _flash_call(bhsd(q), bhsd(k), bhsd(v), 1.0 / d ** 0.5,
                              True, 128, 128, True)
    want_lse = np.asarray(want_lse).reshape(b, h, s).transpose(0, 2, 1)
    o, lse = fa.flash_attention_bshd(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(o.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(disp.causal_attention(_t(q), _t(k), _t(v)), o)


def test_bshd_ref_matches_xla_causal_attention_ragged():
    rng = np.random.RandomState(4)
    b, s, h, d = 2, 80, 3, 32
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    want = np.asarray(xla_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    o, _ = fa.causal_attention_ref(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes
    to the kernel's launch path, which raises where it has no kernel."""
    meta = torch.device("meta")
    q = torch.empty(2, 4, 64, device=meta)
    pool = torch.empty(3, 8, 256, device=meta)
    pt = torch.empty(2, 2, dtype=torch.int32, device=meta)
    sl = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_decode_attention(q, pool, pool, pt, sl)
    # K-MQ, and the int8 entries K-DEC8 and K-MQ8
    pool8 = torch.empty(3, 8, 256, dtype=torch.int8, device=meta)
    scales = torch.empty(3, 2, 4, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_multiquery_attention(q[:, None].expand(2, 5, 4, 64), pool,
                                      pool, pt, sl)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_decode_attention(q, pool8, pool8, pt, sl, scales=scales)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_multiquery_attention(q[:, None], pool8, pool8, pt, sl,
                                      scales=scales)
    x = torch.empty(1, 64, 256, device=meta)
    seg = torch.empty(1, 64, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        fp.flash_attention_packed_segmented(x, x, x, seg, 4)
    y = torch.empty(1, 64, 4, 64, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_bshd(y, y, y)

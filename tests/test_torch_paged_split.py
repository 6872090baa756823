"""The paged kernels' split over chunks of pages and their merge, stated in
plain PyTorch (``paged_split_ref``), against the JAX package's paged
attention on the same numpy inputs: the XLA references and the Pallas
``_decode_kernel`` / ``_mq_kernel`` in interpret mode. Lengths sit on both
sides of the chunk edges, at the whole table and past it; windows straddle
an edge or are longer than the context; GQA groups 1 and 4, int8 pools and
page sizes 4 and 16. And the wrapper's launch: its grid and workspace come
from the shapes alone, with no value of ``seq_lens`` read on the host."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention_xla, paged_decode_attention, paged_multiquery_attention,
    paged_multiquery_attention_xla)
from paddle_tpu_torch.ops.kernels import paged_attention as pa

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

_TABLE = 640             # tokens a page table reaches: 2.5 chunks of 256
_LENS = {                # per window length: chunk edges, table, past it
    1: [0, 1, 255, 256, 257, _TABLE, _TABLE + 13],
    5: [0, 3, 258, 260, 514, _TABLE, _TABLE + 13],
    8: [0, 5, 259, 263, 515, _TABLE, _TABLE + 13],
}


def _inputs(seed, qlen, nh, nh_kv, d, ps, int8):
    rng = np.random.RandomState(seed)
    lens = np.asarray(_LENS[qlen], np.int32)
    b, maxp = len(lens), _TABLE // ps
    n_pages = 1 + b * maxp
    q = rng.randn(b, qlen, nh, d).astype(np.float32)
    if int8:
        kp, vp = (rng.randint(-127, 128, (n_pages, ps, nh_kv * d))
                  .astype(np.int8) for _ in range(2))
        sc = rng.uniform(0.01, 0.03, (n_pages, 2, nh_kv)).astype(np.float32)
    else:
        kp, vp = (rng.randn(n_pages, ps, nh_kv * d).astype(np.float32)
                  for _ in range(2))
        sc = None
    pt = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    used = 0
    for r in range(b):
        n = min(maxp, -(-int(lens[r]) // ps))
        pt[r, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, pt, lens, sc


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("qlen", [1, 5, 8])
@pytest.mark.parametrize("nh,nh_kv", [(4, 4), (4, 1)])
@pytest.mark.parametrize("ps", [4, 16])
def test_split_ref_matches_jax(ps, nh, nh_kv, qlen, int8):
    q, kp, vp, pt, lens, sc = _inputs(ps * 100 + qlen * 10 + nh_kv, qlen,
                                      nh, nh_kv, 16, ps, int8)
    chunk_pages, n_chunks = pa.split_plan(ps, pt.shape[1])
    assert chunk_pages * ps == 256 and n_chunks == 3
    j = [jnp.asarray(x) for x in (q, kp, vp, pt, lens)]
    js = None if sc is None else jnp.asarray(sc)
    if qlen == 1:
        want_xla = np.asarray(paged_attention_xla(j[0][:, 0], *j[1:],
                                                  scales=js))[:, None]
    else:
        want_xla = np.asarray(paged_multiquery_attention_xla(*j, scales=js))
    # the Pallas kernels in interpret mode, every other case (each call
    # walks all B x max_pages grid steps)
    want_kernel = None
    if int8 == (nh_kv == 1):
        want_kernel = np.asarray(
            paged_decode_attention(j[0][:, 0], *j[1:], scales=js,
                                   interpret=True)[:, None]
            if qlen == 1 else
            paged_multiquery_attention(*j, scales=js, interpret=True))
    t = [torch.from_numpy(x) for x in (q, kp, vp, pt, lens)]
    got = pa.paged_split_ref(*t, scales=None if sc is None
                             else torch.from_numpy(sc)).numpy()
    assert got.shape == q.shape
    for want in (want_xla, want_kernel):
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[0] == 0.0)                    # seq_len 0
    short = lens[1]                                 # a context < qlen
    assert np.all(got[1, :max(0, qlen - short)] == 0.0)
    assert np.all(np.isfinite(got))


def test_split_ref_matches_the_dense_plain_version_in_bf16():
    q, kp, vp, pt, lens, _ = _inputs(7, 5, 8, 2, 64, 16, False)
    t = [torch.from_numpy(x) for x in (q, kp, vp, pt, lens)]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    got = pa.paged_split_ref(*t)
    want = pa.paged_multiquery_attention_ref(*t)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2)


@pytest.mark.parametrize("qlen,nh,nh_kv,d,tc,rows,tiles", [
    (1, 16, 16, 64, False, 1, 1),     # K-DEC, GPT-345M
    (5, 16, 16, 64, False, 8, 1),     # K-MQ at k=4, fp32
    (1, 16, 4, 64, False, 4, 1),      # GQA 4
    (5, 16, 4, 64, False, 8, 3),      # 20 rows a kv head
    (8, 16, 4, 128, False, 4, 8),     # 32 rows at d 128
    (3, 8, 8, 128, False, 4, 1),
    # bf16 q and pools: 4 rows or more take the tensor cores, 16 a CTA
    (1, 16, 16, 64, True, 1, 1),
    (3, 8, 8, 64, True, 4, 1),
    (5, 16, 16, 64, True, 16, 1),
    (1, 16, 4, 64, True, 16, 1),
    (8, 16, 4, 128, True, 16, 2),
])
def test_launch_plan_comes_from_shapes(qlen, nh, nh_kv, d, tc, rows, tiles):
    plan = pa.launch_plan(32, qlen, nh, nh_kv, d, 16, 64, tensor_cores=tc)
    assert plan["chunk_pages"] == 16 and plan["n_chunks"] == 4
    assert (plan["rows_per_cta"], plan["row_tiles"]) == (rows, tiles)
    assert plan["grid"] == (4 * tiles, 32, nh_kv)
    assert plan["workspace"] == (4, 32, qlen, nh, d + 2)
    # one chunk: the split kernel writes the output, no workspace
    one = pa.launch_plan(32, qlen, nh, nh_kv, d, 16, 16, tensor_cores=tc)
    assert one["n_chunks"] == 1 and one["workspace"] is None
    # page sizes past a chunk take one page a chunk
    assert pa.split_plan(512, 3) == (1, 3)
    assert pa.split_plan(1, 1000) == (256, 4)


class _Watched(torch.Tensor):
    """Records every torch function called on it."""
    calls = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        cls.calls.append(func)
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("entry,qlen,dtype,rows", [
    ("paged_attention_decode", 1, torch.float32, 1),
    ("paged_attention_multiquery", 5, torch.float32, 8),
    ("paged_attention_multiquery", 5, torch.bfloat16, 16),
])
def test_kernel_args_never_read_seq_lens(entry, qlen, dtype, rows):
    """The C entry's arguments, the output and the workspace come from
    shapes, dtypes and pointers: equal for any lengths, and no torch call
    but those reads touches ``seq_lens`` or the page table."""
    b, nh, d, ps, maxp = 3, 4, 64, 16, 40
    q = torch.zeros(b, qlen, nh, d, dtype=dtype)
    pool = torch.zeros(9, ps, nh * d, dtype=dtype)
    allowed = {torch.Tensor.shape.__get__, torch.Tensor.dtype.__get__,
               torch.Tensor.device.__get__, torch.Tensor.is_contiguous,
               torch.Tensor.data_ptr, torch.Tensor.dim}
    seen = []
    for lens in ([0, 0, 0], [1, 640, 9999]):
        _Watched.calls = []
        sl = torch.tensor(lens, dtype=torch.int32).as_subclass(_Watched)
        pt = torch.zeros(b, maxp, dtype=torch.int32).as_subclass(_Watched)
        out, args, ws = pa._kernel_args(entry, q, pool, pool, pt, sl, None,
                                        None)
        assert set(_Watched.calls) <= allowed, set(_Watched.calls) - allowed
        assert out.shape == q.shape and ws.shape == (3, b, qlen, nh, d + 2)
        ptrs = {sl.data_ptr(), pt.data_ptr(), out.data_ptr(), ws.data_ptr()}
        seen.append(tuple(a for a in args if a not in ptrs))
    assert seen[0] == seen[1]
    assert seen[0][-4:-2] == (16, rows)          # chunk pages, rows a CTA

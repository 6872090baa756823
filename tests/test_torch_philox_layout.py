"""The flash kernels' dropout keep bits and the wgmma fragment layout.

``csrc/philox.cuh`` counts element ``(b, h, i, j)`` by Philox counter
``(j', i', b*H + h, offset)``, ``x' = ((x >> 4) << 3) | (x & 7)``, word
``2 * bit3(i) + bit3(j)``, so that one call gives four entries one
thread holds in an m64nNk16 accumulator fragment. Here:

- ``philox.keep_mask`` against that formula applied element by element;
- a model of the fragment (thread (warp w, lane l) holds ``d[4j + 2hr +
  e]`` at row ``16w + l/4 + 8hr``, column ``8j + 2(l%4) + e``): each
  thread's entries fall into groups of four that share one counter, with
  queries as rows (the forward, dQ) and with keys as rows (dK/dV), at
  the kernels' tiles;
- ``frag_keep``'s placement of the four words, walked over every tile of
  a ragged problem, against ``keep_mask``; for dQ
  along its schedule (the next tile's bits drawn under the current
  tile's dQ product, the first tile's and one's after a tile skipped for
  its segment ids at their turn).
"""
import pytest
import torch

from paddle_tpu_torch.ops.kernels import philox

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

P = 0.1


def _half(x):
    return ((x >> 4) << 3) | (x & 7)


def _bit3(x):
    return (x >> 3) & 1


def test_keep_mask_is_the_element_formula():
    shape = (2, 3, 70, 101)
    rng = (7 + 5 * 2 ** 40, 9 + 3 * 2 ** 33)
    b, h, sq, sk = shape
    bh = torch.arange(b * h)[:, None, None]
    i = torch.arange(sq)[None, :, None]
    j = torch.arange(sk)[None, None]
    seed, offset = rng
    key = (seed % 2 ** 32, (seed >> 32) ^ (offset >> 32))
    words = philox.philox4x32_10((_half(j), _half(i), bh, offset % 2 ** 32),
                                 key)
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    w = (2 * _bit3(i) + _bit3(j)).expand(b * h, sq, sk)[..., None]
    want = torch.gather(words, -1, w)[..., 0] < philox.threshold(P)
    assert torch.equal(philox.keep_mask(rng, P, shape),
                       want.reshape(shape))
    # one element by hand: (b, h, i, j) = (1, 2, 69, 100), so bh = 5, word
    # 0 (bit 3 clear in 69 and 100) of counter (100', 69', 5, offset)
    r = [int(x) for x in philox.philox4x32_10(
        (52, 37, 5, offset % 2 ** 32), key)]
    assert _half(100) == 52 and _half(69) == 37
    assert bool(philox.keep_mask(rng, P, shape)[1, 2, 69, 100]) == (
        r[0] < philox.threshold(P))


def _fragment(r0, c0, n):
    """{thread: [(index, row, col)]} of a 64 x n accumulator fragment whose
    first row is ``r0`` and first column ``c0``."""
    out = {}
    for tid in range(128):
        w, lane = tid // 32, tid % 32
        t = lane % 4
        ent = []
        for jj in range(n // 8):
            for hr in range(2):
                for e in range(2):
                    ent.append((4 * jj + 2 * hr + e,
                                r0 + 16 * w + lane // 4 + 8 * hr,
                                c0 + 8 * jj + 2 * t + e))
        out[tid] = ent
    return out


# (what, n, first row, first column, rows are keys): the forward at d 64
# (BK 128) and d 128 (BK 64) for warpgroup 1 of a 128-row q-block; dQ's
# 64-key tiles; dK/dV's 64-query tiles (QT 64) at d 64 and d 128 alike
TILES = [("fwd d64", 128, 128 + 64, 256, False),
         ("fwd d128", 64, 384 + 64, 64, False),
         ("dq", 64, 192, 128, False),
         ("dkv", 64, 128, 320, True)]


@pytest.mark.parametrize("what,n,r0,c0,keys_by_row", TILES,
                         ids=[t[0] for t in TILES])
def test_fragment_entries_group_by_four_per_counter(what, n, r0, c0,
                                                    keys_by_row):
    for tid, ent in _fragment(r0, c0, n).items():
        groups = {}
        for idx, row, col in ent:
            i, j = (col, row) if keys_by_row else (row, col)
            groups.setdefault((_half(j), _half(i)), []).append(
                (2 * _bit3(i) + _bit3(j), idx))
        # a call per four entries: 16 at BK 128, 8 at 64 (32 and 32 in the
        # one-call-per-pair and one-call-per-entry layouts before)
        assert len(groups) == n // 8, (what, tid)
        for g in groups.values():
            assert sorted(w for w, _ in g) == [0, 1, 2, 3], (what, tid, g)
        # frag_keep's placement: call (u, e) puts words x, y, z, w at
        # d[n0], d[n0 + YO], d[n0 + 6 - YO], d[n0 + 6], n0 = 8u + e
        yo = 2 if keys_by_row else 4
        for g in groups.values():
            at = dict(g)
            n0 = at[0]
            assert (at[1], at[2], at[3]) == (n0 + yo, n0 + 6 - yo, n0 + 6)
            assert n0 % 8 in (0, 1), (what, tid, g)


def _tile_calls(bh, rb, rows_blk, cb, n, keys_by_row):
    """``frag_keep``'s calls for one tile (rows ``rb ..``, columns ``cb
    ..``), every column block: ``[(bh, [(i, j) of words x, y, z, w])]``;
    entries past Sq or Sk are drawn and dropped by ``_scatter``."""
    calls = []
    for wgr in range(0, rows_blk, 64):
        for tid in range(128):
            w, lane = tid // 32, tid % 32
            t = lane % 4
            r0 = rb + wgr + 16 * w + lane // 4
            for u in range(n // 16):
                for e in range(2):
                    c = cb + 16 * u + 2 * t + e
                    if keys_by_row:       # r0 a key, c a query
                        ij = [(c, r0), (c, r0 + 8),
                              (c + 8, r0), (c + 8, r0 + 8)]
                    else:
                        ij = [(r0, c), (r0, c + 8),
                              (r0 + 8, c), (r0 + 8, c + 8)]
                    calls.append((bh, ij))
    return calls


def _scatter(rng, p, b, h, sq, sk, calls):
    """The calls' bits scattered to (B, H, Sq, Sk); -1 where no call was
    made."""
    k0, k1, off = philox.key_words(rng)
    bh = torch.tensor([c[0] for c in calls])
    i = torch.tensor([c[1][0][0] for c in calls])
    j = torch.tensor([c[1][0][1] for c in calls])
    words = philox.philox4x32_10((_half(j), _half(i), bh, off), (k0, k1))
    kept = torch.stack(words, dim=-1) < philox.threshold(p)
    out = torch.full((b * h, sq, sk), -1, dtype=torch.int8)
    for n_call, (x, ij) in enumerate(calls):
        for wd, (ii, jj) in enumerate(ij):
            if ii < sq and jj < sk:
                assert out[x, ii, jj] == -1     # each entry drawn once
                out[x, ii, jj] = int(kept[n_call, wd])
    return out.reshape(b, h, sq, sk)


def _kernel_mask(rng, p, b, h, sq, sk, causal, keys_by_row, rows_blk, n):
    """The keep bits a kernel draws, walked tile by tile as ``frag_keep``
    places them, scattered back to (B, H, Sq, Sk); -1 where no call was
    made."""
    nr, nc = (sk, sq) if keys_by_row else (sq, sk)
    calls = []          # (bh, [(i, j) of words x, y, z, w])
    for bh in range(b * h):
        for rb in range(0, nr, rows_blk):
            for cb in range(0, nc, n):
                if causal and not keys_by_row and cb > rb + rows_blk - 1:
                    continue            # tiles the kernels never visit
                if causal and keys_by_row and cb + n - 1 < rb:
                    continue
                calls += _tile_calls(bh, rb, rows_blk, cb, n, keys_by_row)
    return _scatter(rng, p, b, h, sq, sk, calls)


def _dq_mask(rng, p, b, h, sq, sk, causal, skipped):
    """dQ's schedule (``flash_dq_kernel_sm90``): per 64-row q-block, the
    64-key tiles up to ``kend`` that the producer does not skip (``(q0,
    k0)`` in ``skipped`` stand for tiles its segment-id test drops). A
    tile uses the bits drawn at its turn when they were not drawn for it
    under the previous tile's dQ product (the first tile, a tile after a
    skipped one), else those; after each tile's product is issued the
    next tile's bits are drawn when it lies below ``kend``. Returns the
    bits the visited tiles used, scattered, and how each tile got them."""
    calls, how = [], []
    for bh in range(b * h):
        for q0 in range(0, sq, 64):
            kend = min(sk, q0 + 64) if causal else sk
            kept_k0, pending = -1, None
            for k0 in range(0, kend, 64):
                if (q0, k0) in skipped:
                    continue
                if k0 != kept_k0:
                    how.append("at its turn")
                    used = (k0, _tile_calls(bh, q0, 64, k0, 64, False))
                else:
                    how.append("under the last product")
                    used = pending
                assert used[0] == k0            # the bits are this tile's
                calls += used[1]
                kept_k0 = k0 + 64
                if kept_k0 < kend:
                    pending = (kept_k0, _tile_calls(bh, q0, 64, kept_k0, 64,
                                                    False))
    return _scatter(rng, p, b, h, sq, sk, calls), how


@pytest.mark.parametrize("kernel,causal", [("fwd", True), ("dkv", True),
                                           ("dkv", False), ("dq", True),
                                           ("dq", False)])
def test_frag_keep_walk_matches_keep_mask(kernel, causal):
    """Every visible entry of a ragged causal problem gets the bit
    ``keep_mask`` gives it, from the tile that holds it, and no entry is
    drawn twice (every column block of a visited tile is drawn). dQ walks
    its schedule with one key tile of the last q-block skipped (as its
    segment-id test would skip it): a first tile's bits drawn at its
    turn, a next tile's under the previous product, the tile after the
    skip at its turn again."""
    b, h, s = 1, 2, 150
    sq, sk = (s, s) if causal else (90, 150)
    rng = (11, 13)
    skipped = ()
    if kernel == "fwd":     # d 64: 128-row q-blocks, BK 128
        got = _kernel_mask(rng, P, b, h, sq, sk, causal, False, 128, 128)
    elif kernel == "dkv":   # 64-key blocks, QT 64
        got = _kernel_mask(rng, P, b, h, sq, sk, causal, True, 64, 64)
    else:                   # 64-row q-blocks, 64-key tiles
        skipped = ((128 if causal else 64, 64),)
        got, how = _dq_mask(rng, P, b, h, sq, sk, causal, skipped)
        assert how[:1] == ["at its turn"]
        assert "under the last product" in how
        # the tile at 128 follows the skipped one in the last q-block
        assert how[-1] == "at its turn"
    want = philox.keep_mask(rng, P, (b, h, sq, sk))
    vis = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        vis = vis.tril()
    for q0, k0 in skipped:  # entries the segment ids mask
        vis[q0:q0 + 64, k0:k0 + 64] = False
    vis = vis.expand(b, h, sq, sk)
    assert (got[vis] >= 0).all()
    assert torch.equal(got[vis].bool(), want[vis])
    drawn = got >= 0
    assert torch.equal(got[drawn].bool(), want[drawn])

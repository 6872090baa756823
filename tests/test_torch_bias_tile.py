"""The bf16 flash kernels' BIAS tile, modelled on the CPU.

The Hopper bodies (``csrc/flash_fwd.cuh``, ``csrc/flash_bwd.cuh``) no
longer read a mask entry by entry from device memory: the producer warp
stages each ring stage's bias tile in shared memory (``csrc/philox.cuh``
``BiasTile``, ``stage_bias``), by TMA or by cp.async as
``flash_attention_packed.bias_route`` decides, and the consumers read
their fragment entries from it at a row pitch (0 when the mask
broadcasts over queries). Here, for every layout ``bias_view`` passes
(a padding mask ``(B, 1, 1, Sk)``, a causal ``(Sq, Sk)`` mask, a full
``(B, H, Sq, Sk)`` bias, a transposed view, rows that are not 16-byte
multiples, a ``(Sq, 1)`` column, an unaligned base):

- ``bias_route``'s strides and route;
- a plain model of the copy (a TMA box of the map ``make_bias_map``
  encodes, or the cp.async loop) and of each kernel's fragment reads:
  every entry that a thread of the forward (d 64 and d 128), dQ or dK/dV
  reads from the tile at its pitch is the element ``bias_view`` holds
  there;
- the reads' shared-memory banks: no two lanes of a load meet on a bank
  with different words (the layout the header comments describe);
- the port's SDPA with the transposed and column masks against the JAX
  package's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

B, H = 2, 3

# (kernel: rows of the CTA's query block or tile, key columns, pitch,
# warpgroups, fragment rows are keys) as csrc's BiasTile instantiations
KERNELS = {"fwd d64": (128, 128, 136, 2, False),
           "fwd d128": (128, 64, 72, 2, False),
           "dq": (64, 64, 72, 1, False),
           "dkv": (64, 64, 68, 1, True)}


def _mask(kind, sq, sk, rng):
    """A mask of ``kind`` and the route ``bias_route`` must give it."""
    if kind == "padding":
        lens = rng.randint(1, sk + 1, B)
        m = (np.arange(sk)[None] < lens[:, None]).astype(np.float32)
        return torch.from_numpy((m - 1) * 1e9)[:, None, None, :]
    if kind == "causal":
        return torch.zeros(sq, sk).masked_fill(
            torch.ones(sq, sk, dtype=torch.bool).triu(1), float("-inf"))
    if kind == "full":
        return torch.from_numpy(rng.randn(B, H, sq, sk).astype(np.float32))
    if kind == "transposed":
        return torch.from_numpy(rng.randn(sk, sq).astype(np.float32)).mT
    if kind == "column":
        return torch.from_numpy(rng.randn(sq, 1).astype(np.float32))
    if kind == "unaligned":      # a view one float into its storage
        flat = torch.from_numpy(rng.randn(1 + sq * sk).astype(np.float32))
        return flat[1:].view(sq, sk)
    raise ValueError(kind)


# (kind, Sq, Sk, TMA): rows of 256 floats are 16-byte multiples, rows of
# 129 are not
LAYOUTS = [("padding", 200, 256, True), ("padding", 129, 129, False),
           ("causal", 256, 256, True), ("causal", 129, 129, False),
           ("full", 130, 200, True), ("full", 70, 129, False),
           ("transposed", 150, 96, False), ("column", 150, 256, False),
           ("unaligned", 96, 256, False)]


def _storage(view):
    """The view's storage as one flat fp32 tensor, and its offset."""
    n = view.untyped_storage().nbytes() // 4
    return torch.as_strided(view, (n,), (1,), 0), view.storage_offset()


def _stage(view, strides, tma, tile, b, h, q0, k0):
    """The stage's tile as ``stage_bias`` leaves it: ``rows x pitch``
    floats (1 row at a query stride of 0), NaN where nothing was
    written."""
    rows, cols, pitch = tile
    sb, sh, sq_, sk_ = strides
    Sq, Sk = view.shape[2:]
    flat, off = _storage(view)
    nrows = rows if sq_ else 1
    out = torch.full((nrows, pitch), float("nan"))
    r = torch.arange(nrows)[:, None]
    if tma:
        # the box of make_bias_map's 4-D map at coordinates (k0, q0 or 0,
        # h or 0, b or 0), zero-filled out of bounds
        c = torch.arange(pitch)[None]
        q = (q0 if sq_ else 0) + r
        k = k0 + c
        inb = (q < (Sq if sq_ else 1)) & (k < Sk)
        at = (off + (b if sb else 0) * sb + (h if sh else 0) * sh
              + q * sq_ + k * sk_)
        out = torch.where(inb, flat[at.clamp(0, flat.numel() - 1)], 0.0)
        return out
    # cp.async: the ROWS x COLS entries inside (Sq, Sk), one float each
    c = torch.arange(cols)[None]
    q, k = q0 + r, k0 + c
    inb = (q < Sq) & (k < Sk) if sq_ else (k < Sk).expand(nrows, cols)
    at = off + b * sb + h * sh + q * sq_ + k * sk_
    vals = flat[torch.where(inb, at, off)]
    out[:, :cols] = torch.where(inb, vals, out[:, :cols])
    return out


def _reads(kernel, q0, k0, bp):
    """Every fragment entry a kernel's consumer threads read from the tile:
    ``(query, key, word address, (thread, load))``, as the kernels index
    it (the forward and dQ a float2 per two adjacent keys at row offset
    ``(row0 - q0) * bp + 2t`` plus ``8 hr bp + 8 j``; dK/dV a float per
    entry at ``(key0 - k0) + col * bp + 8 hr``)."""
    rows, cols, pitch, wgs, keys_by_row = KERNELS[kernel]
    tid = torch.arange(128 * wgs)
    wg, w, lane = tid // 128, (tid // 32) % 4, tid % 32
    t = lane % 4
    out = []
    for j in range(cols // 8):
        for hr in range(2):
            for e in range(2):
                if keys_by_row:
                    key0 = k0 + 16 * w + lane // 4
                    key = key0 + 8 * hr
                    col = 8 * j + 2 * t + e
                    q = q0 + col
                    addr = (key0 - k0) + col * bp + 8 * hr
                else:
                    row0 = q0 + 64 * wg + 16 * w + lane // 4
                    q = row0 + 8 * hr
                    key = k0 + 8 * j + 2 * t + e
                    addr = (row0 - q0) * bp + 2 * t + 8 * hr * bp + 8 * j + e
                out.append((q, key, addr, (j, hr, e)))
    return out


@pytest.mark.parametrize("kind,sq,sk,tma", LAYOUTS,
                         ids=[f"{x[0]}-{x[1]}x{x[2]}" for x in LAYOUTS])
def test_route_and_staged_reads_match_bias_view(kind, sq, sk, tma):
    rng = np.random.RandomState(sq + sk)
    view = fp.bias_view(_mask(kind, sq, sk, rng), B, H, sq, sk)
    strides, got_tma = fp.bias_route(view)
    assert got_tma == tma
    # a dimension of size 1 or broadcast reads at stride 0
    for n, st, want in zip(view.shape, strides, view.stride()):
        assert st == (0 if n == 1 else want)
    if tma:
        assert strides[3] == 1 and all(st % 4 == 0 for st in strides[:3])
    # what the C entries receive: the strides and the route
    ptr, layout, *_ = fp._ext_args(view, 0.0, None)
    assert ptr == view.data_ptr() and layout == (*strides, int(tma))
    for kernel, (rows, cols, pitch, _, keys_by_row) in KERNELS.items():
        bp = pitch if strides[2] else 0
        # at pitch 0 a stage holds one row, in 1 KB (bias_stage_bytes)
        assert pitch * 4 <= 1024
        # the reads of a tile at (0, 0), shifted to each tile below
        rq, rk, ra = (torch.cat(x) for x in zip(*(
            r[:3] for r in _reads(kernel, 0, 0, bp))))
        # the CTAs' tiles: query blocks of `rows` (dK/dV: query tiles of
        # 64 under key blocks of 64), key tiles of `cols`
        for b in range(B):
            for h in range(H):
                for q0 in range(0, sq, rows):
                    for k0 in range(0, sk, cols):
                        tile = _stage(view, strides, tma, (rows, cols, pitch),
                                      b, h, q0, k0).reshape(-1)
                        q, key = rq + q0, rk + k0
                        inb = (q < sq) & (key < sk)
                        got = tile[ra[inb]]
                        want = view[b, h, q[inb], key[inb]]
                        assert torch.equal(got, want), (kernel, b, h, q0, k0)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("pitched", [True, False])
def test_tile_reads_are_free_of_bank_conflicts(kernel, pitched):
    """Each warp's load meets no bank twice with different words: float2
    loads (the forward, dQ) per half-warp over 16 bank pairs, float loads
    (dK/dV) per warp over 32 banks; at pitch 0 lanes that share a word
    broadcast it."""
    rows, cols, pitch, wgs, keys_by_row = KERNELS[kernel]
    bp = pitch if pitched else 0
    for q, key, addr, _ in _reads(kernel, 0, 0, bp):
        if not keys_by_row:
            addr = addr - addr % 2          # one float2 per entry pair
        for warp in range(4 * wgs):
            lanes = addr[32 * warp:32 * warp + 32]
            groups = (lanes.view(2, 16) if not keys_by_row
                      else lanes.view(1, 32))
            for g in groups:
                words = sorted(set(g.tolist()))
                banks = ([(a // 2) % 16 for a in words] if not keys_by_row
                         else [a % 32 for a in words])
                assert len(banks) == len(set(banks)), (kernel, bp, words)


@pytest.mark.parametrize("kind", ["transposed", "column"])
def test_sdpa_with_the_new_layouts_matches_jax(kind):
    """The port's SDPA (its plain versions on the CPU) with a transposed
    view and a (Sq, 1) column mask, against the JAX package's SDPA given
    the same values."""
    rng = np.random.RandomState(5)
    sq, sk, d = 24, 40, 16
    q = (rng.randn(B, sq, H, d) * 0.5).astype(np.float32)
    k = (rng.randn(B, sk, H, d) * 0.5).astype(np.float32)
    v = rng.randn(B, sk, H, d).astype(np.float32)
    m = _mask(kind, sq, sk, rng)
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=paddle.to_tensor(m.contiguous().numpy()))
    out = TF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), attn_mask=m)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)

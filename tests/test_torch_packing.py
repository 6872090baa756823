"""The port's first-fit packer (``paddle_tpu_torch.io.packing``) against
the JAX package's on the same documents: every array of every row is
byte-identical (same dtype, shape and bytes), over-long documents and
empty ones included, and the dataset serves the same rows."""
import numpy as np
import pytest
import torch

from paddle_tpu.io import packing as jp
from paddle_tpu_torch.io import packing as tp

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

FIELDS = ("tokens", "labels", "segment_ids", "positions")


def _docs(n, lo, hi, seed, vocab=1000):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, rng.randint(lo, hi + 1)).astype(np.int32)
            for _ in range(n)]


# (documents, seq_len, pad_id): mixed short documents; documents longer
# than a row (split into seq_len chunks, each its own segment); rows
# filled exactly; empty documents (dropped) and plain int lists
CASES = [
    (_docs(40, 3, 60, seed=0), 64, 0),
    (_docs(12, 50, 300, seed=1), 64, 0),
    (_docs(25, 1, 200, seed=2), 128, 7),
    ([np.arange(1, 33)] * 4 + [np.arange(1, 17)] * 4, 32, 0),
    ([[], [5, 6, 7], np.zeros(0, np.int32), list(range(1, 90)), [9]], 16,
     3),
]


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("fn", ["pack_documents", "pad_documents"])
def test_rows_are_byte_identical_to_jax(case, fn):
    docs, seq_len, pad_id = CASES[case]
    want = getattr(jp, fn)(docs, seq_len, pad_id=pad_id)
    got = getattr(tp, fn)(docs, seq_len, pad_id=pad_id)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS:
            _same(getattr(g, f), getattr(w, f), f"row {i} {f}")
        assert g.n_real_tokens == w.n_real_tokens
    assert tp.packing_efficiency(got) == jp.packing_efficiency(want)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_positions_from_segment_ids_byte_identical(case):
    docs, seq_len, pad_id = CASES[case]
    rows = jp.pack_documents(docs, seq_len, pad_id=pad_id)
    seg = np.stack([r.segment_ids for r in rows])
    for ids in (seg, seg[0], seg[None]):          # (B, S), (S,), (1, B, S)
        want = jp.positions_from_segment_ids(ids)
        got = tp.positions_from_segment_ids(ids)
        _same(got, want, f"positions of shape {ids.shape}")
    # the packer's own positions are what the ids recover
    _same(tp.positions_from_segment_ids(seg),
          np.stack([r.positions for r in rows]), "recovered positions")


def test_contract_and_errors_match_jax():
    assert tp.PAD_SEGMENT_ID == jp.PAD_SEGMENT_ID == -1
    assert tp.packing_efficiency([]) == jp.packing_efficiency([]) == 0.0
    for mod in (tp, jp):
        with pytest.raises(ValueError, match="seq_len"):
            mod.pack_documents([[1, 2]], 0)


def test_packed_dataset_serves_the_jax_rows_through_a_dataloader():
    docs, seq_len, pad_id = CASES[0]
    want = jp.PackedDataset(docs, seq_len, pad_id=pad_id)
    got = tp.PackedDataset(docs, seq_len, pad_id=pad_id)
    assert isinstance(got, torch.utils.data.Dataset)
    assert len(got) == len(want) and got.efficiency == want.efficiency
    for i in range(len(got)):
        for g, w, f in zip(got[i], want[i], FIELDS):
            _same(g, w, f"item {i} {f}")
    loader = torch.utils.data.DataLoader(got, batch_size=4, shuffle=False)
    tok, lab, seg, pos = next(iter(loader))
    assert tok.shape == (4, seq_len) and tok.dtype == torch.int32
    np.testing.assert_array_equal(
        seg.numpy(), np.stack([want[i][2] for i in range(4)]))
    reuse = tp.PackedDataset(None, seq_len, batches=got.batches[:2])
    assert len(reuse) == 2

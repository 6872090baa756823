"""The packed-sequence training path against the JAX package's, on the
CPU, on the same numpy inputs:

- the segmented backward kernels' plain versions (K-SDQ, K-SDKV) against
  ``_dq_call_seg`` / ``_dkv_call_seg`` in interpret mode, and
  ``FlashAttentionPackedSeg``'s grads against ``jax.grad`` of
  ``flash_attention_packed_segmented(interpret=True)`` (fp32, atol 1e-5);
- ``gpt_loss`` with segment ids and positions, its loss mask and the
  masked chunked cross entropy, with the JAX ``gpt_init`` params carried
  over by ``from_gpt_params`` (loss and grads atol 1e-5);
- three ``packed_sequences=True`` trainer steps against the JAX trainer's
  on the same three packed batches: losses atol 1e-5, grad norms within
  1e-5 relative (the JAX trainer does not keep its norm; it is recomputed
  from its own loss function at each step's params).

On the CPU every wrapper takes its plain version, so nothing here
launches a kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io.packing import pack_documents as jax_pack
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.pallas.flash_attention_packed import (
    _dkv_call_seg, _dq_call_seg, _fwd_call_seg,
    flash_attention_packed_segmented)
from paddle_tpu.parallel import hybrid as jhybrid
from paddle_tpu.parallel import transformer_core as jcore
from paddle_tpu_torch.io.packing import pack_documents
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.parallel import transformer_core as tcore
from paddle_tpu_torch.utils.convert import from_gpt_params
from paddle_tpu_torch.utils.tree import flatten, unflatten

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

B, NH, D, BLOCK = 2, 2, 64, 128
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _seg_rows(s):
    """Two packed rows of segment ids: documents that cross 64- and
    128-row tiles and documents inside one tile, each row with a -1 pad
    tail."""
    cuts = ([0] * 50 + [1] * 100 + [2] * 70 + [-1] * (s - 220),
            [0] * 13 + [1] * 130 + [2] * 40 + [3] * 50 + [-1] * (s - 233))
    return np.asarray(cuts, np.int32)


def _qkvdo(s, seed):
    rng = np.random.RandomState(seed)
    hp = NH * D
    q = (rng.randn(B, s, hp) * 0.5).astype(np.float32)
    k = (rng.randn(B, s, hp) * 0.5).astype(np.float32)
    v = rng.randn(B, s, hp).astype(np.float32)
    do = rng.randn(B, s, hp).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_refs_match_pallas_interpret(seed):
    s = 256
    q, k, v, do = _qkvdo(s, seed)
    seg = _seg_rows(s)
    scale = 1.0 / D ** 0.5
    jq, jk, jv, jdo, jseg = (jnp.asarray(x) for x in (q, k, v, do, seg))
    want_o, want_lse = _fwd_call_seg(jq, jk, jv, jseg, jseg, NH, scale, True,
                                     BLOCK, BLOCK, True)
    o, lse = fp.segment_attention_ref(_t(q), _t(k), _t(v), _t(seg), NH)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)

    lse_np = np.asarray(want_lse)
    delta = (do * np.asarray(want_o)).reshape(B, s, NH, D).sum(-1)
    want_dq = _dq_call_seg(jq, jk, jv, jdo, jnp.asarray(lse_np),
                           jnp.asarray(delta), jseg, jseg, NH, scale, True,
                           BLOCK, BLOCK, True)
    want_dk, want_dv = _dkv_call_seg(
        jq, jk, jv, jdo, jnp.asarray(lse_np.transpose(0, 2, 1)),
        jnp.asarray(delta.transpose(0, 2, 1)), jseg, jseg, NH, scale, True,
        BLOCK, BLOCK, True)
    args = (_t(q), _t(k), _t(v), _t(do), _t(lse_np), _t(delta), _t(seg), NH)
    dq = fp.segment_dq_ref(*args)
    dk, dv = fp.segment_dkv_ref(*args)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=ATOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), atol=ATOL)

    # the wrappers take the plain versions on CPU tensors, launching none
    K.reset_launch_counts()
    assert torch.equal(fp.seg_dq(*args), dq)
    assert all(torch.equal(a, b) for a, b in zip(fp.seg_dkv(*args),
                                                 (dk, dv)))
    o2, lse2 = fp.seg_fwd(_t(q), _t(k), _t(v), _t(seg), NH)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def test_flash_attention_packed_seg_grads_match_jax():
    """Through the fused-qkv layout the trainer uses: q, k, v are column
    slices of one (B, S, 3*NH*D) tensor."""
    s = 256
    q, k, v, do = _qkvdo(s, 5)
    seg = _seg_rows(s)

    def loss_j(q, k, v):
        o = flash_attention_packed_segmented(
            q, k, v, jnp.asarray(seg), NH, block_q=BLOCK, block_k=BLOCK,
            bwd_block=BLOCK, interpret=True)
        return (o * jnp.asarray(do)).sum(), o

    (_, want_o), want = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    hp = NH * D
    qkv = _t(np.concatenate([q, k, v], -1)).requires_grad_()
    o = fp.flash_attention_packed_seg(qkv[..., :hp], qkv[..., hp:2 * hp],
                                      qkv[..., 2 * hp:], _t(seg).long(), NH)
    assert o.grad_fn.name() == "FlashAttentionPackedSegBackward"
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               atol=ATOL)
    (g,) = torch.autograd.grad(o, qkv, _t(do))
    for i, (name, w) in enumerate(zip("qkv", want)):
        np.testing.assert_allclose(g[..., i * hp:(i + 1) * hp].numpy(),
                                   np.asarray(w), atol=ATOL,
                                   err_msg=f"d{name}")


def test_segment_ids_must_match_the_batch():
    x = torch.zeros(1, 64, NH * D)
    with pytest.raises(ValueError, match="segment_ids shape"):
        fp.flash_attention_packed_seg(x, x, x, torch.zeros(1, 32), NH)


# -- the GPT core and the trainer --------------------------------------------

S = 64


def _packed(seed, n_rows=B):
    """``n_rows`` packed rows (numpy, int32), each 3-5 documents of 4-14
    tokens and a pad tail, packed one row at a time; the port's packer
    and the JAX one agree byte for byte."""
    rng = np.random.RandomState(seed)
    vocab = gpt_tiny().vocab_size
    fields = ("tokens", "labels", "segment_ids", "positions")
    rows = []
    for _ in range(n_rows):
        docs = [rng.randint(1, vocab, n).astype(np.int32)
                for n in rng.randint(4, 15, rng.randint(3, 6))]
        (row,), (jrow,) = pack_documents(docs, S), jax_pack(docs, S)
        assert all(getattr(row, f).tobytes() == getattr(jrow, f).tobytes()
                   for f in fields)
        assert row.segment_ids[-1] == -1 and row.segment_ids.max() >= 2
        rows.append(row)
    return tuple(np.stack([getattr(r, f) for r in rows]) for f in fields)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jcore.gpt_init(jax_gpt_tiny(),
                                         jax.random.PRNGKey(0)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, sub in tree.items():
            out.update(_leaves(sub, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("remat", [True, False])
def test_packed_gpt_loss_and_grads_match_jax(jax_params, remat):
    tok, lab, seg, pos = _packed(0)
    want_loss, want = jax.value_and_grad(
        lambda p: jcore.gpt_loss(jax_gpt_tiny(), p, jnp.asarray(tok),
                                 jnp.asarray(lab), compute_dtype=jnp.float32,
                                 remat=False, segment_ids=jnp.asarray(seg),
                                 positions=jnp.asarray(pos)))(jax_params)
    want = _leaves(jax.device_get(want))
    params = from_gpt_params(jax_params, gpt_tiny())
    paths, leaves = zip(*((p, t.requires_grad_()) for p, t in
                          flatten(params)))
    loss = tcore.gpt_loss(gpt_tiny(), unflatten(zip(paths, leaves)),
                          _t(tok).long(),
                          _t(lab).long(), compute_dtype=torch.float32,
                          remat=remat, segment_ids=_t(seg),
                          positions=_t(pos))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) <= ATOL
    got = {"/".join(p): g.numpy() for p, g in zip(paths, grads)}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=ATOL,
                                   err_msg=name)


def test_packed_loss_mask_and_masked_xent_match_jax():
    _, _, seg, _ = _packed(1)
    want = np.asarray(jcore.packed_loss_mask(jnp.asarray(seg)))
    got = tcore.packed_loss_mask(_t(seg)).numpy()
    np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(2)
    h = rng.randn(B, S, 16).astype(np.float32)
    w = rng.randn(16, 40).astype(np.float32)
    lab = rng.randint(0, 40, (B, S)).astype(np.int32)
    for mask in (want, np.zeros_like(want)):     # all-masked: max(sum, 1)
        ref = float(jcore.chunked_xent_on(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab),
            compute_dtype=jnp.float32, chunk=48, token_mask=jnp.asarray(mask)))
        for chunk in (48, 4096):
            out = float(tcore.chunked_xent_on(
                _t(h), _t(w), _t(lab), compute_dtype=torch.float32,
                chunk=chunk, token_mask=_t(mask)))
            assert abs(out - ref) <= ATOL, (chunk, out, ref)


def test_gpt_embed_takes_positions_as_jax(jax_params):
    tok, _, _, pos = _packed(2)
    want = np.asarray(jcore.gpt_embed(jax_gpt_tiny(), jax_params,
                                      jnp.asarray(tok), jnp.float32,
                                      positions=jnp.asarray(pos)))
    got = tcore.gpt_embed(gpt_tiny(), from_gpt_params(jax_params,
                                                      gpt_tiny()),
                          _t(tok).long(), torch.float32, positions=_t(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _packed_trainers(jax_params):
    base = dict(compute_dtype=jnp.float32, learning_rate=1e-3,
                warmup_steps=2, eps=1e-5, packed_sequences=True)
    jt = jhybrid.HybridParallelTrainer(
        jax_gpt_tiny(), jhybrid.TrainerConfig(telemetry=False,
                                              compile_ledger=False, **base),
        devices=jax.devices()[:1])
    base["compute_dtype"] = torch.float32
    tt = thybrid.HybridParallelTrainer(
        gpt_tiny(), thybrid.TrainerConfig(**base), device="cpu")
    tt.params = from_gpt_params(jax.device_get(jt.params), gpt_tiny())
    return jt, tt


def _jax_grad_norm(jt, tok, lab, seg, pos):
    grads = jax.grad(jt._loss_fn)(jt.params, *(jnp.asarray(x) for x in
                                               (tok, lab, seg, pos)))
    return float(jhybrid.global_norm(grads))


def test_packed_trainer_three_steps_match_jax(jax_params, monkeypatch):
    """Three different packed batches; the port derives positions from
    the segment ids at step 2 (the JAX side gets them explicitly)."""
    monkeypatch.delenv("PADDLE_FI_NAN_AT_STEP", raising=False)
    jt, tt = _packed_trainers(jax_params)
    for i in range(3):
        tok, lab, seg, pos = _packed(10 + i)
        want_norm = _jax_grad_norm(jt, tok, lab, seg, pos)
        want = float(jt.step(tok, lab, seg, pos))
        got = float(tt.step(tok, lab, seg, None if i == 1 else pos))
        norm = float(tt.last_grad_norm)
        assert abs(got - want) <= ATOL, (i, got, want)
        assert abs(norm - want_norm) <= ATOL * max(1.0, want_norm), (
            i, norm, want_norm)
    assert int(tt.opt["step"]) == int(jt.opt["step"]) == 3
    assert tt.anomaly_state() == jt.anomaly_state()


def test_packed_step_presharded_matches_step(jax_params):
    _, tt = _packed_trainers(jax_params)
    _, tp = _packed_trainers(jax_params)
    tok, lab, seg, pos = _packed(20)
    a = float(tt.step(tok, lab, seg, pos))
    dev = [torch.as_tensor(x) for x in (seg, pos)]
    b = float(tp.step_presharded(*tp.shard_batch(tok, lab), *dev))
    assert a == b
    with pytest.raises(ValueError, match="segment_ids"):
        tt.step(tok, lab)
    with pytest.raises(ValueError, match="segment_ids and positions"):
        tt.step_presharded(*tt.shard_batch(tok, lab), dev[0])


@pytest.mark.parametrize("kw,match", [({"pp": 2}, "pp"), ({"sep": 2}, "sep")])
def test_packed_trainer_rejects_what_jax_rejects(kw, match):
    for mod in (jhybrid, thybrid):
        with pytest.raises(ValueError, match=match):
            cfg = mod.TrainerConfig(packed_sequences=True, **kw)
            if mod is jhybrid:
                mod.HybridParallelTrainer(jax_gpt_tiny(), cfg)
            else:
                mod.HybridParallelTrainer(gpt_tiny(), cfg, device="cpu")


def test_packed_trainer_builds_over_dp_where_jax_builds():
    """``dp=2`` packed builds in both packages (the port on rank 1 of a
    dp=2 mesh that needs no world to build), and the port's rank takes
    its rows of the ids and of the positions derived from the global
    ids."""
    from paddle_tpu_torch.distributed.mesh import AXES, Mesh

    jhybrid.HybridParallelTrainer(jax_gpt_tiny(), jhybrid.TrainerConfig(
        dp=2, packed_sequences=True))
    sizes = dict.fromkeys(AXES, 1)
    sizes["data"] = 2
    mesh = Mesh(sizes, 1, "gloo", torch.device("cpu"), {})
    t = thybrid.HybridParallelTrainer(
        gpt_tiny(), thybrid.TrainerConfig(dp=2, packed_sequences=True),
        device="cpu", mesh=mesh)
    _, _, seg, pos = _packed(21)
    got_seg, got_pos = t.shard_packed(seg)
    half = seg.shape[0] // 2
    assert np.array_equal(got_seg.numpy(), seg[half:])
    assert np.array_equal(got_pos.numpy(), pos[half:])
    assert got_seg.dtype == got_pos.dtype == torch.int32

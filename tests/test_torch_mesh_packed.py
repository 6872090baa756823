"""The port's trainer over a mesh on packed rows, and sequence sharding
without the ring, against the JAX trainer on the same layout, on the
CPU.

- Packed rows (``packed_sequences=True``, ``gpt_tiny``, 8 x 64 rows of
  ``io.packing``, each row holding a different number of real labels, so
  every batch shard and every dp half does): ``dp=2, mp=2`` and ``dp=2,
  sharding=2`` ZeRO 3.
- ``ring_attention=False`` (contiguous sequence shards and the naive
  ring of ``ops.ring_attention``, where the JAX package leaves ``"sep"``
  to GSPMD) on ``gpt_tiny`` and ``llama_tiny`` (4 heads over 2 kv
  heads): ``sep=2, mp=2`` and ``sep=4``, and ``pp=2, sep=2`` on LLaMA.

Each layout starts from the JAX trainer's initial params and takes 3
fp32 steps on the same batch: losses within 1e-4, every param leaf within
1e-4 of its largest value, and the state-memory plan key for key. The
sequence-sharded attention itself (the naive ring over contiguous
shards, K and V repeated to the query heads first as the LLaMA core
does) is held to the JAX package's ``causal_attention_packed`` on the
global arrays (output and the grads of q, k and v within 1e-5, ``sep=2``
and ``sep=4``, GQA at ``sep=4``; one rank on the axis too). Every rank's
forward calls (the plain versions count as the kernels would launch)
equal the count derived from the code, under ``remat=True`` and, for one
GPT and one LLaMA layout, under ``names:attn_out_kernel,attn_lse``,
whose recompute skips the attention forward.

The port's ranks are the processes of one gloo world of 4 spawned from
this file (``python tests/test_torch_mesh_packed.py --worker SPEC``), every
layout in turn; the JAX trainers compile in threads here meanwhile."""
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLD, BATCH, SEQ, STEPS = 4, 8, 64, 3
VOCAB = 1024            # gpt_tiny's and llama_tiny's
BASE = dict(learning_rate=1e-3, warmup_steps=2, eps=1e-5)
PACKED = dict(packed_sequences=True)
NO_RING = dict(ring_attention=False)
CASES = [("gpt", dict(dp=2, mp=2, **PACKED)),
         ("gpt", dict(dp=2, sharding=2, zero_stage=3, **PACKED)),
         ("gpt", dict(sep=2, mp=2, **NO_RING)),
         ("llama", dict(sep=2, mp=2, **NO_RING)),
         ("gpt", dict(sep=4, **NO_RING)),
         ("llama", dict(sep=4, **NO_RING)),
         ("llama", dict(pp=2, sep=2, **NO_RING))]
ARCHS = ("gpt", "llama")
# the direct attention checks: (mesh layout, heads, kv heads)
ATTN = {"sep2": (dict(dp=2, sep=2), 4, 4), "sep4": (dict(sep=4), 4, 2)}
ATTN_B, ATTN_D = 2, 16
NAMES = "names:attn_out_kernel,attn_lse"
# the layouts also stepped under the names policy: packed rows (GPT) and
# the naive ring past rank 0 of "sep" (LLaMA)
NAMES_CASES = [CASES[0], CASES[3]]


def _tag(arch, lay):
    return arch + "-" + "-".join(f"{k}{v}" for k, v in sorted(lay.items()))


def _batch(vocab):
    rng = np.random.RandomState(11)
    return (rng.randint(0, vocab, (BATCH, SEQ)),
            rng.randint(0, vocab, (BATCH, SEQ)))


def _packed_batch(vocab):
    """8 rows of ``pack_documents``: row i packs documents of 4-20 tokens
    up to ``64 - 5 i`` slots, so each row holds a different number of
    real labels. Returns ``(tokens, labels, segment_ids, positions)``."""
    from paddle_tpu_torch.io.packing import pack_documents

    rng = np.random.RandomState(19)
    rows = []
    for i in range(BATCH):
        docs, left = [], SEQ - 5 * i
        while left:
            n = min(left, rng.randint(4, 21))
            docs.append(rng.randint(0, vocab, n))
            left -= n
        (row,) = pack_documents(docs, SEQ)
        rows.append(row.astuple())
    return tuple(np.stack(x) for x in zip(*rows))


def _real_labels(seg):
    """Real labels per row: a token followed by one of its document."""
    seg = np.asarray(seg)
    nxt = np.concatenate([seg[:, 1:], np.full_like(seg[:, :1], -2)], 1)
    return ((seg >= 0) & (seg == nxt)).sum(1)


def _steps(trainer, lay, presharded=False):
    """3 steps on the layout's batch. Packed: the positions left for the
    trainer to derive on step 2, from the global ids; with
    ``presharded`` (the port) step 1 through ``step_presharded`` on this
    rank's shards (``shard_batch``, ``shard_packed``)."""
    if not lay.get("packed_sequences"):
        tok, lab = _batch(VOCAB)
        return [float(trainer.step(tok, lab)) for _ in range(STEPS)]
    tok, lab, seg, pos = _packed_batch(VOCAB)
    if presharded:
        first = trainer.step_presharded(*trainer.shard_batch(tok, lab),
                                        *trainer.shard_packed(seg, pos))
    else:
        first = trainer.step(tok, lab, seg, pos)
    return [float(first)] + [
        float(trainer.step(tok, lab, seg, None if i == 1 else pos))
        for i in range(1, STEPS)]


def _port_cfg(arch):
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.models.llama import llama_tiny

    return gpt_tiny() if arch == "gpt" else llama_tiny()


def _attn_inputs(nh, nkv):
    rng = np.random.RandomState(nh * 10 + nkv)
    q = rng.randn(ATTN_B, SEQ, nh * ATTN_D).astype(np.float32)
    k, v = (rng.randn(ATTN_B, SEQ, nkv * ATTN_D).astype(np.float32)
            for _ in range(2))
    w = rng.randn(ATTN_B, SEQ, nh * ATTN_D).astype(np.float32)
    return q, k, v, w


def derived_forwards(arch, lay, sep_rank, remat):
    """The attention forwards a rank runs in one step, derived from the
    code: a layer's attention is one K-SEG on packed rows, else the naive
    ring's causal diagonal block and one full block for each earlier
    shard, 1 + r on rank r of ``"sep"``; ``remat=True`` runs each layer's
    forward twice, the ``names:`` policy once (its recompute takes the
    saved outputs)."""
    blocks = 1 if lay.get("packed_sequences") else 1 + sep_rank
    layers = _port_cfg(arch).num_layers
    return layers * blocks * (2 if remat is True else 1)


# -- the rank worker (runs in a spawned process; torch only) -------------------

def _repeat_kv(t, groups):
    """``(B, S, nkv*d)`` -> ``(B, S, nkv*groups*d)``: each kv head
    repeated ``groups`` times in a row, as the LLaMA core expands them."""
    b, s, w = t.shape
    nkv = w // ATTN_D
    return (t.reshape(b, s, nkv, 1, ATTN_D)
            .expand(b, s, nkv, groups, ATTN_D).reshape(b, s, -1))


def _sequence_attention(q, k, v, nh, nkv, mesh):
    """The trainer's attention without ``ring_attention``: the naive ring
    over this rank's contiguous shards, K and V repeated first."""
    from paddle_tpu_torch.ops.ring_attention import ring_attention_packed

    g = nh // nkv
    return ring_attention_packed(q, _repeat_kv(k, g), _repeat_kv(v, g), nh,
                                 mesh, "sep")


def _attention(spec):
    """Each ``ATTN`` layout's sequence-sharded attention over this rank's
    shards of the global arrays: its output shard and its q, k and v
    grads."""
    from paddle_tpu_torch.distributed.mesh import build_mesh

    rank = spec["rank"]
    out = {}
    for name, (lay, nh, nkv) in ATTN.items():
        mesh = build_mesh(**lay, device="cpu")
        n, i = mesh.shape["sep"], mesh.coords["sep"]
        nb, bi = mesh.size("data"), mesh.coords["data"]
        c, rb = SEQ // n, ATTN_B // nb
        xs = [torch.from_numpy(x)[bi * rb:(bi + 1) * rb, i * c:(i + 1) * c]
              for x in _attn_inputs(nh, nkv)]
        loc = [x.clone().requires_grad_() for x in xs[:3]]
        o = _sequence_attention(*loc, nh, nkv, mesh)
        (o * xs[3]).sum().backward()
        for key, t in zip("oqkv", [o] + [x.grad for x in loc]):
            out[f"{name}/{key}/r{rank}"] = t.detach().numpy()
    return out


def _refuses_global_ids(trainer):
    """Whether ``step_presharded`` refuses the global ids in place of
    this rank's shards (before it runs anything)."""
    tok, lab, seg, pos = _packed_batch(VOCAB)
    try:
        trainer.step_presharded(*trainer.shard_batch(tok, lab),
                                torch.as_tensor(seg), torch.as_tensor(pos))
    except ValueError as e:
        return "shard_packed" in str(e)
    return False


def _worker(spec):
    import torch.distributed as dist

    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp
    from paddle_tpu_torch.parallel import hybrid
    from paddle_tpu_torch.utils.tree import flatten

    rank = spec["rank"]
    dist.init_process_group("gloo", init_method=spec["init"],
                            world_size=WORLD, rank=rank)
    np.savez(os.path.join(spec["dir"], f"attn-rank{rank}.npz"),
             **_attention(spec))
    full = {}
    for arch in ARCHS:
        init = dict(np.load(os.path.join(spec["dir"], f"init-{arch}.npz")))
        full[arch] = {"blocks": {}}
        for k, v in init.items():
            node = full[arch]["blocks"] if k.startswith("blocks/") else \
                full[arch]
            node[k.split("/")[-1]] = v
    out = {}
    for arch, lay in CASES:
        packed = bool(lay.get("packed_sequences"))
        kind = "K-SEG" if packed else "K-PACK"
        t = hybrid.HybridParallelTrainer(
            _port_cfg(arch), hybrid.TrainerConfig(
                compute_dtype=torch.float32, **BASE, **lay), device="cpu",
            params=full[arch])
        seen = []
        acct, on_step = t.telemetry, t.telemetry.on_step
        acct.on_step = lambda dur, tokens=None, memory=None: (
            seen.append(tokens), on_step(dur, tokens=tokens,
                                         memory=memory))[1]
        refused = _refuses_global_ids(t) if packed else None
        # the attention forwards (plain versions counted as the kernels'
        # launches) and the ring's blocks, a step
        before = fp.PLAIN_CALLS[kind]
        ra.BLOCKS.clear()
        losses = _steps(t, lay, presharded=True)
        fwd = (fp.PLAIN_CALLS[kind] - before) / STEPS
        blocks = {k: v / STEPS for k, v in ra.BLOCKS.items()}
        params = t.full_params()
        plan = t.memory_plan()["state"]
        tag = _tag(arch, lay)
        out[tag] = {
            "losses": losses, "gnorm": float(t.last_grad_norm),
            "live": sum(x.numel() * x.element_size() for _, x in
                        flatten({"p": t.params, "o": t.opt})),
            "plan": plan["total_per_device_bytes"],
            "plan_global": plan["total_global_bytes"],
            "tokens": seen, "n_devices": acct.n_devices,
            "sep_rank": t.mesh.coords["sep"],
            "refuses_global_ids": refused, "fwd-True": fwd,
            "blocks-True": sorted([*k, v] for k, v in blocks.items())}
        if rank == 0:
            np.savez(os.path.join(spec["dir"], f"params-{tag}.npz"),
                     **{"/".join(p): v.numpy() for p, v in flatten(params)})
        if (arch, lay) in NAMES_CASES:
            # one step under the names policy, on the same mesh
            t = hybrid.HybridParallelTrainer(
                _port_cfg(arch), hybrid.TrainerConfig(
                    compute_dtype=torch.float32, remat=NAMES, **BASE,
                    **lay), device="cpu", mesh=t.mesh, params=full[arch])
            before = fp.PLAIN_CALLS[kind]
            ra.BLOCKS.clear()
            if packed:
                t.step(*_packed_batch(VOCAB))
            else:
                t.step(*_batch(VOCAB))
            out[tag][f"fwd-{NAMES}"] = fp.PLAIN_CALLS[kind] - before
            out[tag][f"blocks-{NAMES}"] = sorted(
                [*k, v] for k, v in ra.BLOCKS.items())
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# -- the parent: spawn the world, run the JAX side -----------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(d):
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         json.dumps({"rank": r, "init": init, "dir": d})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]


def _join(procs, timeout=300):
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode:
            errs.append(err[-3000:])
    return errs


def _jax_cfg(arch):
    from paddle_tpu.models.gpt import gpt_tiny
    from paddle_tpu.models.llama import llama_tiny

    return gpt_tiny() if arch == "gpt" else llama_tiny()


def _jax_trainer(arch, **kw):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel import HybridParallelTrainer, TrainerConfig

    cfg = TrainerConfig(compute_dtype=jnp.float32, telemetry=False,
                        compile_ledger=False, **BASE, **kw)
    devices = None if kw else jax.devices()[:1]
    return HybridParallelTrainer(_jax_cfg(arch), cfg, devices=devices)


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _flat(tree):
    return {k: np.asarray(v) for k, v in _walk(tree)}


def _jax_attention(nh, nkv):
    """``(o, dq, dk, dv)`` of the JAX package's ``causal_attention_packed``
    on the global arrays (k, v repeated to the query heads; their grads
    summed back over each kv head's group)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.attention_dispatch import causal_attention_packed

    g = nh // nkv
    q, k, v, w = (jnp.asarray(x) for x in _attn_inputs(nh, nkv))

    def rep(t):
        b, s, _ = t.shape
        return jnp.repeat(t.reshape(b, s, nkv, 1, ATTN_D), g, axis=3
                          ).reshape(b, s, nh * ATTN_D)

    o, vjp = jax.vjp(lambda q, k, v: causal_attention_packed(
        q, rep(k), rep(v), nh), q, k, v)
    return [np.asarray(x) for x in (o, *vjp(w))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax)``: per tag, each side's 3 losses (the port's per rank
    with its memory numbers and counts, its params from rank 0; the JAX
    params), and per ``ATTN`` name each side's global o, dq, dk, dv."""
    import jax

    d = str(tmp_path_factory.mktemp("mesh_packed"))
    for arch in ARCHS:
        np.savez(os.path.join(d, f"init-{arch}.npz"),
                 **_flat(jax.device_get(_jax_trainer(arch).params)))
    procs = _spawn(d)

    def run(case):
        arch, lay = case
        t = _jax_trainer(arch, **lay)
        return _tag(arch, lay), {"losses": _steps(t, lay),
                                 "params": _flat(jax.device_get(t.params))}

    try:
        # XLA compiles outside the GIL: a few trainers at a time overlap
        with ThreadPoolExecutor(4) as ex:   # the pipeline first
            want = ex.map(run, sorted(CASES,
                                      key=lambda c: -c[1].get("pp", 1)))
            attn = {name: ex.submit(_jax_attention, *ATTN[name][1:])
                    for name in ATTN}
            want = dict(want)
            attn = {name: f.result() for name, f in attn.items()}
    finally:
        errs = _join(procs)
    assert not errs, errs
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = {tag: {"ranks": [x[tag] for x in ranks],
                 "params": dict(np.load(os.path.join(
                     d, f"params-{tag}.npz")))} for tag in ranks[0]}
    shards = [dict(np.load(os.path.join(d, f"attn-rank{r}.npz")))
              for r in range(WORLD)]
    got_attn = {}
    for name, (lay, _, _) in ATTN.items():
        sep, dp = lay["sep"], lay.get("dp", 1)
        for key in "oqkv":
            # rank = data * sep + sep coordinate: rows by data, S by sep
            rows = [np.concatenate([shards[b * sep + i][f"{name}/{key}/r"
                                                        f"{b * sep + i}"]
                                    for i in range(sep)], axis=1)
                    for b in range(dp)]
            got_attn[name, key] = np.concatenate(rows, axis=0)
    return got, want, got_attn, attn


def test_packed_rows_hold_unequal_real_labels_per_batch_shard():
    """The packed layouts' premise: every batch shard of ``dp=2,
    sharding=2`` and each dp half holds a different number of real
    labels, so a mean of per-rank means would differ from the global
    mean."""
    per_row = _real_labels(_packed_batch(VOCAB)[2])
    quarters = per_row.reshape(4, -1).sum(1)
    halves = per_row.reshape(2, -1).sum(1)
    assert len(set(quarters.tolist())) == 4 and halves[0] != halves[1]


@pytest.mark.parametrize("arch,lay", CASES, ids=[_tag(*c) for c in CASES])
def test_layout_matches_the_jax_trainer(runs, arch, lay):
    got, want = runs[:2]
    tag = _tag(arch, lay)
    g, w = got[tag], want[tag]
    for r in g["ranks"]:            # every rank reports the global loss
        assert r["losses"] == g["ranks"][0]["losses"], tag
        assert r["gnorm"] == g["ranks"][0]["gnorm"], tag
    for a, b in zip(g["ranks"][0]["losses"], w["losses"]):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (tag, a, b)
    assert set(g["params"]) == set(w["params"])
    for k, ref in w["params"].items():
        err = float(np.abs(g["params"][k] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (tag, k, err)


@pytest.mark.parametrize("arch,lay", CASES, ids=[_tag(*c) for c in CASES])
def test_state_memory_plan_matches_jax_per_rank(runs, arch, lay):
    """``plan_state_memory`` equals the JAX package's key for key, and
    every rank's live params and moments take exactly the planned
    per-rank bytes."""
    from paddle_tpu.observability.memory import plan_state_memory as jplan
    from paddle_tpu.parallel import TrainerConfig as JCfg
    from paddle_tpu_torch.observability.memory import plan_state_memory
    from paddle_tpu_torch.parallel.hybrid import TrainerConfig

    got = plan_state_memory(_port_cfg(arch), TrainerConfig(**lay))
    assert got == jplan(_jax_cfg(arch), JCfg(**lay))
    for r in runs[0][_tag(arch, lay)]["ranks"]:
        assert r["live"] == r["plan"] == got["total_per_device_bytes"]
        assert r["plan_global"] == got["total_global_bytes"]


@pytest.mark.parametrize("arch,lay", CASES[:2], ids=[_tag(*c)
                                                     for c in CASES[:2]])
def test_packed_telemetry_counts_the_global_batch(runs, arch, lay):
    """Every rank's step records count the global batch's token slots
    (8 x 64, as the JAX trainer counts a packed batch) over the world."""
    for r in runs[0][_tag(arch, lay)]["ranks"]:
        assert r["tokens"] == [BATCH * SEQ] * STEPS
        assert r["n_devices"] == WORLD


@pytest.mark.parametrize("arch,lay", CASES[:2], ids=[_tag(*c)
                                                     for c in CASES[:2]])
def test_packed_step_presharded_takes_this_ranks_shards(runs, arch, lay):
    """``step_presharded`` refuses the global ids in place of this rank's
    shards (its step on ``shard_batch`` and ``shard_packed``'s output is
    the layout's step 1, held to the JAX trainer's)."""
    for r in runs[0][_tag(arch, lay)]["ranks"]:
        assert r["refuses_global_ids"] is True


@pytest.mark.parametrize("arch,lay,remat", [
    *[(*c, True) for c in CASES if c[1].get("pp", 1) == 1],
    *[(*c, NAMES) for c in NAMES_CASES]], ids=[
    *[_tag(*c) + "-True" for c in CASES if c[1].get("pp", 1) == 1],
    *[_tag(*c) + "-" + NAMES for c in NAMES_CASES]])
def test_attention_forwards_a_step_equal_the_derived_count(runs, arch, lay,
                                                           remat):
    """K-SEG on packed rows, K-PACK's blocks on the naive ring: each
    rank's forwards a step equal ``derived_forwards`` (the ``names:``
    policy's recompute takes the saved outputs), and the ring's K-DQ and
    K-DKV run its blocks once each. ``BLOCKS`` counts the block calls,
    which the recompute makes under either policy: the saved forward is
    a call whose operator does not run again."""
    for r in runs[0][_tag(arch, lay)]["ranks"]:
        want = derived_forwards(arch, lay, r["sep_rank"], remat)
        assert r[f"fwd-{remat}"] == want, (r["sep_rank"], r[f"fwd-{remat}"])
        if lay.get("packed_sequences"):
            continue
        blocks = {(k, sq, sk, causal): n
                  for k, sq, sk, causal, n in r[f"blocks-{remat}"]}
        c = SEQ // lay["sep"]
        layers = _port_cfg(arch).num_layers
        fwd = 2             # the forward and its recompute
        want_blocks = {(k, c, c, True): layers * (fwd if k == "K-PACK"
                                                  else 1)
                       for k in ("K-PACK", "K-DQ", "K-DKV")}
        if r["sep_rank"]:
            for k in ("K-PACK", "K-DQ", "K-DKV"):
                want_blocks[k, c, c, False] = (
                    want_blocks[k, c, c, True] * r["sep_rank"])
        assert blocks == want_blocks, (r["sep_rank"], blocks)


@pytest.mark.parametrize("name", sorted(ATTN))
def test_sequence_attention_matches_jax(runs, name):
    got, want = runs[2], runs[3]
    for key, ref in zip("oqkv", want[name]):
        np.testing.assert_allclose(got[name, key], ref, rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} {key}")


def test_sequence_attention_on_one_sequence_rank_matches_jax():
    """With one rank on ``"sep"`` the ring is one causal flash attention:
    the JAX package's ``causal_attention_packed`` on the same arrays
    (GQA, 1e-5)."""
    from paddle_tpu_torch.distributed.mesh import AXES, Mesh

    nh, nkv = 4, 2
    mesh = Mesh(dict.fromkeys(AXES, 1), 0, "gloo", torch.device("cpu"), {})
    xs = [torch.from_numpy(x) for x in _attn_inputs(nh, nkv)]
    loc = [x.clone().requires_grad_() for x in xs[:3]]
    o = _sequence_attention(*loc, nh, nkv, mesh)
    (o * xs[3]).sum().backward()
    got = [o.detach()] + [x.grad for x in loc]
    for key, g, ref in zip("oqkv", got, _jax_attention(nh, nkv)):
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5, atol=1e-5,
                                   err_msg=key)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(json.loads(sys.argv[2]))

"""The port's naive and zigzag rings (``paddle_tpu_torch.ops.
ring_attention``) against the JAX package's ``ring_attention_sharded``
on the conftest's CPU mesh, in fp32 at 1e-5: the output and the grads of
q, k and v under a random cotangent, for rings of 2 and 4 ranks at a
chunk of 128 (S = 2 * n * 128). The JAX side runs its einsum inner block
(naive causal, naive full, zigzag) and the packed flash kernels in
interpret mode (zigzag, ``impl="flash"``); the port's inner blocks are
the plain versions of K-PACK, K-DQ and K-DKV here (the kernels on CUDA).
The port's zigzag ring also runs on shards already in zigzag order
(``"zigzag_pre"``, the trainer's layout).

The port's ranks are processes of gloo worlds of 2 and 4 spawned from
this file (``python tests/test_torch_ring_attention.py --worker SPEC``),
every layout in one world; the JAX rings run here meanwhile."""
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
B, H, D, CHUNK = 1, 2, 64, 128
WORLDS = (2, 4)
# (port layout, causal)
LAYOUTS = (("naive", True), ("naive", False), ("zigzag", True),
           ("zigzag_pre", True))


def _inputs(n):
    rng = np.random.RandomState(n)
    s = 2 * n * CHUNK
    return [rng.randn(B, s, H, D).astype(np.float32) for _ in range(4)]


# -- the rank worker (runs in a spawned process; torch only) -------------------

def _worker(spec):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.ops import ring_attention as ra

    rank, n = spec["rank"], spec["world"]
    dist.init_process_group("gloo", init_method=spec["init"], world_size=n,
                            rank=rank)
    mesh = build_mesh(sep=n, device="cpu")
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(n))
    s = q.shape[1] // n
    out = {}
    for layout, causal in LAYOUTS:
        xs = (q, k, v, w)
        if layout == "zigzag_pre":
            xs = tuple(ra.to_zigzag(x, n) for x in xs)
        loc = [x[:, rank * s:(rank + 1) * s].clone().requires_grad_()
               for x in xs[:3]]
        o = ra.ring_attention_sharded(*loc, mesh, causal=causal,
                                      layout=layout)
        (o * xs[3][:, rank * s:(rank + 1) * s]).sum().backward()
        tag = f"{layout}-{'causal' if causal else 'full'}"
        for name, t in zip("oqkv", [o] + [x.grad for x in loc]):
            out[f"{tag}/{name}"] = t.detach().numpy()
    np.savez(os.path.join(spec["dir"], f"n{n}-rank{rank}.npz"), **out)
    dist.destroy_process_group()


# -- the parent -----------------------------------------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(n, d):
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         json.dumps({"rank": r, "world": n, "init": init, "dir": d})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def _jax_ring(n, layout, causal, impl):
    """``(o, dq, dk, dv)`` of the JAX ring on the global arrays."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from paddle_tpu.ops.pallas.ring_attention import ring_attention_sharded

    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, 1, 1, n, 1),
                ("data", "pipe", "sharding", "sep", "model"))
    q, k, v, w = (jnp.asarray(x) for x in _inputs(n))

    def f(q, k, v):
        o, vjp = jax.vjp(lambda q, k, v: ring_attention_sharded(
            q, k, v, mesh, causal=causal, layout=layout, impl=impl), q, k, v)
        return (o, *vjp(w))

    with mesh:
        return [np.asarray(x) for x in jax.jit(f)(q, k, v)]


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """``(port, jax)``: per ring size, layout tag and output name, the
    port's global arrays (rank shards in order) and the JAX rings'."""
    d = str(tmp_path_factory.mktemp("ring"))
    procs = {n: _spawn(n, d) for n in WORLDS}
    # the interpret-mode flash rings take longest: they go first
    keys = [(n, *c) for c in (
        ("zigzag", True, "flash"), ("naive", True, None),
        ("naive", False, None), ("zigzag", True, "einsum"))
        for n in sorted(WORLDS, reverse=True)]
    try:
        # XLA compiles outside the GIL: a few rings at a time overlap
        with ThreadPoolExecutor(4) as ex:
            want = dict(zip(keys, ex.map(lambda k: _jax_ring(*k), keys)))
    finally:
        errs = []
        for ps in procs.values():
            for p in ps:
                try:
                    _, err = p.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    p.kill()
                    _, err = p.communicate()
                if p.returncode:
                    errs.append(err[-3000:])
    assert not errs, errs
    got = {}
    for n in WORLDS:
        shards = [dict(np.load(os.path.join(d, f"n{n}-rank{r}.npz")))
                  for r in range(n)]
        for key in shards[0]:
            got[n, key] = np.concatenate([s[key] for s in shards], axis=1)
    return got, want


CASES = [(n, layout, causal, impl) for n in WORLDS
         for layout, causal, impl in (("naive", True, None),
                                      ("naive", False, None),
                                      ("zigzag", True, "einsum"),
                                      ("zigzag", True, "flash"),
                                      ("zigzag_pre", True, "einsum"))]


@pytest.mark.parametrize("n,layout,causal,impl", CASES, ids=[
    f"n{n}-{lay}-{'causal' if c else 'full'}-{impl or 'einsum'}"
    for n, lay, c, impl in CASES])
def test_ring_matches_jax_forward_and_grads(rings, n, layout, causal, impl):
    from paddle_tpu_torch.ops.ring_attention import to_zigzag

    got, want = rings
    ref = want[n, "zigzag" if layout == "zigzag_pre" else layout, causal,
               impl]
    if layout == "zigzag_pre":     # the port's inputs were zigzag-ordered
        ref = [to_zigzag(x, n) for x in ref]
    tag = f"{layout}-{'causal' if causal else 'full'}"
    for name, r in zip("oqkv", ref):
        np.testing.assert_allclose(got[n, f"{tag}/{name}"], r, rtol=1e-5,
                                   atol=1e-5, err_msg=f"{tag} {name}")


def test_zigzag_helpers_match_jax():
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import ring_attention as jra
    from paddle_tpu_torch.ops import ring_attention as tra

    for n in (1, 2, 4):
        assert np.array_equal(tra.zigzag_chunk_order(n),
                              jra.zigzag_chunk_order(n))
    x = np.arange(2 * 16 * 3, dtype=np.float32).reshape(2, 16, 3)
    for n in (2, 4):
        z = tra.to_zigzag(torch.from_numpy(x), n)
        np.testing.assert_array_equal(
            z.numpy(), np.asarray(jra.to_zigzag(jnp.asarray(x), n)))
        np.testing.assert_array_equal(tra.to_zigzag(x, n), z.numpy())
        np.testing.assert_array_equal(tra.from_zigzag(z, n).numpy(), x)


def test_combine_packed_matches_jax_with_masked_rows():
    """The merge with JAX's -inf guards: a row masked on one side takes
    the other side exactly; masked on both, weights 0 and lse -inf."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import ring_attention as jra
    from paddle_tpu_torch.ops import ring_attention as tra

    rng = np.random.RandomState(3)
    o_a, o_b = (rng.randn(2, 5, 8).astype(np.float32) for _ in range(2))
    lse_a, lse_b = (rng.randn(2, 5, 2).astype(np.float32) for _ in range(2))
    neg = np.float32(-1e30)
    lse_a[0, 1] = neg
    lse_b[1, 2] = neg
    lse_a[1, 4] = lse_b[1, 4] = neg
    want = jra._combine_packed(*(jnp.asarray(x) for x in (o_a, lse_a, o_b,
                                                         lse_b)), 4)
    got = tra._combine_packed(*(torch.from_numpy(x) for x in (
        o_a, lse_a, o_b, lse_b)), 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert float(got[1][1, 4, 0]) == float(neg)


def test_ring_layout_choice_and_guards():
    """``ring_attention_sharded``'s layout choice and refusals, on a
    one-rank ring (no world needed for the checks before the ring)."""
    from paddle_tpu_torch.ops import ring_attention as tra

    class OneRank:
        shape = {"sep": 1}
        coords = {"sep": 0}

    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="causal-only"):
        tra.ring_attention_sharded(x, x, x, OneRank(), causal=False,
                                   layout="zigzag")
    with pytest.raises(ValueError, match="layout"):
        tra.ring_attention_sharded(x, x, x, OneRank(), layout="ring")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(json.loads(sys.argv[2]))

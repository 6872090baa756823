"""Multi-rank checkpoints of the port's trainer against the JAX package,
on the CPU.

A 4-rank gloo world (``python tests/test_torch_multirank_ckpt.py
--worker SPEC``) trains ``gpt_tiny`` at ``mp=2, sharding=2`` ZeRO 3 from
the JAX trainer's initial params and saves step 2 asynchronously: every
rank its shard files, each piece at its global index in the JAX layout,
a piece several ranks hold written once. Meanwhile the JAX trainer, on
the conftest's 8 CPU devices at ``dp=2, mp=2, sharding=2``, saves its
own step 2, which a fresh 4-rank port trainer then resumes. Held here:

- the JAX package verifies the port's checkpoint (a manifest per rank)
  and its ``load_state_dict`` reassembles exactly the port's gathered
  params, AdamW moments and step; every element is written by one rank
  only;
- the JAX trainer's checkpoint resumes in the port at 4 ranks: the
  gathered params and moments exactly the JAX trainer's, the next two
  losses within 1e-5 of its (the second follows an update that reads
  the moments);
- the port's 4-rank checkpoint resumes on one rank (a different mesh)
  and in the JAX trainer: params and moments exactly the saved ones, the
  next two losses within 1e-5 of the 4-rank run's.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, S = 4, 32
BASE = dict(learning_rate=1e-3, warmup_steps=2, eps=1e-5)
PORT_LAYOUT = dict(mp=2, sharding=2, zero_stage=3)
JAX_LAYOUT = dict(dp=2, mp=2, sharding=2, zero_stage=1)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (B, S)), rng.randint(0, 1024, (B, S)))


def _port_trainer(device="cpu", **layout):
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.parallel import hybrid

    return hybrid.HybridParallelTrainer(
        gpt_tiny(), hybrid.TrainerConfig(compute_dtype=torch.float32,
                                         **BASE, **layout), device=device)


def _gathered(t):
    """The trainer's params and moments as full arrays, keyed
    ``params/...``, ``opt/m/...``, ``opt/v/...``, ``opt/step`` (every
    rank must call it)."""
    from paddle_tpu_torch.utils.tree import flatten

    specs = t._layout.ospecs
    tree = {"params": t.full_params(),
            "opt": {"m": t._gather_full(t.opt["m"], specs),
                    "v": t._gather_full(t.opt["v"], specs),
                    "step": t.opt["step"].cpu()}}
    return {"/".join(p): v.numpy() for p, v in flatten(tree)}


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


# -- the rank worker (a spawned process; torch only) ---------------------------

def _worker(spec):
    import torch.distributed as dist

    rank, d = spec["rank"], spec["dir"]
    dist.init_process_group("gloo", init_method=spec["init"],
                            world_size=WORLD, rank=rank)
    out = {}
    t = _port_trainer(**PORT_LAYOUT)
    t.set_full_params(_unflat(dict(np.load(os.path.join(d, "init.npz")))))
    for seed in (0, 1):
        t.step(*_batch(seed))
    out["path"] = t.save_checkpoint(os.path.join(d, "port"), 2,
                                    async_save=True)
    t.flush_checkpoints()
    full = _gathered(t)
    if rank == 0:
        np.savez(os.path.join(d, "port-full.npz"), **full)
    out["losses"] = [float(t.step(*_batch(s))) for s in (2, 3)]
    ready = os.path.join(d, "jax", "READY")
    deadline = time.time() + 240
    while not os.path.exists(ready) and time.time() < deadline:
        time.sleep(0.1)
    fresh = _port_trainer(**PORT_LAYOUT)
    out["resumed_at"] = fresh.load_checkpoint(os.path.join(d, "jax"))
    out["global_step"] = fresh.global_step
    full = _gathered(fresh)
    if rank == 0:
        np.savez(os.path.join(d, "resumed-full.npz"), **full)
    out["resumed_losses"] = [float(fresh.step(*_batch(s))) for s in (2, 3)]
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_state(jt):
    """The JAX trainer's params and moments, keyed as :func:`_gathered`."""
    import jax

    return _flat(jax.device_get({"params": jt.params, "opt": jt.opt}))


def _assert_state_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_losses_close(got, want):
    for g, w in zip(got, want, strict=True):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel import HybridParallelTrainer, TrainerConfig
    from paddle_tpu.models.gpt import gpt_tiny

    d = str(tmp_path_factory.mktemp("multirank_ckpt"))
    jt = HybridParallelTrainer(gpt_tiny(), TrainerConfig(
        compute_dtype=jnp.float32, telemetry=False, compile_ledger=False,
        **BASE, **JAX_LAYOUT))
    np.savez(os.path.join(d, "init.npz"), **_flat(jax.device_get(jt.params)))
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         json.dumps({"rank": r, "init": init, "dir": d})], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        for seed in (0, 1):
            jt.step(*_batch(seed))
        jt.save_checkpoint(os.path.join(d, "jax"), step=2)
        jax_state = _jax_state(jt)
        open(os.path.join(d, "jax", "READY"), "w").close()
        jax_losses = [float(jt.step(*_batch(s))) for s in (2, 3)]
    finally:
        errs = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if p.returncode:
                errs.append(err[-3000:])
    assert not errs, errs
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"dir": d, "ranks": ranks, "jax_losses": jax_losses,
            "jax_state": jax_state,
            "full": dict(np.load(os.path.join(d, "port-full.npz"))),
            "resumed": dict(np.load(os.path.join(d, "resumed-full.npz")))}


def test_jax_package_reassembles_the_ranks_checkpoint(run):
    from paddle_tpu.distributed import checkpoint as jckpt

    path = run["ranks"][0]["path"]
    assert jckpt.verify_checkpoint(path) == (True, "ok")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["nprocs"] == WORLD
    assert sorted(os.listdir(path)) == sorted(
        ["meta.json"] + [f"{k}-{r}.{e}" for r in range(WORLD)
                         for k, e in (("shard", "pkl"), ("manifest", "json"))])
    got = jckpt.load_state_dict(path)
    # params, both moments and the step, exactly the ranks' own
    for k, want in run["full"].items():
        np.testing.assert_array_equal(got["".join(
            f"['{p}']" for p in k.split("/"))], want, err_msg=k)
    # each element written by one rank: the pieces' sizes sum to the
    # global sizes, name by name
    written = {}
    for r in range(WORLD):
        with open(os.path.join(path, f"shard-{r}.pkl"), "rb") as f:
            for name, pieces in pickle.load(f).items():
                written[name] = written.get(name, 0) + sum(
                    p["data"].size for p in pieces)
    assert written == {k: int(np.prod(v["shape"]))
                       for k, v in meta["tensors"].items()}


def test_jax_trainer_checkpoint_resumes_in_the_port_at_4_ranks(run):
    _assert_state_equal(run["resumed"], run["jax_state"])
    for r in run["ranks"]:
        assert (r["resumed_at"], r["global_step"]) == (2, 2)
        assert r["resumed_losses"] == run["ranks"][0]["resumed_losses"]
    _assert_losses_close(run["ranks"][0]["resumed_losses"],
                         run["jax_losses"])


def test_ranks_checkpoint_resumes_on_one_rank(run):
    from paddle_tpu_torch.utils.tree import flatten

    t = _port_trainer()
    assert t.load_checkpoint(os.path.join(run["dir"], "port")) == 2
    got = {"/".join(p): v.detach().numpy() for p, v in flatten(
        {"params": t.params, "opt": t.opt})}
    _assert_state_equal(got, run["full"])
    _assert_losses_close([float(t.step(*_batch(s))) for s in (2, 3)],
                         run["ranks"][0]["losses"])


def test_ranks_checkpoint_resumes_in_the_jax_trainer(run):
    import jax.numpy as jnp

    from paddle_tpu.models.gpt import gpt_tiny
    from paddle_tpu.parallel import HybridParallelTrainer, TrainerConfig

    jt = HybridParallelTrainer(gpt_tiny(), TrainerConfig(
        compute_dtype=jnp.float32, telemetry=False, compile_ledger=False,
        **BASE, **JAX_LAYOUT))
    assert jt.load_checkpoint(os.path.join(run["dir"], "port")) == 2
    _assert_state_equal(_jax_state(jt), run["full"])
    _assert_losses_close([float(jt.step(*_batch(s))) for s in (2, 3)],
                         run["ranks"][0]["losses"])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(json.loads(sys.argv[2]))

"""The port's multi-rank trainer against the JAX trainer on the same mesh
layout, on the CPU: GPT (``gpt_tiny``) and LLaMA (``llama_tiny``, 4
heads over 2 kv heads) at the pp == 1 layouts of the JAX package's
``tests/test_parallel.py`` (``dp=2, mp=2, sharding=2`` ZeRO 1;
``mp=2, sharding=4`` ZeRO 3; ``dp=2, mp=2, sep=2`` ZeRO 2; the BASELINE
long-context layout ``sep=2, mp=2, sharding=2`` ZeRO 3; and
``sep=2, mp=2``), each from the JAX trainer's initial params and on the
same batch: 3 fp32 steps, losses within 1e-4, every param leaf within
1e-4 of its largest value, and the state-memory plan key for key.

The port's ranks are processes of a gloo world spawned from this file
(``python tests/test_torch_hybrid.py --worker SPEC``), one world of 8
ranks for the 8-rank layouts and one of 4, each running every layout of
its size for both families; the JAX trainers run here meanwhile, on the
conftest's 8 CPU devices. The 4-rank world also runs the naive ring
(a sequence of 62, which does not divide by ``2 * sep``) against the
port's single-device trainer (itself held to the JAX one in
``test_torch_trainer.py``) at the same gates, and a step poisoned on
one rank only, which every rank must skip."""
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

BATCH, SEQ = 8, 64
BASE = dict(learning_rate=1e-3, warmup_steps=2, eps=1e-5)
LAYOUTS = {
    8: [dict(dp=2, mp=2, sharding=2, zero_stage=1),
        dict(mp=2, sharding=4, zero_stage=3),
        dict(dp=2, mp=2, sep=2, zero_stage=2),
        dict(sep=2, mp=2, sharding=2, zero_stage=3)],
    4: [dict(sep=2, mp=2)],
}
NAIVE_SEQ = 62          # 62 % (2 * sep) != 0: the naive ring
ARCHS = ("gpt", "llama")
CASES = [(arch, lay) for lay in LAYOUTS[8] + LAYOUTS[4] for arch in ARCHS]


def _tag(arch, lay, seq=SEQ):
    return arch + "-" + "-".join(f"{k}{v}" for k, v in sorted(lay.items())) \
        + ("" if seq == SEQ else f"-s{seq}")


def _batch(vocab, seq=SEQ):
    rng = np.random.RandomState(11)
    return (rng.randint(0, vocab, (BATCH, seq)),
            rng.randint(0, vocab, (BATCH, seq)))


def _port_cfg(arch):
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.models.llama import llama_tiny

    return gpt_tiny() if arch == "gpt" else llama_tiny()


# -- the rank worker (runs in a spawned process; torch only) -------------------

def _worker(spec):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import hybrid
    from paddle_tpu_torch.utils.tree import flatten

    rank, world = spec["rank"], spec["world"]
    dist.init_process_group("gloo", init_method=spec["init"],
                            world_size=world, rank=rank)
    out = {}
    for arch in ARCHS:
        mcfg = _port_cfg(arch)
        init = dict(np.load(os.path.join(spec["dir"], f"init-{arch}.npz")))
        full = {"blocks": {}}
        for k, v in init.items():
            node = full["blocks"] if k.startswith("blocks/") else full
            node[k.split("/")[-1]] = v
        for lay in LAYOUTS[world]:
            t = hybrid.HybridParallelTrainer(
                mcfg, hybrid.TrainerConfig(compute_dtype=torch.float32,
                                           **BASE, **lay), device="cpu")
            t.set_full_params(full)
            tok, lab = _batch(mcfg.vocab_size)
            losses = [float(t.step(tok, lab)) for _ in range(3)]
            params = t.full_params()
            plan = t.memory_plan()["state"]
            live = sum(x.numel() * x.element_size() for _, x in
                       flatten({"p": t.params, "o": t.opt}))
            tag = _tag(arch, lay)
            out[tag] = {"losses": losses, "live": live,
                        "plan": plan["total_per_device_bytes"],
                        "plan_global": plan["total_global_bytes"],
                        "gnorm": float(t.last_grad_norm)}
            if rank == 0:
                np.savez(os.path.join(spec["dir"], f"params-{tag}.npz"),
                         **{"/".join(p): v.numpy()
                            for p, v in flatten(params)})
        if world == 4:
            out[_tag(arch, LAYOUTS[4][0], NAIVE_SEQ)] = _naive_vs_serial(
                mcfg, full)
            out[f"{arch}-poison"] = _poisoned_on_one_rank(mcfg, rank)
            out[f"{arch}-over-ranks"] = _features_over_ranks(mcfg,
                                                              spec["dir"])
    with open(os.path.join(spec["dir"], f"w{world}-rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _naive_vs_serial(mcfg, full):
    """``sep=2, mp=2`` on a sequence the zigzag layout cannot cut (the
    naive ring, contiguous positions) against the single-device trainer:
    the worst loss gap and the worst leaf's gap over its largest value."""
    from paddle_tpu_torch.parallel import hybrid
    from paddle_tpu_torch.utils.tree import flatten

    tok, lab = _batch(mcfg.vocab_size, NAIVE_SEQ)
    sides = []
    for kw in (dict(sep=2, mp=2), {}):
        t = hybrid.HybridParallelTrainer(
            mcfg, hybrid.TrainerConfig(compute_dtype=torch.float32, **BASE,
                                       **kw), device="cpu")
        t.set_full_params(full)
        sides.append(([float(t.step(tok, lab)) for _ in range(3)],
                      dict(flatten(t.full_params()))))
    (lp, pp), (ls, ps) = sides
    return {"loss_gap": max(abs(a - b) / max(1.0, abs(b))
                            for a, b in zip(lp, ls)),
            "param_gap": max(float((pp[k] - v).abs().max() / v.abs().max())
                             for k, v in ps.items())}


def _features_over_ranks(mcfg, d):
    """What a world of ranks refused before the launcher slice and runs
    now (a checkpoint saved and loaded at the same step, the preemption
    guard, the consistency check, ``http_port``: each True), and ``sep >
    1`` without ``ring_attention``, which raised ``NotImplementedError``
    before and now builds and steps to a finite loss on the naive ring
    (True)."""
    from paddle_tpu_torch.parallel import hybrid

    cfg = hybrid.TrainerConfig(sep=2, mp=2)
    t = hybrid.HybridParallelTrainer(mcfg, cfg, device="cpu")
    root = os.path.join(d, f"ckpt-{type(mcfg).__name__}")

    def http():
        h = hybrid.HybridParallelTrainer(
            mcfg, hybrid.TrainerConfig(sep=2, mp=2, http_port=0),
            device="cpu").http
        h.stop()
        return h.port > 0

    calls = {"save_checkpoint": lambda: t.save_checkpoint(root, 1).endswith(
                 "step-1"),
             "load_checkpoint": lambda: t.load_checkpoint(root) == 1,
             "enable_preemption_guard": lambda: t.enable_preemption_guard(
                 root) is not None,
             "enable_consistency_check": lambda: t.enable_consistency_check(
                 1, exchange_dir=os.path.join(d, "cc")).every == 1,
             "http_port": http}
    out = {}
    for name, call in calls.items():
        try:
            out[name] = bool(call())
        except NotImplementedError as e:
            out[name] = f"raised: {e}"
    t._preempt_guard.uninstall()
    try:
        t = hybrid.HybridParallelTrainer(
            mcfg, hybrid.TrainerConfig(sep=2, mp=2, ring_attention=False),
            device="cpu")
        out["sep_without_ring"] = bool(np.isfinite(float(t.step(
            *_batch(mcfg.vocab_size)))))
    except NotImplementedError as e:
        out["sep_without_ring"] = f"raised: {e}"
    return out


def _poisoned_on_one_rank(mcfg, rank):
    """Step 2 is NaN on rank 3 only (the guard's fault point, armed in
    that process alone): every rank skips it and keeps its state."""
    from paddle_tpu_torch.parallel import hybrid
    from paddle_tpu_torch.utils.tree import flatten

    t = hybrid.HybridParallelTrainer(
        mcfg, hybrid.TrainerConfig(compute_dtype=torch.float32, sep=2, mp=2,
                                   **BASE), device="cpu")
    tok, lab = _batch(mcfg.vocab_size)
    t.step(tok, lab)
    before = [v.clone() for _, v in flatten({"p": t.params, "o": t.opt})]
    if rank == 3:
        os.environ["PADDLE_FI_NAN_AT_STEP"] = "2"
    t.step(tok, lab)
    os.environ.pop("PADDLE_FI_NAN_AT_STEP", None)
    after = [v for _, v in flatten({"p": t.params, "o": t.opt})]
    state = t.anomaly_state()
    return {"kept": all(torch.equal(a, b) for a, b in zip(before, after)),
            "skipped": state["last_skipped"],
            "skips": state["skips_total"]}


# -- the parent: spawn the worlds, run the JAX trainers -------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, d):
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("PADDLE_FI_NAN_AT_STEP", None)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         json.dumps({"rank": r, "world": world, "init": init, "dir": d})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


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
    """``(path, leaf)`` of a nested dict, the path's keys joined by /."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _flat(tree):
    return {k: np.asarray(v) for k, v in _walk(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax)``: per tag, each side's losses (and the port's
    memory numbers, the JAX params) after 3 steps."""
    import jax

    d = str(tmp_path_factory.mktemp("hybrid"))
    for arch in ARCHS:
        t = _jax_trainer(arch)
        np.savez(os.path.join(d, f"init-{arch}.npz"),
                 **_flat(jax.device_get(t.params)))
    worlds = {w: _spawn(w, d) for w in LAYOUTS}

    def run(case):
        # XLA compiles outside the GIL: a few trainers at a time overlap
        arch, lay = case
        t = _jax_trainer(arch, **lay)
        tok, lab = _batch(_jax_cfg(arch).vocab_size)
        losses = [float(t.step(tok, lab)) for _ in range(3)]
        return _tag(arch, lay), {"losses": losses,
                                 "params": _flat(jax.device_get(t.params))}

    try:
        with ThreadPoolExecutor(4) as ex:   # the rings' layouts first
            want = dict(ex.map(run, sorted(
                CASES, key=lambda c: -c[1].get("sep", 1))))
    finally:
        errs = {w: _join(p) for w, p in worlds.items()}
    assert not any(errs.values()), errs
    got = {}
    for world in LAYOUTS:
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f"w{world}-rank{r}.json")) as f:
                ranks.append(json.load(f))
        for tag in ranks[0]:
            got[tag] = {"ranks": [x[tag] for x in ranks]}
            path = os.path.join(d, f"params-{tag}.npz")
            if os.path.exists(path):
                got[tag]["params"] = dict(np.load(path))
    return got, want


@pytest.mark.parametrize("arch,lay", CASES, ids=[_tag(*c) for c in CASES])
def test_layout_matches_the_jax_trainer(runs, arch, lay):
    got, want = runs
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("lay", LAYOUTS[8] + LAYOUTS[4],
                         ids=[_tag("", l)[1:] for l in LAYOUTS[8]
                              + LAYOUTS[4]])
def test_state_memory_plan_matches_jax_per_rank(runs, arch, lay):
    """``plan_state_memory`` at the layout equals the JAX package's key
    for key, and every rank's live params and moments take exactly the
    planned per-rank bytes (the trainer's own ``memory_plan`` too)."""
    from paddle_tpu.observability.memory import plan_state_memory as jplan
    from paddle_tpu.parallel import TrainerConfig as JCfg
    from paddle_tpu_torch.observability.memory import plan_state_memory
    from paddle_tpu_torch.parallel.hybrid import TrainerConfig

    got = plan_state_memory(_port_cfg(arch), TrainerConfig(**lay))
    assert got == jplan(_jax_cfg(arch), JCfg(**lay))
    for r in runs[0][_tag(arch, lay)]["ranks"]:
        assert r["live"] == r["plan"] == got["total_per_device_bytes"]
        assert r["plan_global"] == got["total_global_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("lay", LAYOUTS[8] + LAYOUTS[4],
                         ids=[_tag("", l)[1:] for l in LAYOUTS[8]
                              + LAYOUTS[4]])
def test_shards_take_the_jax_shard_shapes_and_round_trip(arch, lay):
    """``shard_params`` cuts every leaf into the shape JAX's
    ``NamedSharding`` gives each device under the same sanitized spec
    (GPT's qkv reordered head-aligned first), and ``unshard_params``
    puts every rank's shards back into the JAX layout bit for bit."""
    import jax
    from jax.sharding import NamedSharding

    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.parallel import hybrid as jh
    from paddle_tpu_torch.parallel import hybrid as th
    from paddle_tpu_torch.utils.convert import shard_params, unshard_params
    from paddle_tpu_torch.utils.tree import flatten

    jcfg, tcfg = _jax_cfg(arch), _port_cfg(arch)
    init, specs_fn = jh._arch_for(jcfg)[:2]
    full = jax.device_get(init(jcfg, jax.random.PRNGKey(0)))
    mesh = build_mesh(**{k: v for k, v in lay.items() if k != "zero_stage"})
    stage = lay.get("zero_stage", 1)
    jspecs = jh.sanitize_specs(full, specs_fn(jcfg, stage, 1), mesh)
    with torch.device("meta"):
        shapes = th._arch_for(tcfg)[0](tcfg)
    tspecs = th.sanitize_specs(shapes, th._arch_for(tcfg)[1](tcfg, stage, 1),
                               mesh)
    shards = [shard_params(full, tcfg, tspecs, dict(mesh.shape), r)
              for r in range(mesh.size)]
    jflat = _flat(full)
    jspec_of = dict(_walk(jspecs))
    for path, leaf in flatten(shards[0]):
        name = "/".join(path)
        want = NamedSharding(mesh, jspec_of[name]).shard_shape(
            jflat[name].shape)
        assert tuple(leaf.shape) == tuple(want), (name, leaf.shape, want)
    back = _flat(unshard_params(shards, tcfg, tspecs, dict(mesh.shape)))
    assert set(back) == set(jflat)
    for k, v in jflat.items():
        assert np.array_equal(back[k], v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_naive_ring_layout_matches_the_single_device_trainer(runs, arch):
    for r in runs[0][_tag(arch, LAYOUTS[4][0], NAIVE_SEQ)]["ranks"]:
        assert r["loss_gap"] <= 1e-4 and r["param_gap"] <= 1e-4, r


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_rank_features_run_over_ranks(runs, arch):
    for r in runs[0][f"{arch}-over-ranks"]["ranks"]:
        assert all(v is True for v in r.values()), r


@pytest.mark.parametrize("arch", ARCHS)
def test_a_step_poisoned_on_one_rank_is_skipped_by_every_rank(runs, arch):
    for r in runs[0][f"{arch}-poison"]["ranks"]:
        assert r == {"kept": True, "skipped": True, "skips": 1}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(json.loads(sys.argv[2]))

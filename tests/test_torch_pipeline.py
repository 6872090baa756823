"""The port's pipeline parallelism against the JAX package's, on the CPU:
the trainer at ``pp > 1`` (GPipe, 1F1B, interleaved 1F1B, with data,
tensor, ZeRO-3 and sequence parallelism inside each stage) for GPT
(``gpt_tiny`` at 4 layers) and LLaMA (``llama_tiny``, 4 heads over 2 kv
heads, 4 layers), each from the JAX trainer's initial params and on the
same batch: 3 fp32 steps, each step's loss and grad norm within 1e-5
relative, every param leaf within 1e-4 of its largest value, and the
state-memory plan key for key with every rank's live bytes.

The layouts: the four pipelined ones of the JAX package's
``tests/test_parallel.py`` (``pp=2, dp=2, mp=2``; ``pp=4, mp=2``;
``pp=2, mp=2, sharding=2`` ZeRO 3; ``pp=2, vpp=2, mp=2``), GPipe at
``pp=2, dp=2``, 1F1B and interleaved with ``remat=False``, LLaMA at
``pp=2`` and at the BASELINE long-context ``pp=2, sep=2, sharding=2``
ZeRO 3 (the port's ring runs in each stage where the JAX package shards
the sequence by GSPMD: the same function). Each rank also reports the
most microbatches it held at once (1F1B: ``pp - s`` on stage s; GPipe:
M).

The port's ranks are processes of gloo worlds spawned from this file
(``python tests/test_torch_pipeline.py --worker SPEC``), one world per
size, each running every layout of its size; the JAX trainers run here
meanwhile, in threads, on the conftest's 8 CPU devices. The worlds also
run ``pipeline_forward`` against the JAX one, the tied ``wte``'s grad
(the head's part arrives from the last stage), a step poisoned on one
rank, and the shape errors the JAX package raises at the first step."""
import dataclasses
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

BATCH, SEQ, LAYERS = 8, 64, 4
BASE = dict(learning_rate=1e-3, warmup_steps=2, eps=1e-5)
LAYOUTS = {
    8: [("gpt", dict(pp=2, dp=2, mp=2, micro_batches=4)),
        ("gpt", dict(pp=4, mp=2, micro_batches=8)),
        ("gpt", dict(pp=2, mp=2, sharding=2, zero_stage=3,
                     micro_batches=2)),
        ("llama", dict(pp=2, sep=2, sharding=2, zero_stage=3,
                       micro_batches=2))],
    4: [("gpt", dict(pp=2, vpp=2, mp=2, micro_batches=4)),
        ("gpt", dict(pp=2, dp=2, pp_schedule="gpipe")),
        ("gpt", dict(pp=4, micro_batches=8, remat=False))],
    2: [("gpt", dict(pp=2, vpp=2, micro_batches=4, remat=False)),
        ("llama", dict(pp=2))],
}
CASES = [c for w in LAYOUTS for c in LAYOUTS[w]]
# the shape errors of the JAX schedules, raised at the first step:
# (layers, layout) of a trainer whose first step must raise
ERRORS = {
    "B % M": (4, dict(pp=2, micro_batches=3)),
    "L % (vpp*pp)": (2, dict(pp=2, vpp=2, micro_batches=2)),
    "M % pp": (4, dict(pp=2, vpp=2, micro_batches=1)),
}


def _tag(arch, lay):
    return arch + "-" + "-".join(f"{k}{v}" for k, v in sorted(lay.items()))


def _batch(vocab):
    rng = np.random.RandomState(11)
    return (rng.randint(0, vocab, (BATCH, SEQ)),
            rng.randint(0, vocab, (BATCH, SEQ)))


def _port_cfg(arch, layers=LAYERS):
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.models.llama import llama_tiny

    base = gpt_tiny() if arch == "gpt" else llama_tiny()
    return dataclasses.replace(base, num_layers=layers)


def _load_full(d, arch):
    init = dict(np.load(os.path.join(d, f"init-{arch}.npz")))
    full = {"blocks": {}}
    for k, v in init.items():
        node = full["blocks"] if k.startswith("blocks/") else full
        node[k.split("/")[-1]] = v
    return full


# -- the rank worker (runs in a spawned process; torch only) ------------------

def _worker(spec):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import hybrid, pipeline
    from paddle_tpu_torch.utils.tree import flatten

    rank, world, d = spec["rank"], spec["world"], spec["dir"]
    dist.init_process_group("gloo", init_method=spec["init"],
                            world_size=world, rank=rank)
    out = {}
    for arch, lay in LAYOUTS[world]:
        mcfg = _port_cfg(arch)
        t = hybrid.HybridParallelTrainer(
            mcfg, hybrid.TrainerConfig(compute_dtype=torch.float32,
                                       **BASE, **lay), device="cpu",
            params=_load_full(d, arch))
        tok, lab = _batch(mcfg.vocab_size)
        pipeline.reset_counters()
        losses, gnorms = [], []
        for _ in range(3):
            losses.append(float(t.step(tok, lab)))
            gnorms.append(float(t.last_grad_norm))
        params = t.full_params()
        plan = t.memory_plan()["state"]
        live = sum(x.numel() * x.element_size() for _, x in
                   flatten({"p": t.params, "o": t.opt}))
        tag = _tag(arch, lay)
        out[tag] = {"losses": losses, "gnorms": gnorms, "live": live,
                    "plan": plan["total_per_device_bytes"],
                    "plan_global": plan["total_global_bytes"],
                    "stage": t.mesh.coords["pipe"],
                    "in_flight": pipeline.COUNTERS["in_flight_max"]}
        if rank == 0:
            np.savez(os.path.join(d, f"params-{tag}.npz"),
                     **{"/".join(p): v.numpy() for p, v in flatten(params)})
    if world == 2:
        out["forward"] = _forward(d, rank)
        out["tied"] = _tied_wte(d, rank)
        out["errors"] = _errors()
    if world == 4:
        out["poison"] = _poisoned_on_one_rank(rank)
    with open(os.path.join(d, f"w{world}-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _two_stage_mesh():
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.parallel import hybrid, transformer_core as core

    mesh = build_mesh(pp=2, device="cpu")
    mcfg = _port_cfg("gpt")
    lay = hybrid._Layout(mcfg, hybrid.TrainerConfig(pp=2), mesh,
                         core.gpt_param_specs)
    return mesh, mcfg, lay.pspecs


def _forward(d, rank):
    """``pipeline_forward`` at pp=2, M=4 from the shared weights: the
    last stage's fp32 logits (saved for the parent), None on stage 0;
    and ``pipeline_loss``, the same on every rank."""
    from paddle_tpu_torch.parallel import pipeline
    from paddle_tpu_torch.utils.convert import shard_params

    mesh, mcfg, specs = _two_stage_mesh()
    params = shard_params(_load_full(d, "gpt"), mcfg, specs, mesh.shape,
                          rank)
    tok, lab = (torch.as_tensor(x) for x in _batch(mcfg.vocab_size))
    logits = pipeline.pipeline_forward(
        mcfg, params, tok, 2, 4, compute_dtype=torch.float32, mesh=mesh,
        specs=specs)
    if logits is not None:
        np.save(os.path.join(d, "forward-logits.npy"), logits.numpy())
    loss = pipeline.pipeline_loss(mcfg, params, tok, lab, 2, 4,
                                  compute_dtype=torch.float32, mesh=mesh,
                                  specs=specs)
    return {"no_logits": logits is None, "loss": float(loss)}


def _tied_wte(d, rank):
    """1F1B's grads at pp=2 against the single-device ``gpt_loss``
    autograd: stage 0's ``wte`` grad is the embedding's part, the last
    stage's the head's, and their sum over ``"pipe"`` is the whole."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import pipeline, transformer_core as core
    from paddle_tpu_torch.utils.convert import shard_params
    from paddle_tpu_torch.utils.tree import tree_map

    mesh, mcfg, specs = _two_stage_mesh()
    full = tree_map(torch.as_tensor, _load_full(d, "gpt"))
    params = shard_params(full, mcfg, specs, mesh.shape, rank)
    tok, lab = (torch.as_tensor(x) for x in _batch(mcfg.vocab_size))
    loss, grads = pipeline.pipeline_1f1b_grads(
        mcfg, params, tok, lab, 2, 4, compute_dtype=torch.float32,
        mesh=mesh, specs=specs)
    wte = full["wte"].clone().requires_grad_(True)
    # the single-device loss with the embedding's and the head's uses of
    # wte apart: the embedding's part is d/d(wte in the lookup)
    emb = wte.detach().clone().requires_grad_(True)
    ref = core.gpt_loss(mcfg, dict(full, wte=wte), tok, lab,
                        compute_dtype=torch.float32, remat=False)
    whole = torch.autograd.grad(ref, wte)[0]
    x = core.gpt_trunk(mcfg, dict(full, wte=emb), tok, torch.float32,
                       remat=False)
    head_only = core.chunked_xent(mcfg, dict(full, wte=wte.detach()), x,
                                  lab, torch.float32)
    emb_part = torch.autograd.grad(head_only, emb)[0]
    mine = grads["wte"].clone()
    part = (emb_part if rank == 0 else whole - emb_part)
    dist.all_reduce(grads["wte"], group=mesh.group("pipe"))
    scale = float(whole.abs().max())
    return {"loss_gap": abs(float(loss) - float(ref)) / float(ref),
            "part_gap": float((mine - part).abs().max()) / scale,
            "sum_gap": float((grads["wte"] - whole).abs().max()) / scale,
            "part_norm": float(part.norm() / whole.norm())}


def _errors():
    """Each shape error's message at the first step (None if no
    error)."""
    from paddle_tpu_torch.parallel import hybrid

    out = {}
    for name, (layers, lay) in ERRORS.items():
        mcfg = _port_cfg("gpt", layers)
        t = hybrid.HybridParallelTrainer(
            mcfg, hybrid.TrainerConfig(compute_dtype=torch.float32, **lay),
            device="cpu")
        try:
            t.step(*_batch(mcfg.vocab_size))
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _poisoned_on_one_rank(rank):
    """Step 2 is NaN on rank 3 only (the last stage's second data rank):
    every rank skips it and keeps its state."""
    from paddle_tpu_torch.parallel import hybrid
    from paddle_tpu_torch.utils.tree import flatten

    mcfg = _port_cfg("gpt")
    t = hybrid.HybridParallelTrainer(
        mcfg, hybrid.TrainerConfig(compute_dtype=torch.float32, pp=2, dp=2,
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


# -- the parent: spawn the worlds, run the JAX trainers -----------------------

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


def _jax_cfg(arch, layers=LAYERS):
    from paddle_tpu.models.gpt import gpt_tiny
    from paddle_tpu.models.llama import llama_tiny

    base = gpt_tiny() if arch == "gpt" else llama_tiny()
    return dataclasses.replace(base, num_layers=layers)


def _jax_trainer(arch, layers=LAYERS, **kw):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel import HybridParallelTrainer, TrainerConfig

    cfg = TrainerConfig(compute_dtype=jnp.float32, telemetry=False,
                        compile_ledger=False, **kw)
    devices = None if any(kw.get(a, 1) > 1 for a in
                          ("dp", "pp", "mp", "sharding", "sep")) else (
        jax.devices()[:1])
    return HybridParallelTrainer(_jax_cfg(arch, layers), cfg,
                                 devices=devices)


def _recording_norms(t):
    """The JAX trainer's step with each step's grad norm recorded (the
    step function returns it; the trainer keeps none)."""
    norms, step_fn = [], t._step_fn

    def recorded(*args):
        out = step_fn(*args)
        norms.append(float(out[4]))
        return out

    t._step_fn = recorded
    return norms


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _flat(tree):
    return {k: np.asarray(v) for k, v in _walk(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax)``: per tag, the port's per-rank reports and gathered
    params, and the JAX trainer's losses, grad norms and params."""
    import jax

    d = str(tmp_path_factory.mktemp("pipeline"))
    for arch in ("gpt", "llama"):
        t = _jax_trainer(arch)
        np.savez(os.path.join(d, f"init-{arch}.npz"),
                 **_flat(jax.device_get(t.params)))
    worlds = {w: _spawn(w, d) for w in LAYOUTS}

    def run(case):
        arch, lay = case
        t = _jax_trainer(arch, **BASE, **lay)
        norms = _recording_norms(t)
        tok, lab = _batch(_jax_cfg(arch).vocab_size)
        losses = [float(t.step(tok, lab)) for _ in range(3)]
        return _tag(arch, lay), {"losses": losses, "gnorms": norms,
                                 "params": _flat(jax.device_get(t.params))}

    try:
        with ThreadPoolExecutor(4) as ex:   # the longest compiles first
            want = dict(ex.map(run, sorted(
                CASES, key=lambda c: (-c[1].get("sep", 1),
                                      -c[1].get("vpp", 1),
                                      -c[1]["pp"]))))
    finally:
        errs = {w: _join(p) for w, p in worlds.items()}
    assert not any(errs.values()), errs
    got = {"dir": d}
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
    for r in g["ranks"]:            # every rank reports the global values
        assert r["losses"] == g["ranks"][0]["losses"], tag
        assert r["gnorms"] == g["ranks"][0]["gnorms"], tag
    for key in ("losses", "gnorms"):
        for a, b in zip(g["ranks"][0][key], w[key]):
            assert abs(a - b) <= 1e-5 * abs(b), (tag, key, a, b)
    assert set(g["params"]) == set(w["params"])
    for k, ref in w["params"].items():
        err = float(np.abs(g["params"][k] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (tag, k, err)


@pytest.mark.parametrize("arch,lay", CASES, ids=[_tag(*c) for c in CASES])
def test_microbatches_in_flight(runs, arch, lay):
    """1F1B holds at most ``pp - s`` microbatches on stage s (exactly
    ``min(pp - s, M)``), GPipe all M on every stage; the interleaved
    schedule's depth does not grow with M past the JAX ring's
    ``2 * vpp * pp - 1`` chunk entries."""
    pp = lay["pp"]
    m = lay.get("micro_batches") or 2 * pp
    for r in runs[0][_tag(arch, lay)]["ranks"]:
        s = r["stage"]
        if lay.get("pp_schedule") == "gpipe":
            assert r["in_flight"] == m, r
        elif lay.get("vpp", 1) == 1:
            assert r["in_flight"] == min(pp - s, m), r
        else:
            assert 1 <= r["in_flight"] <= min(m, 2 * lay["vpp"] * pp - 1)


@pytest.mark.parametrize("arch,lay", CASES, ids=[_tag(*c) for c in CASES])
def test_state_memory_plan_matches_jax_per_rank(runs, arch, lay):
    """``plan_state_memory`` at the layout equals the JAX package's key
    for key, and every rank's live params and moments take exactly the
    planned per-rank bytes."""
    from paddle_tpu.observability.memory import plan_state_memory as jplan
    from paddle_tpu.parallel import TrainerConfig as JCfg
    from paddle_tpu_torch.observability.memory import plan_state_memory
    from paddle_tpu_torch.parallel.hybrid import TrainerConfig

    got = plan_state_memory(_port_cfg(arch), TrainerConfig(**lay))
    assert got == jplan(_jax_cfg(arch), JCfg(**lay))
    for r in runs[0][_tag(arch, lay)]["ranks"]:
        assert r["live"] == r["plan"] == got["total_per_device_bytes"]
        assert r["plan_global"] == got["total_global_bytes"]


@pytest.mark.parametrize("arch,lay", CASES, ids=[_tag(*c) for c in CASES])
def test_shards_take_the_jax_pipe_shard_shapes(arch, lay):
    """``shard_params`` gives each rank its ``"pipe"`` shard: the shape
    JAX's ``NamedSharding`` gives each device under the same sanitized
    spec, the block leaves' layers ``[s*L/pp, (s+1)*L/pp)``."""
    import jax
    from jax.sharding import NamedSharding

    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.parallel import hybrid as jh
    from paddle_tpu_torch.parallel import hybrid as th
    from paddle_tpu_torch.utils.convert import shard_params, shard_slices
    from paddle_tpu_torch.utils.tree import flatten

    jcfg, tcfg = _jax_cfg(arch), _port_cfg(arch)
    init, specs_fn = jh._arch_for(jcfg)[:2]
    full = jax.device_get(init(jcfg, jax.random.PRNGKey(0)))
    axes = {k: v for k, v in lay.items()
            if k in ("dp", "pp", "mp", "sharding", "sep")}
    mesh = build_mesh(**axes)
    stage = lay.get("zero_stage", 1)
    jspecs = jh.sanitize_specs(full, specs_fn(jcfg, stage, lay["pp"]), mesh)
    with torch.device("meta"):
        shapes = th._arch_for(tcfg)[0](tcfg)
    tspecs = th.sanitize_specs(
        shapes, th._arch_for(tcfg)[1](tcfg, stage, lay["pp"]), mesh)
    jflat = _flat(full)
    jspec_of = dict(_walk(jspecs))
    Lpp = LAYERS // lay["pp"]
    for rank in range(mesh.size):
        shard = shard_params(full, tcfg, tspecs, dict(mesh.shape), rank)
        s = (rank // (mesh.size // (lay.get("dp", 1) * lay["pp"]))
             ) % lay["pp"]
        for path, leaf in flatten(shard):
            name = "/".join(path)
            want = NamedSharding(mesh, jspec_of[name]).shard_shape(
                jflat[name].shape)
            assert tuple(leaf.shape) == tuple(want), (name, leaf.shape, want)
            if path[0] == "blocks":
                sl = shard_slices(jflat[name].shape, jspec_of[name],
                                  dict(mesh.shape), rank)[0]
                assert (sl.start, sl.stop) == (s * Lpp, (s + 1) * Lpp)


def test_pipeline_forward_matches_jax(runs):
    """The port's ``pipeline_forward`` (pp=2, M=4) on the last stage
    equals the JAX package's on the same weights and tokens, and its
    ``pipeline_loss`` the JAX one on every rank."""
    import jax.numpy as jnp

    from paddle_tpu.parallel.pipeline import pipeline_forward, pipeline_loss

    ranks = runs[0]["forward"]["ranks"]
    # no logits on stage 0, some on stage 1
    assert [r["no_logits"] for r in ranks] == [True, False]
    d = runs[0]["dir"]
    full = jax_tree(_load_full(d, "gpt"))
    tok, lab = (jnp.asarray(x, jnp.int32)
                for x in _batch(_jax_cfg("gpt").vocab_size))
    loss = float(pipeline_loss(_jax_cfg("gpt"), full, tok, lab, 2, 4,
                               compute_dtype=jnp.float32))
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-5 * loss, (r, loss)
    want = np.asarray(pipeline_forward(
        _jax_cfg("gpt"), full, tok, 2, 4, compute_dtype=jnp.float32))
    got = np.load(os.path.join(d, "forward-logits.npy"))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-5 * max(
        1.0, float(np.abs(want).max()))


def jax_tree(full):
    import jax.numpy as jnp

    return {k: (jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in full.items()}


def test_tied_wte_takes_the_heads_grad_from_the_last_stage(runs):
    """Stage 0's ``wte`` grad is the embedding's part, the last stage's
    the head's (a large share of the whole), and the sum over
    ``"pipe"`` is the single-device grad: without that sum the tied
    ``wte`` would lose the head's part."""
    for r in runs[0]["tied"]["ranks"]:
        assert r["loss_gap"] <= 1e-6, r
        assert r["part_gap"] <= 1e-5 and r["sum_gap"] <= 1e-5, r
    assert runs[0]["tied"]["ranks"][1]["part_norm"] > 0.1


def test_shape_errors_raise_as_in_jax(runs):
    """``B % M``, ``L % (vpp * pp)`` and ``M % pp`` raise ``ValueError``
    at the first step in both packages, with the JAX package's
    message."""
    got = runs[0]["errors"]["ranks"]
    for name, (layers, lay) in ERRORS.items():
        t = _jax_trainer("gpt", layers, **lay)
        with pytest.raises(ValueError) as info:
            t.step(*_batch(_jax_cfg("gpt").vocab_size))
        for r in got:
            assert r[name] == str(info.value), (name, r[name])


@pytest.mark.parametrize("kw,match", [
    ({"pp": 2, "loss_scaling": True}, "loss_scaling"),
    ({"pp": 2, "packed_sequences": True}, "packed_sequences"),
    ({"pp": 2, "vpp": 2, "pp_schedule": "gpipe"}, "vpp")])
def test_pipeline_rejects_what_jax_rejects(kw, match):
    from paddle_tpu_torch.parallel import hybrid as th

    with pytest.raises(ValueError, match=match):
        _jax_trainer("gpt", **kw)
    with pytest.raises(ValueError, match=match):
        th.HybridParallelTrainer(_port_cfg("gpt"), th.TrainerConfig(**kw),
                                 device="cpu")


def test_a_step_poisoned_on_one_rank_is_skipped_by_every_rank(runs):
    for r in runs[0]["poison"]["ranks"]:
        assert r == {"kept": True, "skipped": True, "skips": 1}


def test_vpp_without_pp_trains_as_one_stage():
    """``vpp=2`` with ``pp == 1`` is not pipelined in the JAX package: it
    trains as ``pp == 1``; so does the port, step for step equal to its
    plain trainer and within the gates of the JAX one."""
    import jax

    from paddle_tpu_torch.parallel import hybrid as th
    from paddle_tpu_torch.utils.tree import flatten

    jt = _jax_trainer("gpt", vpp=2, **BASE)
    norms = _recording_norms(jt)
    full = jax.tree_util.tree_map(np.array, jax.device_get(jt.params))
    tok, lab = _batch(_jax_cfg("gpt").vocab_size)
    want = [float(jt.step(tok, lab)) for _ in range(3)]
    sides = []
    for kw in ({"vpp": 2}, {}):
        t = th.HybridParallelTrainer(
            _port_cfg("gpt"), th.TrainerConfig(compute_dtype=torch.float32,
                                               **BASE, **kw),
            device="cpu", params=full)
        assert t.mesh is None
        losses, gn = [], []
        for _ in range(3):
            losses.append(float(t.step(tok, lab)))
            gn.append(float(t.last_grad_norm))
        sides.append((losses, gn, dict(flatten(t.full_params()))))
    (lv, gv, pv), (lp, gp, pp1) = sides
    assert lv == lp and gv == gp
    assert all(torch.equal(pv[k], pp1[k]) for k in pp1)
    for a, b in zip(lv + gv, want + norms):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    jflat = _flat(jax.device_get(jt.params))
    for k, ref in jflat.items():
        err = float(np.abs(pv[tuple(k.split("/"))].numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (k, err)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(json.loads(sys.argv[2]))

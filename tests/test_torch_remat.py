"""The remat policies of the port's training cores against the JAX
package's on the CPU: for every policy (False, True, "full", "dots",
"names:attn_out_kernel,attn_lse", "names:attn_out" and, for LLaMA,
"names:attn_out,ffn_in") the loss and grads of ``gpt_loss`` /
``llama_loss`` equal the JAX package's and the port's own ``remat=False``
grads (atol 1e-5 and 1e-6), and three trainer steps equal the JAX
trainer's under the same policy, at the trainer gates (losses atol 1e-5,
params after 3 steps 2e-5); and the plain attention forward runs
once a layer a step where the policy saves its outputs (o and lse, the
JAX package's ``attn_out_kernel`` and ``attn_lse``), twice where it
recomputes them, on K-PACK's op and, packed, on K-SEG's; a named
``ffn_in`` product is not run again in the recompute. Tiny configs
(GPT tiny and LLaMA tiny, 2 layers), fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as JM
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import hybrid as jhybrid
from paddle_tpu.parallel import llama_core as jllama
from paddle_tpu.parallel import transformer_core as jgpt
from paddle_tpu_torch.io.packing import pack_documents
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.kernels import flash_attention_packed as fp
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.parallel import llama_core as tllama
from paddle_tpu_torch.parallel import transformer_core as tgpt
from paddle_tpu_torch.utils.convert import from_gpt_params, from_llama_params
from paddle_tpu_torch.utils.tree import flatten, unflatten

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

B, S = 2, 48
ATOL = 1e-5
EPS = 1e-5      # Adam's eps, as tests/test_torch_trainer.py sets it
NAMES = "names:attn_out_kernel,attn_lse"
POLICIES = [False, True, "full", "dots", NAMES, "names:attn_out"]
CASES = ([("gpt", p) for p in POLICIES]
         + [("llama", p) for p in POLICIES + ["names:attn_out,ffn_in"]])

# arch -> (JAX config, port config, JAX init, JAX loss, port loss,
#          JAX params -> port params)
ARCHS = {
    "gpt": (JM.gpt_tiny, TM.gpt_tiny, jgpt.gpt_init, jgpt.gpt_loss,
            tgpt.gpt_loss, from_gpt_params),
    "llama": (JL.llama_tiny, TL.llama_tiny, jllama.llama_init,
              jllama.llama_loss, tllama.llama_loss, from_llama_params),
}


def _leaves(tree):
    return {"/".join(p): np.asarray(v) for p, v in flatten(tree)}


@pytest.fixture(scope="module")
def jax_params():
    return {arch: jax.device_get(a[2](a[0](), jax.random.PRNGKey(0)))
            for arch, a in ARCHS.items()}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (B, S)).astype(np.int32),
            rng.randint(0, 1024, (B, S)).astype(np.int32))


def _port_loss_and_grads(arch, params, tok, lab, remat):
    _, tcfg, _, _, loss_fn, convert = ARCHS[arch]
    flat = flatten(convert(params, tcfg()))
    paths = [p for p, _ in flat]
    leaves = [t.requires_grad_() for _, t in flat]
    loss = loss_fn(tcfg(), unflatten(zip(paths, leaves)),
                   torch.from_numpy(tok).long(), torch.from_numpy(lab).long(),
                   compute_dtype=torch.float32, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {"/".join(p): g.numpy()
                                  for p, g in zip(paths, grads)}


@pytest.fixture(scope="module")
def reference(jax_params):
    """Per arch: the JAX package's loss and grads (``remat=False``; its
    policies change no value, and each policy's JAX trainer is held
    below) and the port's own ``remat=False`` grads."""
    tok, lab = _batch()
    out = {}
    for arch, (jcfg, _, _, jloss, _, _) in ARCHS.items():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jloss(jcfg(), p, jnp.asarray(tok), jnp.asarray(lab),
                            compute_dtype=jnp.float32, remat=False)))(
            jax_params[arch])
        out[arch] = (float(loss), _leaves(jax.device_get(grads)),
                     _port_loss_and_grads(arch, jax_params[arch], tok, lab,
                                          False)[1])
    return out


@pytest.mark.parametrize("arch,remat", CASES)
def test_policy_loss_and_grads_match_jax(jax_params, reference, arch,
                                         remat):
    tok, lab = _batch()
    want_loss, want, no_remat = reference[arch]
    loss, got = _port_loss_and_grads(arch, jax_params[arch], tok, lab, remat)
    assert abs(loss - want_loss) <= ATOL, (loss, want_loss)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(g, no_remat[name], rtol=0, atol=1e-6,
                                   err_msg=f"{name} vs no remat")


def _trainers(arch, remat):
    jcfg, tcfg, _, _, _, convert = ARCHS[arch]
    base = dict(compute_dtype=jnp.float32, learning_rate=1e-3,
                warmup_steps=2, eps=EPS, remat=remat)
    jt = jhybrid.HybridParallelTrainer(
        jcfg(), jhybrid.TrainerConfig(telemetry=False, compile_ledger=False,
                                      **base), devices=jax.devices()[:1])
    base["compute_dtype"] = torch.float32
    tt = thybrid.HybridParallelTrainer(tcfg(), thybrid.TrainerConfig(**base),
                                       device="cpu")
    tt.params = convert(jax.device_get(jt.params), tcfg())
    return jt, tt


@pytest.mark.parametrize("arch,remat", CASES)
def test_policy_trainer_three_steps_match_jax(monkeypatch, arch, remat):
    monkeypatch.delenv("PADDLE_FI_NAN_AT_STEP", raising=False)
    jt, tt = _trainers(arch, remat)
    tok, lab = _batch(5)
    for _ in range(3):
        want, got = float(jt.step(tok, lab)), float(tt.step(tok, lab))
        assert abs(got - want) <= ATOL, (got, want)
    want, got = _leaves(jax.device_get(jt.params)), _leaves(tt.params)
    assert set(got) == set(want)
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 2e-5
    assert tt.anomaly_state() == jt.anomaly_state()


# (policy, forward runs per layer per step): the op's outputs are saved,
# and its recompute skipped, only when both of its names are named
RUNS = [(False, 1), (True, 2), ("full", 2), ("dots", 2), (NAMES, 1),
        ("names:attn_out", 2), ("names:attn_out_kernel", 2),
        ("names:attn_lse,attn_out_kernel,ffn_in", 1), ("names:bogus", 2)]


@pytest.mark.parametrize("remat,per_layer", RUNS)
@pytest.mark.parametrize("packed", [False, True], ids=["pack", "seg"])
def test_forward_runs_per_step(remat, per_layer, packed):
    cfg = dataclasses.replace(TM.gpt_tiny(), num_layers=3)
    t = thybrid.HybridParallelTrainer(
        cfg, thybrid.TrainerConfig(compute_dtype=torch.float32, remat=remat,
                                   packed_sequences=packed), device="cpu")
    if packed:
        rng = np.random.RandomState(1)
        docs = [rng.randint(0, 1024, n).astype(np.int32)
                for n in (20, 31, 9, 40, 17)]
        rows = pack_documents(docs, S)[:B]
        batch = {f: np.stack([getattr(r, f) for r in rows])
                 for f in ("tokens", "labels", "segment_ids", "positions")}
    else:
        tok, lab = _batch(2)
        batch = dict(tokens=tok, labels=lab)
    kernel = "K-SEG" if packed else "K-PACK"
    other = "K-PACK" if packed else "K-SEG"
    for _ in range(2):
        fp.PLAIN_CALLS.update({kernel: 0, other: 0})
        t.step(**batch)
        assert fp.PLAIN_CALLS == {kernel: per_layer * 3, other: 0}


@pytest.mark.parametrize("op", ["packed_fwd", "seg_fwd"])
def test_forward_ops_give_shapes_on_meta(op):
    """The operators a policy saves answer with their outputs' shapes on
    the ``meta`` device (the wrappers refuse it: no kernel)."""
    x = torch.empty(2, 40, 4 * 32, device="meta")
    seg = torch.empty(2, 40, dtype=torch.int32, device="meta")
    args = (x, x, x, 4, True, 0.5) if op == "packed_fwd" else (
        x, x, x, seg, seg, 4, True, 0.5)
    o, lse = getattr(torch.ops.paddle_tpu_torch, op)(*args)
    assert o.shape == x.shape and o.dtype == x.dtype
    assert lse.shape == (2, 40, 4) and lse.dtype == torch.float32
    assert o.device.type == lse.device.type == "meta"


def test_tags_cost_nothing_outside_a_names_policy():
    """Outside a names: policy a tag is its operator alone; under one that
    names it, ``checkpoint_name`` is a view of the value (no copy) and
    the grads are the untagged ones."""
    x = torch.randn(2, 3)
    assert tgpt.checkpoint_name(x, "attn_out") is x
    assert torch.equal(tgpt.named_op("ffn_in", torch.mul, x, x), x * x)
    made, tagged = [], []

    def body(y):
        z = y * 3
        made.append(z)
        tagged.append(tgpt.checkpoint_name(z, "attn_out"))
        return tagged[-1] * 2

    y = torch.randn(2, 3, requires_grad=True)
    out = tgpt._remat_wrap(body, "names:attn_out")(y)
    (g,) = torch.autograd.grad(out.sum(), y)
    assert tagged[0].data_ptr() == made[0].data_ptr()
    assert torch.equal(out, y.detach() * 6)
    assert torch.equal(g, torch.full_like(y, 6.0))


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts one operator's runs, recomputes included (a selective
    policy's saved outputs are handed back without running it)."""

    def __init__(self, op):
        super().__init__()
        self.op, self.n = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is self.op
        return func(*args, **(kwargs or {}))


# arch -> the operator that makes its ``ffn_in``: GPT's fc_in product,
# LLaMA's ``gate * up``
FFN_IN_OPS = {"gpt": torch.ops.aten.addmm.default,
              "llama": torch.ops.aten.mul.Tensor}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_named_products_are_not_run_again(jax_params, arch):
    """Naming ``ffn_in`` spares the recompute its product, once a layer a
    step, as the JAX package's saved value spares its recompute;
    ``attn_out`` spares no operator; "dots" recomputes no product."""
    tok, lab = _batch()
    layers = ARCHS[arch][1]().num_layers

    def runs(remat):
        with _CountOps(FFN_IN_OPS[arch]) as mode:
            _port_loss_and_grads(arch, jax_params[arch], tok, lab, remat)
        return mode.n

    full = runs("full")
    assert runs("names:ffn_in") == full - layers
    assert runs(NAMES + ",ffn_in") == full - layers
    assert runs("names:attn_out") == full
    assert runs(False) < full
    if arch == "gpt":
        assert runs("dots") == runs(False)


@pytest.mark.parametrize("remat", ["names", "dot", "everything", 3])
def test_unknown_policy_raises_in_both_packages(remat):
    with pytest.raises(ValueError, match="unknown remat policy"):
        jgpt._remat_wrap(lambda x: x, remat)
    with pytest.raises(ValueError, match="unknown remat policy"):
        thybrid.HybridParallelTrainer(
            TM.gpt_tiny(), thybrid.TrainerConfig(remat=remat), device="cpu")

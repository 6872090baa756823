"""The PyTorch port stands alone: ``paddle_tpu_torch`` and
``chip_smoke.py`` import neither ``jax`` nor anything of ``paddle_tpu``,
and the port's entry points run on CUDA unless the caller asks for the
CPU."""
import os
import re
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "paddle_tpu_torch")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
print(len(names), bad, " ".join(names))
assert not bad, bad
"""

# modules the walk must reach (the training, LLaMA and launcher slices'
# among them)
_MUST_IMPORT = {
    "paddle_tpu_torch.models.llama",
    "paddle_tpu_torch.parallel.llama_core",
    "paddle_tpu_torch.parallel.hybrid",
    "paddle_tpu_torch.parallel.transformer_core",
    "paddle_tpu_torch.utils.fault_injection",
    "paddle_tpu_torch.utils.convert",
    "paddle_tpu_torch.ops.kernels.flash_attention_packed",
    "paddle_tpu_torch.io.packing",
    "paddle_tpu_torch.distributed.checkpoint",
    "paddle_tpu_torch.utils.preemption",
    "paddle_tpu_torch.observability",
    "paddle_tpu_torch.observability.metrics",
    "paddle_tpu_torch.observability.sink",
    "paddle_tpu_torch.observability.hw",
    "paddle_tpu_torch.observability.step_stats",
    "paddle_tpu_torch.observability.memory",
    "paddle_tpu_torch.observability.tracing",
    "paddle_tpu_torch.observability.slo",
    "paddle_tpu_torch.observability.http_endpoint",
    "paddle_tpu_torch.serving.kv_cache",
    "paddle_tpu_torch.serving.loadgen",
    "paddle_tpu_torch.serving.tenancy",
    "paddle_tpu_torch.serving.replica",
    "paddle_tpu_torch.serving.router",
    "paddle_tpu_torch.serving.disagg",
    "paddle_tpu_torch.distributed.mesh",
    "paddle_tpu_torch.distributed.communication",
    "paddle_tpu_torch.ops.ring_attention",
    "paddle_tpu_torch.parallel.pipeline",
    "paddle_tpu_torch.nn",
    "paddle_tpu_torch.nn.functional",
    "paddle_tpu_torch.nn.functional.attention",
    "paddle_tpu_torch.models.bert",
    "paddle_tpu_torch.distributed.env",
    "paddle_tpu_torch.distributed.launch",
    "paddle_tpu_torch.distributed.launch.main",
    "paddle_tpu_torch.distributed.launch.watcher",
    "paddle_tpu_torch.distributed.launch.__main__",
    "paddle_tpu_torch.distributed.fleet.elastic",
    "paddle_tpu_torch.distributed.consistency",
    "paddle_tpu_torch.distributed.collective_runtime",
    "paddle_tpu_torch.framework.random",
    "paddle_tpu_torch.ops.kernels.philox",
    "paddle_tpu_torch.nn.layer.transformer",
    "paddle_tpu_torch.incubate.nn.layer.fused_transformer",
}


def test_port_imports_without_jax_or_paddle_tpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    n_modules = int(p.stdout.split()[0])
    assert n_modules >= 40, p.stdout
    assert _MUST_IMPORT <= set(p.stdout.split()[2:]), p.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|paddle_tpu)(\.|\s|$)|"
    r"^\s*import\s+.*\b(jax|paddle_tpu)\b(?!_torch)")


def test_port_sources_never_import_jax_or_paddle_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = []
    for f in files:
        with open(f) as fh:
            for i, line in enumerate(fh, 1):
                if _FORBIDDEN.search(line):
                    offenders.append(f"{os.path.relpath(f, ROOT)}:{i}: "
                                     f"{line.strip()}")
    assert len(files) >= 20
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {"paddle_tpu_torch/parallel/hybrid.py",
            "paddle_tpu_torch/parallel/transformer_core.py",
            "paddle_tpu_torch/distributed/checkpoint.py",
            "paddle_tpu_torch/distributed/mesh.py",
            "paddle_tpu_torch/distributed/communication/__init__.py",
            "paddle_tpu_torch/ops/ring_attention.py",
            "paddle_tpu_torch/utils/preemption.py"} <= names
    assert {f"paddle_tpu_torch/observability/{m}.py" for m in (
        "__init__", "metrics", "sink", "hw", "step_stats", "memory",
        "tracing", "slo", "http_endpoint")} <= names
    assert {f"paddle_tpu_torch/serving/{m}.py" for m in (
        "kv_cache", "loadgen", "tenancy", "replica", "router",
        "disagg")} <= names
    assert not offenders, offenders


def test_entry_points_default_to_cuda():
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    assert next(m.parameters()).device.type == "cpu"


def test_bert_and_kv_pools_default_to_cuda():
    """``BertForPretraining`` and ``PagedKVCache`` (whose pools were
    allocated on the CPU when no device was given) run on CUDA unless the
    caller asks for the CPU."""
    from paddle_tpu_torch.models.bert import BertForPretraining, bert_base
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache

    cfg = bert_base(num_layers=1, hidden_size=64, num_heads=4,
                    vocab_size=128)
    geo = dict(num_layers=1, num_pages=2, page_size=4, num_kv_heads=1,
               head_dim=8)
    if torch.cuda.is_available():
        assert PagedKVCache(**geo).k_pools[0].device.type == "cuda"
        return
    for build in (lambda: BertForPretraining(cfg),
                  lambda: PagedKVCache(**geo)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert next(BertForPretraining(cfg, device="cpu").parameters()
                ).device.type == "cpu"
    assert PagedKVCache(**geo, device="cpu").k_pools[0].device.type == "cpu"


def test_kernel_library_hash_covers_headers(monkeypatch, tmp_path):
    """The built library is named by a hash of ``csrc/``: a changed header
    (``*.cuh``, included by the sources, never compiled alone) names a new
    library just as a changed source does, so a stale one is never
    reused."""
    from paddle_tpu_torch.ops.kernels import _build

    real = {p.name for p in _build.sources() + _build.headers()}
    assert {"flash_attention_fwd.cu", "flash_attention_bwd.cu",
            "sm90.cuh"} <= real
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    assert [p.name for p in _build.sources()] == ["k.cu"]
    assert [p.name for p in _build.headers()] == ["h.cuh"]
    first = _build.digest()
    assert _build.digest() == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.digest()
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.digest() not in (first, second)

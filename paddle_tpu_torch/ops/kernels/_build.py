"""Build the hand-written CUDA kernels on first use and load them.

Every ``paddle_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into an object, all sources at once (one ``nvcc`` process
each), and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes``. No PyTorch header is included, so a
build takes seconds, not minutes.

The library lands in ``build/paddle_tpu_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags: a changed source or header
builds a new library, an unchanged one is reused. The check and the
build hold an ``fcntl`` lock on ``build_dir()/.build.lock``, so the ranks
of a launched pod that find no library build it once: the first builds,
the others wait and load it. A
failed build raises with ``nvcc``'s stderr; nothing falls back to the
plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_library", "build_dir", "sources", "headers", "digest",
           "last_build", "cuda_tool"]

_PKG = Path(__file__).resolve().parents[2]          # paddle_tpu_torch/
_CSRC = _PKG / "csrc"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last load did: {"path", "built", "seconds", "log"}
last_build: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint64
# C entry points: (name, argtypes). Every pointer and the stream are
# c_void_p (a bare Python int would be cut to 32 bits).
_SIGNATURES = {
    # q, k_pages, v_pages, scales (NULL unless the pools are int8),
    # page_table, seq_lens, out, workspace (NULL with one chunk), batch,
    # nh, nh_kv, head_dim, page_size, max_pages, chunk_pages,
    # rows_per_cta, scale, dtype, stream
    "paged_attention_decode": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
    # as the decode entry, with qlen after batch
    "paged_attention_multiquery": [_P] * 8 + [_I] * 9 + [_F, _I, _P],
    # q, k, v, o, lse, batch, sq, sk, heads, head_dim, q_rs, k_rs, v_rs,
    # scale, causal, dtype, stream
    "flash_attention_fwd_packed": [_P] * 5 + [_I] * 8 + [_F, _I, _I, _P],
    # q, k, v, do, lse, delta, dq, batch, sq, sk, heads, head_dim, q_rs,
    # k_rs, v_rs, do_rs, scale, causal, dtype, stream
    "flash_attention_bwd_dq": [_P] * 7 + [_I] * 9 + [_F, _I, _I, _P],
    # q, k, v, do, lse, delta, dk, dv, then as dq
    "flash_attention_bwd_dkv": [_P] * 8 + [_I] * 9 + [_F, _I, _I, _P],
    # q, k, v, seg_q, seg_k, o, lse, then as the packed entry
    "flash_attention_fwd_packed_seg": [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P],
    # q, k, v, do, lse, delta, seg_q, seg_k, dq, then as the dq entry
    "flash_attention_bwd_dq_seg": [_P] * 9 + [_I] * 9 + [_F, _I, _I, _P],
    # q, k, v, do, lse, delta, seg_q, seg_k, dk, dv, then as dq_seg
    "flash_attention_bwd_dkv_seg": [_P] * 10 + [_I] * 9 + [_F, _I, _I, _P],
    # dropout or a bias: q, k, v, seg_q, seg_k, bias, o, lse, batch, sq,
    # sk, heads, head_dim, q_rs, k_rs, v_rs, the bias's four strides and
    # its route, scale, causal, dropout_p, seed, offset, dtype, stream
    "flash_attention_fwd_ext": ([_P] * 8 + [_I] * 13
                                + [_F, _I, _F, _U, _U, _I, _P]),
    # q, k, v, do, lse, delta, seg_q, seg_k, bias, dq, batch, sq, sk,
    # heads, head_dim, q_rs, k_rs, v_rs, do_rs, the bias's four strides and
    # its route, then as the forward
    "flash_attention_bwd_dq_ext": ([_P] * 10 + [_I] * 14
                                   + [_F, _I, _F, _U, _U, _I, _P]),
    # as dq_ext with dk, dv in place of dq
    "flash_attention_bwd_dkv_ext": ([_P] * 11 + [_I] * 14
                                    + [_F, _I, _F, _U, _U, _I, _P]),
}


def sources():
    return sorted(_CSRC.glob("*.cu"))


def headers():
    """The headers the sources include; they are hashed, not compiled."""
    return sorted(_CSRC.glob("*.cuh"))


def build_dir() -> Path:
    return _PKG.parent / "build" / "paddle_tpu_torch"


def cuda_tool(name: str = "nvcc") -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH, else
    under ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    found = shutil.which(name)
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        f"{name} not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "paddle_tpu_torch kernels are built from source on first use")


def digest() -> str:
    """The library's name tag: a hash of every source and header under
    ``csrc/`` and of the compiler flags."""
    h = hashlib.sha256()
    for s in sources() + headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def _build(srcs, out: Path) -> str:
    nvcc = cuda_tool()
    tmp = out.parent / f".tmp-{os.getpid()}-{out.stem}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for s in srcs:
            obj = tmp / (s.stem + ".o")
            cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(s), "-o", str(obj)]
            procs.append((s, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log, failed = [], []
        for s, obj, p in procs:
            so, se = p.communicate()
            log.append(f"== {s.name} (rc={p.returncode})\n{so}{se}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        lib_tmp = tmp / out.name
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(lib_tmp),
               *[str(obj) for _, obj, _ in procs]]
        p = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"== link (rc={p.returncode})\n{p.stdout}{p.stderr}")
        if p.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        os.replace(lib_tmp, out)   # atomic: a reader never sees half a file
        text = "\n".join(log)
        (out.parent / (out.stem + ".log")).write_text(text)
        return text
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call when no library
    for the current sources exists."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {_CSRC}")
        out = build_dir() / f"libpaddle_tpu_torch_{digest()}.so"
        t0 = time.perf_counter()
        out.parent.mkdir(parents=True, exist_ok=True)
        # across processes: one builds, the others wait here and load
        with open(out.parent / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            built = not out.exists()
            log = _build(srcs, out) if built else ""
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ptt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
        last_build.update(path=str(out), built=built,
                          seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return lib


def dtype_code(dtype) -> int:
    """The C entries' dtype argument: 0 float32, 1 bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def check(rc: int, what: str) -> None:
    """Raise when a C entry returned a non-zero ``cudaError_t``."""
    if rc:
        msg = load_library().ptt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({msg})")

"""Checkpoint save/load with a crash-durable (atomic) on-disk layout (port
of ``paddle_tpu.distributed.checkpoint``), one process.

The layout is the JAX package's, byte for byte in structure, so a
checkpoint written by either package loads in the other:

    path/meta.json            -- names, shapes, dtypes, ``nprocs``
    path/shard-0.pkl          -- a pickled ``{name: [{"index", "data"}]}``,
                                 each piece a numpy array and its index
                                 (one slice triple per dim)
    path/manifest-0.json      -- CRC32 and size of every other file

Every save is a SNAPSHOT phase (device tensors copied to owned host
numpy arrays, inline) followed by a COMMIT phase (pickle, staging into
``<path>.tmp``, fsync, one atomic ``rename(2)``), which never touches
CUDA. :class:`AsyncCheckpointManager` runs the commit on a background
thread:

- at most ONE save is in flight: a second ``save()`` blocks until the
  previous commit lands;
- a background write error is never swallowed: it re-raises at the next
  ``save()`` or ``wait()``;
- rotation and stale-staging sweeps never touch a directory an in-flight
  commit is writing (a module-level registry of active paths);
- a commit touches the launcher heartbeat file (``PADDLE_HEARTBEAT_FILE``)
  between chunks, so a long save never reads as a hung worker.

Durability: a crash mid-save leaves only ``.tmp`` residue, never a torn
``<path>``; an overwrite moves the old copy to ``<path>.old`` for the
swap, and every read path recovers a swap that died between its two
renames; the manifests' CRCs catch torn and bit-flipped files at load;
:class:`CheckpointManager` keeps a rotating ``step-<N>/`` series whose
``latest()`` skips corrupt steps loudly.

The port runs one process, so every checkpoint it writes has
``nprocs`` 1 and one piece per tensor covering all of it; it loads the
JAX package's multi-piece checkpoints all the same. numpy has no
bfloat16, so bf16 tensors are refused (the trainer's state is fp32 and
int). The JAX package's checkpoint metrics (``checkpoint_save_blocked_ms``,
``checkpoint_saves_total``, the in-flight gauge and the save spans) come
with the port's telemetry slice.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import sys
import threading
import time
import zlib

import numpy as np
import torch

__all__ = [
    "save_state_dict",
    "load_state_dict",
    "verify_checkpoint",
    "CheckpointError",
    "CheckpointManager",
    "AsyncCheckpointManager",
]

_STAGING_SUFFIX = ".tmp"

# Staging residue younger than this is left alone by CONSTRUCTION-time
# sweeps: it may be another process's live commit (the in-flight
# registry below is process-local).
_CONSTRUCTION_SWEEP_AGE_S = 60.0

# Directories an in-flight (background) commit is writing or about to
# rename into; rotation and sweeps never delete them. Module-level: a
# sync manager on the same root must respect another manager's save.
_ACTIVE_PATHS: set = set()
_ACTIVE_LOCK = threading.Lock()


def _protect_paths(*paths) -> None:
    with _ACTIVE_LOCK:
        _ACTIVE_PATHS.update(os.path.abspath(p) for p in paths)


def _unprotect_paths(*paths) -> None:
    with _ACTIVE_LOCK:
        _ACTIVE_PATHS.difference_update(os.path.abspath(p) for p in paths)


def _is_protected(path: str) -> bool:
    with _ACTIVE_LOCK:
        return os.path.abspath(path) in _ACTIVE_PATHS


def _touch_heartbeat() -> None:
    """Refresh this worker's launcher heartbeat file, named by
    ``PADDLE_HEARTBEAT_FILE`` (no-op when unset); a failed beat never
    fails the save. ``utime``, not a write: the step payload a launcher
    keeps in it survives."""
    path = os.environ.get("PADDLE_HEARTBEAT_FILE")
    if not path:
        return
    try:
        with open(path, "a"):
            os.utime(path, None)
    except OSError:
        pass


class CheckpointError(ValueError):
    """A checkpoint is absent, torn, or fails integrity verification."""


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-committed rename survives power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


_HEARTBEAT_CHUNK = 32 << 20  # touch the heartbeat every 32MB written


def _mark_dir_live(directory: str) -> None:
    try:
        os.utime(directory, None)
    except OSError:
        pass


def _write_file_durable(directory: str, name: str, data: bytes) -> dict:
    """Write bytes via tempfile + fsync + rename; returns the manifest
    entry ``{crc32, size}``. Large payloads are written in chunks with a
    heartbeat touch (and a staging-dir mtime refresh) in between."""
    _touch_heartbeat()
    _mark_dir_live(directory)
    final = os.path.join(directory, name)
    tmp = final + ".part"
    view = memoryview(data)
    with open(tmp, "wb") as f:
        for off in range(0, max(len(view), 1), _HEARTBEAT_CHUNK):
            f.write(view[off:off + _HEARTBEAT_CHUNK])
            if len(view) > _HEARTBEAT_CHUNK:
                _touch_heartbeat()
                _mark_dir_live(directory)
        f.flush()
        os.fsync(f.fileno())
    _mark_dir_live(directory)
    os.rename(tmp, final)
    return {"crc32": zlib.crc32(data) & 0xFFFFFFFF, "size": len(data)}


def save_state_dict(state_dict: dict, path: str) -> None:
    """Write a state dict (name -> tensor, numpy array or scalar)
    atomically: everything is staged in ``path.tmp`` and committed with
    one directory rename, so a crash at any point leaves either the
    previous checkpoint or a ``.tmp`` residue -- never a torn ``path``."""
    _commit_snapshot(_snapshot_state_dict(state_dict), path)


def _host_array(v, copy: bool) -> np.ndarray:
    """One value as a host numpy array: a CUDA tensor is copied to the
    host (an owned array either way); a CPU tensor or numpy value is
    shared unless ``copy``."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError("checkpoint: numpy has no bfloat16; save the "
                            "fp32 masters")
        t = v.detach()
        if t.device.type != "cpu":
            return t.cpu().numpy()
        arr = t.numpy()
    else:
        arr = np.asarray(v)
    return np.array(arr, copy=True) if copy else arr


def _snapshot_state_dict(state_dict: dict, copy: bool = False) -> dict:
    """Phase 1 of a save: every value to a host numpy array (the only
    part that touches the device). ``copy=True`` (the async path) makes
    each array OWNED, so the caller may overwrite its tensors while the
    background thread is still pickling; a synchronous save pickles
    before returning and skips the extra copy of CPU state."""
    meta, shards = {}, {}
    for name, v in state_dict.items():
        arr = _host_array(v, copy)
        meta[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        # one slice triple per dim, each its own list as the JAX package
        # writes them (so either package pickles the same bytes)
        shards[name] = [{"index": [[None, None, None]
                                   for _ in range(arr.ndim)], "data": arr}]
    return {"proc": 0, "nprocs": 1, "meta": meta, "shards": shards}


def _commit_snapshot(snapshot: dict, path: str) -> int:
    """Phase 2 of a save: serialize + stage + fsync + atomic rename. Pure
    host I/O on an owned snapshot -- safe to run off-thread. Returns the
    shard's bytes."""
    staging = path + _STAGING_SUFFIX
    _protect_paths(staging, path)
    try:
        if os.path.isdir(staging):
            # residue of a previous save that died mid-write
            shutil.rmtree(staging)
        # force: this commit holds path's protection, but a PREVIOUS
        # save's crashed swap (.old present, path gone) must still be
        # recovered here, or its .old would be stranded
        _recover_interrupted_swap(path, force=True)
        os.makedirs(staging, exist_ok=True)
        _mark_dir_live(staging)

        manifest = {}
        shard_name = f"shard-{snapshot['proc']}.pkl"
        manifest[shard_name] = _write_file_durable(
            staging, shard_name, pickle.dumps(snapshot["shards"]))
        nbytes = manifest[shard_name]["size"]
        meta_bytes = json.dumps(
            {"tensors": snapshot["meta"], "nprocs": snapshot["nprocs"]}
        ).encode()
        manifest["meta.json"] = _write_file_durable(staging, "meta.json",
                                                    meta_bytes)
        # the manifest is the last file in: its presence means every
        # file it names was fully written and fsync'd
        _write_file_durable(
            staging, f"manifest-{snapshot['proc']}.json",
            json.dumps({"files": manifest}, indent=1,
                       sort_keys=True).encode())
        _fsync_dir(staging)
        old = path + ".old"
        if os.path.isdir(path):
            # overwrite: move the old copy aside so the commit rename is
            # atomic, then drop it; a crash between the two renames
            # leaves only `.old`, which every read path recovers
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.rename(path, old)
            os.rename(staging, path)
            shutil.rmtree(old)
        else:
            os.rename(staging, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
        return nbytes
    finally:
        _unprotect_paths(staging, path)


def _json_to_index(spec):
    return tuple(slice(a, b, c) for a, b, c in spec)


def _recover_interrupted_swap(path: str, force: bool = False) -> bool:
    """Complete an overwrite-save swap that died between its two renames:
    ``path`` is gone but the previous copy survives at ``path.old``.
    Returns True when a recovery happened. A protected path is a live
    commit of this process mid-swap and is left to finish; ``force`` is
    for that committing thread itself."""
    if not force and _is_protected(path):
        return False
    old = path + ".old"
    if not os.path.isdir(path) and os.path.isdir(old):
        print(f"[checkpoint] recovering {path!r} from {old!r} "
              "(an overwrite-save crashed mid-swap)", file=sys.stderr)
        os.rename(old, path)
        return True
    return False


def verify_checkpoint(path: str) -> tuple[bool, str]:
    """Integrity-check a checkpoint directory without loading tensors.

    Returns ``(ok, reason)``; ``reason`` explains the first failure
    (missing meta, missing file or process manifest, size or CRC
    mismatch). Checkpoints without manifests verify as ok when meta.json
    and at least one shard file exist."""
    _recover_interrupted_swap(path)
    if not os.path.isdir(path):
        return False, f"not a directory: {path}"
    if path.endswith(_STAGING_SUFFIX):
        return False, "uncommitted staging directory (crash mid-save)"
    names = sorted(os.listdir(path))
    if "meta.json" not in names:
        return False, "meta.json missing (torn or foreign directory)"
    manifests = [n for n in names if n.startswith("manifest-")]
    if not manifests:
        if not any(n.startswith("shard-") for n in names):
            return False, "no shard-<proc>.pkl files"
        return True, "ok (no manifest: pre-durability checkpoint)"
    try:
        with open(os.path.join(path, "meta.json")) as f:
            nprocs = int(json.load(f).get("nprocs", 1))
    except (OSError, ValueError) as e:
        return False, f"meta.json unreadable: {e}"
    missing_procs = [p for p in range(nprocs)
                     if f"manifest-{p}.json" not in names]
    if missing_procs:
        return False, (
            f"manifest missing for process(es) {missing_procs} of {nprocs} "
            "(a host's files were lost or never synced to shared storage)")
    for mn in manifests:
        try:
            with open(os.path.join(path, mn)) as f:
                entries = json.load(f)["files"]
        except (OSError, ValueError, KeyError) as e:
            return False, f"{mn} unreadable: {e}"
        for fn, want in entries.items():
            fp = os.path.join(path, fn)
            if not os.path.exists(fp):
                return False, f"{fn} listed in {mn} but missing"
            size = os.path.getsize(fp)
            if size != want["size"]:
                return False, (
                    f"{fn} size mismatch: manifest says {want['size']} "
                    f"bytes, found {size} (truncated write)")
            crc = 0
            with open(fp, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    crc = zlib.crc32(chunk, crc)
            crc &= 0xFFFFFFFF
            if crc != want["crc32"]:
                return False, (
                    f"{fn} CRC32 mismatch: manifest {want['crc32']:#010x} "
                    f"!= on-disk {crc:#010x} (bit rot or torn write)")
    return True, "ok"


def load_state_dict(path: str, device=None, verify: bool = True) -> dict:
    """Reassemble every value: host numpy arrays, or with ``device``
    torch tensors there. Integrity is verified against the CRC manifests
    before any pickle is read; a torn, corrupt or incomplete checkpoint
    raises :class:`CheckpointError` and is never partially loaded.
    ``verify=False`` is for callers that just ran
    :func:`verify_checkpoint` themselves."""
    _recover_interrupted_swap(path)
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        detail = "directory does not exist"
        if os.path.isdir(path):
            detail = ("directory exists but has no meta.json "
                      f"({sorted(os.listdir(path))[:6]})")
        elif os.path.isdir(path + _STAGING_SUFFIX):
            detail = (f"only the uncommitted staging dir "
                      f"{path + _STAGING_SUFFIX!r} exists -- the save that "
                      "wrote it crashed before commit")
        raise CheckpointError(
            f"{path!r} is not a checkpoint: {detail}. Expected the layout "
            "written by save_state_dict (meta.json + shard-<proc>.pkl).")
    if verify:
        ok, reason = verify_checkpoint(path)
        if not ok:
            raise CheckpointError(
                f"checkpoint at {path!r} failed integrity verification: "
                f"{reason}. Refusing to load it (fall back to an older "
                "checkpoint, e.g. via CheckpointManager.latest()).")
    with open(meta_path) as f:
        tensors = json.load(f)["tensors"]
    assembled = {name: np.zeros(info["shape"], dtype=info["dtype"])
                 for name, info in tensors.items()}
    # coverage masks catch a lost piece: every element must be written
    coverage = {name: np.zeros(info["shape"], dtype=bool)
                for name, info in tensors.items()}
    for fn in sorted(os.listdir(path)):
        if not fn.startswith("shard-") or not fn.endswith(".pkl"):
            continue
        with open(os.path.join(path, fn), "rb") as f:
            shards = pickle.load(f)
        for name, pieces in shards.items():
            for piece in pieces:
                idx = _json_to_index(piece["index"])
                assembled[name][idx] = piece["data"]
                coverage[name][idx] = True
    incomplete = [n for n, c in coverage.items() if c.size and not c.all()]
    if incomplete:
        raise CheckpointError(
            f"checkpoint at {path} is missing shard data for: "
            f"{incomplete[:5]} (a shard-<proc>.pkl file was lost or not "
            "synced to shared storage)")
    if device is None:
        return assembled
    return {name: torch.from_numpy(arr).to(device)
            for name, arr in assembled.items()}


class CheckpointManager:
    """A rotating ``step-<N>/`` checkpoint series with torn-write
    recovery: every save is atomic (:func:`save_state_dict`), and
    ``latest()`` verifies before answering, so a crash that tore the
    newest step is survived by resuming from the one before it."""

    def __init__(self, root: str, keep_last_n: int = 3):
        if keep_last_n < 1:
            raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
        self.root = root
        self.keep_last_n = keep_last_n
        os.makedirs(root, exist_ok=True)
        # a worker killed mid-staging leaves `.tmp` residue; sweeping at
        # construction means a resuming process starts from a clean
        # series. Age-gated: fresh residue may be another process's live
        # commit.
        self._sweep_stale_staging(min_age_s=_CONSTRUCTION_SWEEP_AGE_S)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step-{int(step)}")

    def steps(self) -> list:
        """Committed step numbers, ascending (staging residue excluded);
        a step surviving only as ``.old`` is recovered first."""
        for name in os.listdir(self.root):
            if name.endswith(".old"):
                target = os.path.join(self.root, name)[:-len(".old")]
                if _is_protected(target):
                    continue  # a live commit is mid-swap, not crashed
                _recover_interrupted_swap(target)
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("step-") or name.endswith(_STAGING_SUFFIX):
                continue
            suffix = name[len("step-"):]
            if suffix.isdigit() and os.path.isdir(os.path.join(self.root,
                                                               name)):
                out.append(int(suffix))
        return sorted(out)

    def save(self, state_dict: dict, step: int) -> str:
        """Atomically write ``step-<N>/``, then rotate old steps."""
        self._sweep_stale_staging(min_age_s=_CONSTRUCTION_SWEEP_AGE_S)
        path = self.step_dir(step)
        save_state_dict(state_dict, path)
        self._rotate()
        return path

    def _sweep_stale_staging(self, min_age_s: float = 0.0) -> None:
        """Remove crash residue (``.tmp`` staging, completed-``.old``
        swaps) older than ``min_age_s``; never a protected path."""
        now = time.time()
        for name in os.listdir(self.root):
            full = os.path.join(self.root, name)
            if _is_protected(full):
                continue  # an in-flight async commit is writing it
            if min_age_s > 0:
                try:
                    if now - os.path.getmtime(full) < min_age_s:
                        continue  # fresh: presumed a live write
                except OSError:
                    continue  # vanished mid-scan: its owner is live
            if name.endswith(".old"):
                if _is_protected(full[:-len(".old")]):
                    continue
                # the committed dir is gone: the .old copy IS the newest
                # checkpoint -- put it back instead of deleting it
                if _recover_interrupted_swap(full[:-len(".old")]):
                    continue
            if name.endswith(_STAGING_SUFFIX) or name.endswith(".old"):
                print(f"[checkpoint] sweeping stale residue {full!r} "
                      "(a previous save died before commit)",
                      file=sys.stderr)
                shutil.rmtree(full, ignore_errors=True)

    def _rotate(self) -> None:
        for s in self.steps()[:-self.keep_last_n]:
            path = self.step_dir(s)
            if _is_protected(path):
                continue  # never sweep the directory being written
            shutil.rmtree(path, ignore_errors=True)

    def latest(self) -> tuple | None:
        """Newest step that passes integrity verification, as
        ``(step, path)``; corrupt or torn steps are skipped with a loud
        stderr line. ``None`` if nothing is valid."""
        for step in reversed(self.steps()):
            path = self.step_dir(step)
            ok, reason = verify_checkpoint(path)
            if ok:
                return step, path
            print(f"[checkpoint] SKIPPING step-{step} at {path!r}: {reason} "
                  "-- falling back to the previous checkpoint",
                  file=sys.stderr)
        return None

    def load_latest(self, device=None) -> tuple | None:
        """``(step, state_dict)`` from the newest valid checkpoint (numpy
        arrays, or tensors on ``device``), or ``None``."""
        found = self.latest()
        if found is None:
            return None
        step, path = found
        # latest() just CRC-verified this step: don't re-read every shard
        return step, load_state_dict(path, device=device, verify=False)


class AsyncCheckpointManager(CheckpointManager):
    """A :class:`CheckpointManager` whose commits run on a background
    thread -- the training loop pays only the device-to-host snapshot.

    ``save(state, step)`` snapshots inline (the saved values are exactly
    step N's, whatever the optimizer does next) and returns once the
    commit thread has the snapshot. At most one save is in flight: a
    ``save()`` issued while the previous commit is writing blocks until it
    lands. A background write error re-raises, as :class:`CheckpointError`,
    at the next ``save()`` or ``wait()``. ``finalize()`` drains the
    pipeline. The committed bytes are identical to a synchronous save of
    the same state."""

    def __init__(self, root: str, keep_last_n: int = 3):
        super().__init__(root, keep_last_n)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # wall seconds the last background commit spent writing
        # (pickle + fsync + rename, not rotation); read it after wait()
        self.last_commit_s: float | None = None

    def in_flight(self) -> bool:
        """True while a background commit is still writing."""
        return self._thread is not None and self._thread.is_alive()

    def _raise_pending(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise CheckpointError(
                f"a previous async checkpoint commit failed: "
                f"{type(err).__name__}: {err}") from err

    def wait(self) -> None:
        """Block until the in-flight commit (if any) lands; re-raise any
        background write error."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        self._raise_pending()

    def finalize(self) -> None:
        """Drain the pipeline: the last checkpoint is durable when this
        returns."""
        self.wait()

    def save(self, state_dict: dict, step: int) -> str:
        """Snapshot inline, commit in the background. Returns the final
        path (which exists only once the commit lands)."""
        self.wait()  # at most one in flight; re-raises a previous error
        self._sweep_stale_staging(min_age_s=_CONSTRUCTION_SWEEP_AGE_S)
        path = self.step_dir(step)
        snapshot = _snapshot_state_dict(state_dict, copy=True)
        staging = path + _STAGING_SUFFIX
        # protect BEFORE the thread starts: a sync manager's sweep between
        # thread start and the commit's own protect would race
        _protect_paths(staging, path)
        try:
            self._thread = threading.Thread(
                target=self._commit_in_background,
                args=(snapshot, path, int(step)),
                name=f"ckpt-commit-step-{int(step)}", daemon=True)
            self._thread.start()
        except BaseException:
            self._thread = None
            _unprotect_paths(staging, path)
            raise
        return path

    def _commit_in_background(self, snapshot, path, step) -> None:
        try:
            try:
                t_commit = time.perf_counter()
                _commit_snapshot(snapshot, path)
                self.last_commit_s = time.perf_counter() - t_commit
            finally:
                _unprotect_paths(path + _STAGING_SUFFIX, path)
        except Exception as e:  # re-raised at the next save()/wait()
            self._error = e
            return
        try:
            # past this point the checkpoint IS durable: a rotation
            # hiccup must not be reported as a failed commit
            self._rotate()
        except OSError as e:
            print(f"[checkpoint] WARNING: rotation after step-{step} "
                  f"failed ({type(e).__name__}: {e}); the checkpoint "
                  "itself is committed and valid", file=sys.stderr)

"""The port's durable checkpoint layer (``paddle_tpu_torch.distributed.
checkpoint``) and the trainer's checkpoints, on the CPU: the atomic
layout and its manifest, overwrite and stale-staging handling, every
kind of damage detected and never loaded (bit flip, truncation, lost
meta, lost piece, lost process manifest), rotation, the corrupt-skip of
``latest()`` and the recovery of an interrupted overwrite swap -- the
port's counterparts of ``tests/test_checkpoint_fault.py``. Across the
packages: the same state saved by either writes the same files, each
loads the other's, a JAX trainer's checkpoint resumes in the port
trainer (step-3 loss within 1e-5 of the JAX trainer's), and the port
trainer's passes the JAX package's ``verify_checkpoint`` and loads
through its ``load_state_dict``. The damage is done by the JAX
package's ``corrupt_checkpoint``, which works on the files alone."""
import json
import os
import pickle
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.models import gpt as JM
from paddle_tpu.parallel import hybrid as jhybrid
from paddle_tpu.utils.fault_injection import corrupt_checkpoint
from paddle_tpu_torch.distributed.checkpoint import (CheckpointError,
                                                     CheckpointManager,
                                                     load_state_dict,
                                                     save_state_dict,
                                                     verify_checkpoint)
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.utils.convert import from_gpt_params
from paddle_tpu_torch.utils.tree import flatten


def _state(seed=0, n=64):
    rng = np.random.RandomState(seed)
    return {"w": rng.rand(8, n // 8).astype(np.float32),
            "b": rng.rand(n // 8).astype(np.float32)}


def _assert_roundtrip(state, loaded):
    assert set(loaded) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(loaded[k]), v)


def _rewrite_manifest_entry(path, name):
    """Make ``manifest-0.json`` honest about a rewritten file, so only a
    later check can catch what was done to it."""
    data = open(os.path.join(path, name), "rb").read()
    man_fp = os.path.join(path, "manifest-0.json")
    man = json.load(open(man_fp))
    man["files"][name] = {"crc32": zlib.crc32(data) & 0xFFFFFFFF,
                          "size": len(data)}
    with open(man_fp, "w") as f:
        json.dump(man, f)


# -- atomic save layout ------------------------------------------------------

def test_atomic_save_layout_and_manifest(tmp_path):
    path = str(tmp_path / "ckpt")
    state = _state()
    save_state_dict(state, path)
    assert sorted(os.listdir(path)) == ["manifest-0.json", "meta.json",
                                        "shard-0.pkl"]
    assert not os.path.exists(path + ".tmp")
    man = json.load(open(os.path.join(path, "manifest-0.json")))["files"]
    assert set(man) == {"meta.json", "shard-0.pkl"}
    for fn, entry in man.items():
        assert entry["size"] == os.path.getsize(os.path.join(path, fn))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta == {"tensors": {"w": {"shape": [8, 8], "dtype": "float32"},
                                "b": {"shape": [8], "dtype": "float32"}},
                    "nprocs": 1}
    _assert_roundtrip(state, load_state_dict(path))


@pytest.mark.parametrize("crashed_swap", [False, True])
def test_save_overwrites_existing_checkpoint(tmp_path, crashed_swap):
    """An overwrite leaves no ``.old``; one whose previous save crashed
    between its two renames (only ``path.old`` left) recovers that copy
    first and still lands the new state."""
    path = str(tmp_path / "ckpt")
    save_state_dict(_state(seed=1), path)
    if crashed_swap:
        os.rename(path, path + ".old")
    newer = _state(seed=2)
    save_state_dict(newer, path)
    assert not os.path.exists(path + ".old")
    _assert_roundtrip(newer, load_state_dict(path))


def test_stale_staging_dir_is_replaced_not_loaded(tmp_path):
    path = str(tmp_path / "ckpt")
    os.makedirs(path + ".tmp")
    (tmp_path / "ckpt.tmp" / "shard-0.pkl").write_bytes(b"torn")
    with pytest.raises(CheckpointError, match="crashed before commit"):
        load_state_dict(path)
    state = _state()
    save_state_dict(state, path)
    assert not os.path.exists(path + ".tmp")
    _assert_roundtrip(state, load_state_dict(path))


def test_tensors_save_and_load_onto_a_device(tmp_path):
    path = str(tmp_path / "ckpt")
    state = {"w": torch.arange(12.0).reshape(3, 4), "step":
             torch.tensor(7, dtype=torch.int32), "n": np.int64(5)}
    save_state_dict(state, path)
    got = load_state_dict(path, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    assert torch.equal(got["w"], state["w"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    assert got["n"].dtype == torch.int64 and int(got["n"]) == 5
    with pytest.raises(TypeError, match="bfloat16"):
        save_state_dict({"h": torch.zeros(2, dtype=torch.bfloat16)}, path)


# -- corruption matrix -------------------------------------------------------

def _drop_piece(path):
    shard_fp = os.path.join(path, "shard-0.pkl")
    shards = pickle.load(open(shard_fp, "rb"))
    shards["w"] = []
    with open(shard_fp, "wb") as f:
        f.write(pickle.dumps(shards))
    _rewrite_manifest_entry(path, "shard-0.pkl")


def _lose_process_manifest(path):
    meta_fp = os.path.join(path, "meta.json")
    meta = json.load(open(meta_fp))
    meta["nprocs"] = 2
    with open(meta_fp, "w") as f:
        json.dump(meta, f)
    _rewrite_manifest_entry(path, "meta.json")


# damage -> (what verify_checkpoint says, or None where it passes and the
# loader's coverage check must catch it)
DAMAGE = {
    "flip": (lambda p: corrupt_checkpoint(p, mode="flip"), "CRC32 mismatch"),
    "truncate": (lambda p: corrupt_checkpoint(p, mode="truncate"),
                 "size mismatch"),
    "drop_meta": (lambda p: corrupt_checkpoint(p, mode="drop_meta"),
                  "meta.json missing"),
    "lost_piece": (_drop_piece, None),
    "lost_process_manifest": (_lose_process_manifest,
                              "manifest missing for process"),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_damage_is_detected_and_never_loaded(tmp_path, damage):
    path = str(tmp_path / "ckpt")
    save_state_dict(_state(), path)
    harm, reason = DAMAGE[damage]
    harm(path)
    ok, why = verify_checkpoint(path)
    if reason is None:
        assert ok, why
        with pytest.raises(CheckpointError, match="missing shard data"):
            load_state_dict(path)
        return
    assert not ok and reason in why
    with pytest.raises(CheckpointError):
        load_state_dict(path)


def test_missing_checkpoint_is_a_clear_error(tmp_path):
    with pytest.raises(CheckpointError, match="not a checkpoint"):
        load_state_dict(str(tmp_path / "never_saved"))


def test_pre_manifest_checkpoint_still_loads(tmp_path):
    path = str(tmp_path / "old")
    state = _state()
    save_state_dict(state, path)
    os.remove(os.path.join(path, "manifest-0.json"))
    ok, reason = verify_checkpoint(path)
    assert ok and "pre-durability" in reason
    _assert_roundtrip(state, load_state_dict(path))


# -- CheckpointManager: rotation, latest() fallback, sweeps, recovery --------

def test_manager_rotation_keeps_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    for step in (1, 2, 3, 4):
        mgr.save(_state(seed=step), step)
    assert mgr.steps() == [3, 4]
    step, path = mgr.latest()
    assert step == 4 and path.endswith("step-4")
    with pytest.raises(ValueError, match="keep_last_n"):
        CheckpointManager(str(tmp_path), keep_last_n=0)


def test_manager_latest_skips_corrupt_loudly(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=3)
    for step in (1, 2, 3):
        mgr.save(_state(seed=step), step)
    corrupt_checkpoint(mgr.step_dir(3), mode="flip")
    corrupt_checkpoint(mgr.step_dir(2), mode="truncate")
    assert mgr.latest()[0] == 1
    err = capsys.readouterr().err
    assert "SKIPPING step-3" in err and "CRC32 mismatch" in err
    assert "SKIPPING step-2" in err and "size mismatch" in err
    got_step, state = mgr.load_latest()
    assert got_step == 1
    _assert_roundtrip(_state(seed=1), state)
    corrupt_checkpoint(mgr.step_dir(1), mode="drop_meta")
    assert mgr.latest() is None and mgr.load_latest() is None


@pytest.mark.parametrize("when", ["save", "construction"])
def test_manager_sweeps_stale_staging(tmp_path, capsys, when):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    mgr.save(_state(seed=1), 1)
    stale = str(tmp_path / "step-9.tmp")
    os.makedirs(stale)
    fresh = str(tmp_path / "step-8.tmp")
    os.makedirs(fresh)
    old = time.time() - 3600     # past the liveness gate; `fresh` is not
    os.utime(stale, (old, old))
    if when == "save":
        mgr.save(_state(), 10)
    else:
        mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    assert not os.path.exists(stale) and os.path.exists(fresh)
    assert "sweeping stale residue" in capsys.readouterr().err
    assert mgr.steps() == ([1, 10] if when == "save" else [1])


@pytest.mark.parametrize("reader", ["load", "latest", "construction"])
def test_interrupted_overwrite_swap_recovers_old_copy(tmp_path, capsys,
                                                     reader):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=3)
    mgr.save(_state(seed=1), 1)
    mgr.save(_state(seed=2), 2)
    path = mgr.step_dir(2)
    os.rename(path, path + ".old")  # died between the two renames
    old = time.time() - 3600
    os.utime(path + ".old", (old, old))
    if reader == "load":
        _assert_roundtrip(_state(seed=2), load_state_dict(path))
    elif reader == "latest":
        assert mgr.latest()[0] == 2
    else:
        CheckpointManager(str(tmp_path))
    assert os.path.isdir(path) and not os.path.exists(path + ".old")
    assert "recovering" in capsys.readouterr().err
    _assert_roundtrip(_state(seed=2), mgr.load_latest()[1])


# -- across the packages -----------------------------------------------------

def test_either_package_writes_the_same_files(tmp_path):
    state = {"w": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
             "s": np.asarray(np.float32(2.0 ** 15)),
             "i": np.asarray(np.int32(-3)),
             "c": np.frombuffer(b'{"cursor": 3}', dtype=np.uint8)}
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_state_dict(state, jpath)
    save_state_dict(state, tpath)
    for name in ("meta.json", "manifest-0.json", "shard-0.pkl"):
        assert (open(os.path.join(jpath, name), "rb").read()
                == open(os.path.join(tpath, name), "rb").read()), name
    _assert_roundtrip(state, load_state_dict(jpath))
    assert jckpt.verify_checkpoint(tpath) == (True, "ok")
    _assert_roundtrip(state, jckpt.load_state_dict(tpath))


def test_port_loads_a_sharded_jax_checkpoint(tmp_path):
    """The JAX package writes a tensor sharded over a mesh as several
    pieces with their indices; the port reassembles them."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paddle_tpu.distributed.mesh import build_mesh

    mesh = build_mesh(dp=2, mp=2, devices=jax.devices("cpu")[:4])
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    path = str(tmp_path / "c")
    jckpt.save_state_dict({"w": jax.device_put(
        w, NamedSharding(mesh, P("data", "model")))}, path)
    assert len(pickle.load(open(os.path.join(path, "shard-0.pkl"),
                                "rb"))["w"]) == 4
    np.testing.assert_array_equal(load_state_dict(path)["w"], w)


B, S = 2, 32
EPS = 1e-5      # Adam's eps, as tests/test_torch_trainer.py sets it


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (B, S)).astype(np.int32),
            rng.randint(0, 1024, (B, S)).astype(np.int32))


def _jax_trainer():
    return jhybrid.HybridParallelTrainer(
        JM.gpt_tiny(), jhybrid.TrainerConfig(
            telemetry=False, compile_ledger=False, compute_dtype=jnp.float32,
            learning_rate=1e-3, warmup_steps=2, eps=EPS, loss_scaling=True),
        devices=jax.devices()[:1])


def _port_trainer(**kw):
    return thybrid.HybridParallelTrainer(
        TM.gpt_tiny(), thybrid.TrainerConfig(
            compute_dtype=torch.float32, learning_rate=1e-3, warmup_steps=2,
            eps=EPS, loss_scaling=True, **kw), device="cpu")


def test_jax_trainer_checkpoint_resumes_in_the_port(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.setenv("PADDLE_FI_NAN_AT_STEP", "1")
    jt = _jax_trainer()
    for seed in (0, 1):
        jt.step(*_batch(seed))
    jt.save_checkpoint(str(tmp_path), step=2)
    want = float(jt.step(*_batch(2)))
    tt = _port_trainer()
    assert tt.load_checkpoint(str(tmp_path)) == 2
    assert "ignoring rng/key" in capsys.readouterr().err
    assert tt.global_step == 2
    assert tt.anomaly == {"skips_total": 1, "consecutive": 0,
                          "last_skipped": False, "loss_scale": 2.0 ** 14}
    assert int(tt.opt["step"]) == 1          # the NaN step committed nothing
    got = float(tt.step(*_batch(2)))
    assert abs(got - want) <= 1e-5, (got, want)


def test_port_trainer_checkpoint_verifies_and_loads_in_jax(tmp_path):
    tt = _port_trainer()
    for seed in (0, 1):
        tt.step(*_batch(seed))
    path = tt.save_checkpoint(str(tmp_path), step=2)
    assert jckpt.verify_checkpoint(path) == (True, "ok")
    got = jckpt.load_state_dict(path)
    want = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tt._flat_state().items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the JAX trainer resumes it: same keys, tree and step
    jt = _jax_trainer()
    assert jt.load_checkpoint(str(tmp_path)) == 2
    assert jt.global_step == 2
    for path_, leaf in flatten(tt.params):
        node = jt.params
        for k in path_:
            node = node[k]
        np.testing.assert_array_equal(np.asarray(node), leaf.numpy())


class _Loader:
    def __init__(self):
        self.cursor = 0

    def state_dict(self):
        return {"cursor": self.cursor, "epoch": 1}

    def load_state_dict(self, sd):
        self.cursor = sd["cursor"]


def test_trainer_round_trip_fallback_and_mismatch(tmp_path, capsys):
    tt = _port_trainer()
    loader = _Loader()
    for seed in (0, 1):
        tt.step(*_batch(seed))
        loader.cursor += 1
        tt.save_checkpoint(str(tmp_path), step=tt.global_step,
                           dataloader=loader)
    want = {k: np.asarray(v) for k, v in tt._flat_state(loader).items()}
    assert json.loads(bytes(want["data/cursor_json"])) == {"cursor": 2,
                                                           "epoch": 1}
    fresh, fresh_loader = _port_trainer(), _Loader()
    assert fresh.load_checkpoint(str(tmp_path), fresh_loader) == 2
    assert fresh_loader.cursor == 2
    got = fresh._flat_state(fresh_loader)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    corrupt_checkpoint(os.path.join(str(tmp_path), "step-2"), mode="flip")
    assert _port_trainer().load_checkpoint(str(tmp_path)) == 1
    assert _port_trainer().load_checkpoint(str(tmp_path / "empty")) is None
    other = thybrid.HybridParallelTrainer(
        TM.GPTConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                     num_heads=2, max_position_embeddings=256),
        thybrid.TrainerConfig(compute_dtype=torch.float32), device="cpu")
    with pytest.raises(CheckpointError, match="shape"):
        other.load_checkpoint(str(tmp_path))


def test_missing_extras_warn_and_take_fresh_defaults(tmp_path, capsys):
    tt = _port_trainer()
    tt.step(*_batch(0))
    state = {k: v for k, v in tt._flat_state().items()
             if not k.startswith(("guard/", "meta/"))}
    CheckpointManager(str(tmp_path)).save(state, 5)
    fresh = _port_trainer()
    assert fresh.load_checkpoint(str(tmp_path), dataloader=_Loader()) == 5
    err = capsys.readouterr().err
    for what in ("anomaly-guard/loss-scale state", "global step",
                 "data-iterator cursor"):
        assert what in err
    assert fresh.global_step == 5
    assert float(fresh.guard["loss_scale"]) == 2.0 ** 15
    missing = {k: v for k, v in state.items() if k != "['params']['wte']"}
    CheckpointManager(str(tmp_path)).save(missing, 6)
    with pytest.raises(CheckpointError, match="missing keys"):
        fresh.load_checkpoint(str(tmp_path))


def test_from_gpt_params_and_checkpoint_keys_agree():
    """The trainer's checkpoint keys are ``jax.tree_util.keystr`` of the
    JAX trainer's state tree, leaf for leaf."""
    jt = _jax_trainer()
    tt = _port_trainer()
    tt.params = from_gpt_params(jax.device_get(jt.params), TM.gpt_tiny())
    jkeys = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(
                 {"params": jt.params, "opt": jt.opt})[0]]
    tkeys = [k for k in tt._flat_state() if k.startswith("[")]
    assert sorted(jkeys) == sorted(tkeys)
    assert {k for k in tt._flat_state() if not k.startswith("[")} == {
        "guard/loss_scale", "guard/good_steps", "guard/skip_count",
        "guard/skips_total", "meta/global_step"}

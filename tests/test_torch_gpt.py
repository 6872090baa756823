"""The port's GPT against the JAX package's: weights carried across by
``from_paddle_tpu_state`` (every leaf accounted for), and the full
no-cache forward's logits on the same weights and tokens."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as JM
from paddle_tpu_torch.models import gpt as TM
from paddle_tpu_torch.utils.convert import (expected_leaves,
                                            from_paddle_tpu_state)

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's idle OpenMP team would spin against theirs
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_tiny():
    paddle.seed(0)
    m = JM.GPTForCausalLM(JM.gpt_tiny(hidden_dropout=0.0,
                                      attention_dropout=0.0))
    m.eval()
    state = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    return m, state


def _port(state):
    cfg = TM.gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    m = TM.GPTForCausalLM(cfg, device="cpu").eval()
    m.load_state_dict(from_paddle_tpu_state(state, cfg), strict=True)
    return m


def test_from_paddle_tpu_state_round_trips_every_leaf(jax_tiny):
    _, state = jax_tiny
    port = _port(state)
    got = port.state_dict()
    assert set(got) == set(state) == set(expected_leaves(port.cfg))
    for name, arr in state.items():
        want = arr.T if name.endswith(".weight") and (
            "proj" in name or "fc_" in name) else arr
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    # an unknown or a missing leaf raises, never loads half a model
    with pytest.raises(KeyError, match="unknown"):
        from_paddle_tpu_state({**state, "gpt.extra.weight": arr}, port.cfg)
    short = dict(state)
    short.pop("gpt.h.1.mlp.fc_out.bias")
    with pytest.raises(KeyError, match="missing"):
        from_paddle_tpu_state(short, port.cfg)


def test_full_forward_logits_match_jax(jax_tiny):
    torch.backends.cuda.matmul.allow_tf32 = False
    jm, state = jax_tiny
    port = _port(state)
    ids = np.random.RandomState(0).randint(0, 1024, (2, 24)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64))).numpy()
    assert got.shape == want.shape == (2, 24, 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

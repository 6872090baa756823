"""Pipeline parallelism over the mesh's ``"pipe"`` axis (port of
``paddle_tpu.parallel.pipeline``): GPipe, 1F1B and interleaved 1F1B.

The JAX package runs the whole pipeline as one SPMD program: a buffer
sharded over ``"pipe"`` rolls one stage a tick (a collective permute)
through a ``lax.scan``. Here every rank is one process of the
``torch.distributed`` world and runs its own stage's part of the
schedule; stages hand activations forward and cotangents backward by
point-to-point sends and receives in the ``"pipe"`` group (:class:`_Link`,
over ``communication.batch_isend_irecv``, host-staged where the mesh
says so). Inside a stage tensor parallelism, ZeRO 1-3, data parallelism
and the sequence ring compose as they do at pp == 1: the stage runs the
model family's own blocks (``transformer_core.gpt_block``,
``llama_core.llama_block``) over this rank's shards.

- **The stage split.** Stage s holds layers ``[s*L/pp, (s+1)*L/pp)``:
  exactly its ``"pipe"`` shard of the stacked blocks under the family's
  param specs, so no weight moves. Stage 0 embeds; the last stage runs
  the head and the loss. The leaves the specs leave off ``"pipe"``
  (GPT's ``wte``, ``wpe``, ``lnf_g``, ``lnf_b``; LLaMA's ``wte``,
  ``lnf_g``, ``lm_w``) are held by every stage and get grads only on
  stage 0 and the last: the trainer sums them over ``"pipe"``. GPT's
  tied ``wte`` takes the embedding's grad plus the head's
  (:class:`PipelineArch` ``merge_grads``, as in the JAX package).
- **GPipe** (:func:`pipeline_gpipe_grads`, ``pp_schedule="gpipe"``):
  every microbatch's forward, then every backward; autograd holds each
  microbatch's graph (under the per-layer ``remat`` policy, as the JAX
  stage does), so M microbatches are in flight on every stage: the
  O(M) memory law.
- **1F1B** (:func:`pipeline_1f1b_grads`): Megatron's per-rank loop,
  which the JAX lockstep scan encodes: ``pp - 1 - s`` warm-up forwards,
  then one forward and one backward in turn, then the cool-down
  backwards; at most ``pp - s`` microbatches are in flight on stage s,
  whatever M. With ``remat`` off (False, None, ``"none"``) a forward
  keeps its stage's autograd graph and nothing is recomputed; under any
  other policy the forward runs under ``torch.no_grad()`` and keeps only
  the stage's input, and the backward recomputes the stage forward once
  with autograd, then backpropagates (the JAX package's split between
  stashing the vjp's residuals and stashing the input). The recompute
  does not nest the per-layer checkpoint of ``_remat_wrap`` (the JAX
  stage does): nested, the stage forward would run three times, for the
  same grads.
- **Interleaved 1F1B** (:func:`pipeline_interleaved_grads`, ``vpp > 1``):
  logical chunk ``c = r*pp + s`` holds layers ``[c*Lc, (c+1)*Lc)``;
  stage s runs chunks s, pp+s, ... and the last stage's chunk r hands to
  stage 0's chunk r+1, so the ``"pipe"`` ring wraps around. Each rank
  runs the JAX package's lockstep ticks (one chunk forward and one chunk
  backward a tick where the schedule has them) and exchanges with its
  neighbours once a tick. The params stay stored in the contiguous
  ``P("pipe", ...)`` layout (the JAX trainer's, so shards, memory plans
  and checkpoints are the same); the chunk weights move in, and their
  grads back, by one exchange over ``"pipe"`` each step.

The loss is the sum of the microbatch losses times ``1 / M`` (each the
global mean over its rows, every batch rank's tokens), computed on the
last stage and broadcast over ``"pipe"``, so every rank returns the
global loss. The JAX package's ``_EmbedPlan`` falls back to embedding
the whole batch at once where its vocab-parallel ``shard_map`` cannot
take a microbatch's rows; the port streams the embedding per
microbatch whatever the layout, which gives the same grads. The
fleet's ``PipelineLayer`` bridge (``arch_from_stack``,
``read_stack_params``, ``write_stack_grads``) is not ported.

Every function takes this rank's shards (``params``, its local
``tokens`` and ``labels``) and the :class:`~paddle_tpu_torch.distributed.
mesh.Mesh`. :data:`COUNTERS` holds, since :func:`reset_counters`, the
most microbatches a schedule held at once on this rank
(``in_flight_max``) and the bytes of chunk weights and grads this rank
sent in the interleaved exchanges (``chunk_bytes_sent``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..distributed import communication as comm
from ..models.llama import LlamaConfig
from ..utils.tree import tree_map
from . import llama_core
from . import transformer_core as core

__all__ = ["PipelineArch", "gpt_arch", "llama_arch", "arch_for",
           "pipeline_hidden", "pipeline_forward", "pipeline_loss",
           "pipeline_gpipe_grads", "pipeline_1f1b_grads",
           "pipeline_interleaved_grads", "COUNTERS", "reset_counters"]

# this rank's microbatches in flight (forwarded, not yet backwarded) now
# and at most, and the bytes its interleaved chunk exchanges sent
COUNTERS = {"in_flight": 0, "in_flight_max": 0, "chunk_bytes_sent": 0}


def reset_counters() -> None:
    COUNTERS.update(dict.fromkeys(COUNTERS, 0))


# -- arch adapters: what the schedules need to know of a model family ---------

@dataclasses.dataclass(frozen=True)
class PipelineArch:
    """A model family for the schedules: embed -> N homogeneous blocks ->
    head with the loss, over this rank's shards (the mesh, ring and
    ZeRO-3 specs are bound in)."""

    n_layers: int
    # (emb_params, tokens (mb, S)) -> activations (mb, S, H)
    embed: Callable[..., Any]
    # (one layer's leaves, x) -> x
    block: Callable[..., Any]
    # (head_params, y (mb, S, H), labels (mb, S)) -> the global mean loss
    head_loss: Callable[..., Any]
    # params -> (emb_params, blocks (leading dim = layer), head_params)
    split: Callable[..., Any]
    # (g_emb, g_blocks, g_head) -> grads like params
    merge_grads: Callable[..., Any]


def gpt_arch(cfg, compute_dtype=torch.bfloat16, mesh=None, ring=None,
             specs=None) -> PipelineArch:
    """GPT: ``gpt_embed``, ``gpt_block`` and the tied head. The head's
    loss is the core's ``chunked_xent`` (the final norm, then the same
    mean cross entropy as ``gpt_logits`` + ``softmax_xent`` in chunks,
    vocab-parallel where the embedding is, averaged over the loss
    axes)."""
    bspecs = specs and specs["blocks"]

    def embed(ep, tokens):
        return core.gpt_embed(cfg, ep, tokens, compute_dtype, mesh=mesh,
                              ring=ring, specs=specs)

    def block(lp, x):
        return core.gpt_block(cfg, core._gather_layer(lp, bspecs, mesh), x,
                              compute_dtype, ring=ring, mesh=mesh)

    def head_loss(hp, y, labels):
        return core.chunked_xent(cfg, hp, y, labels, compute_dtype,
                                 mesh=mesh, specs=specs)

    def split(params):
        emb = {"wte": params["wte"], "wpe": params["wpe"]}
        head = {"lnf_g": params["lnf_g"], "lnf_b": params["lnf_b"],
                "wte": params["wte"]}
        return emb, params["blocks"], head

    def merge_grads(g_emb, g_blocks, g_head):
        return {
            "wte": g_emb["wte"] + g_head["wte"],   # tied embedding/head
            "wpe": g_emb["wpe"],
            "blocks": g_blocks,
            "lnf_g": g_head["lnf_g"],
            "lnf_b": g_head["lnf_b"],
        }

    return PipelineArch(cfg.num_layers, embed, block, head_loss, split,
                        merge_grads)


def llama_arch(cfg, compute_dtype=torch.bfloat16, mesh=None, ring=None,
               specs=None) -> PipelineArch:
    """LLaMA: the token embedding, ``llama_block`` with the RoPE tables at
    this rank's (zigzag) positions, the fp32 RMS final norm and
    ``chunked_xent_on`` through the untied ``lm_w``."""
    bspecs = specs and specs["blocks"]
    tables = {}

    def embed(ep, tokens):
        wte = core._zgather(ep["wte"], specs and specs["wte"], mesh)
        return core.embed_lookup(cfg, wte, tokens, mesh, compute_dtype)

    def block(lp, x):
        key = (x.shape[-2], x.device)
        if key not in tables:
            tables[key] = llama_core._local_tables(cfg, x.shape[-2], ring,
                                                   x.device)
        cos, sin = tables[key]
        return llama_core.llama_block(
            cfg, core._gather_layer(lp, bspecs, mesh), x, cos, sin,
            compute_dtype, ring=ring, mesh=mesh)

    def head_loss(hp, y, labels):
        h = llama_core._rms(y.float(), hp["lnf_g"], cfg.rms_norm_epsilon)
        lm_w = core._zgather(hp["lm_w"], specs and specs["lm_w"], mesh)
        return core.chunked_xent_on(h, lm_w, labels, compute_dtype,
                                    mesh=mesh,
                                    vocab_parallel=core._use_vp_embed(cfg,
                                                                      mesh))

    def split(params):
        emb = {"wte": params["wte"]}
        head = {"lnf_g": params["lnf_g"], "lm_w": params["lm_w"]}
        return emb, params["blocks"], head

    def merge_grads(g_emb, g_blocks, g_head):
        return {"wte": g_emb["wte"], "blocks": g_blocks,
                "lnf_g": g_head["lnf_g"], "lm_w": g_head["lm_w"]}

    return PipelineArch(cfg.num_layers, embed, block, head_loss, split,
                        merge_grads)


def arch_for(model_cfg, compute_dtype=torch.bfloat16, mesh=None, ring=None,
             specs=None) -> PipelineArch:
    """The pipeline adapter of a model config's family."""
    fn = llama_arch if isinstance(model_cfg, LlamaConfig) else gpt_arch
    return fn(model_cfg, compute_dtype, mesh, ring, specs)


# -- shared scaffolding -------------------------------------------------------

def _shape_check(B, M, n_layers, unit, label):
    if B % M:
        raise ValueError(f"batch {B} not divisible by micro_batches {M}")
    if n_layers % unit:
        raise ValueError(f"num_layers {n_layers} not divisible by {label}")


def _microbatches(tokens, labels, M, mesh, n_layers, unit, label):
    """The JAX package's shape checks on the GLOBAL batch, then this
    rank's rows cut into M microbatches."""
    B = tokens.shape[0]
    _shape_check(B * mesh.size(core.BATCH), M, n_layers, unit, label)
    if B % M:
        raise ValueError(
            f"this rank's batch {B} (of {B * mesh.size(core.BATCH)} over "
            f"{mesh.size(core.BATCH)} batch ranks) not divisible by "
            f"micro_batches {M}")
    mb = B // M
    return tokens.split(mb), labels.split(mb)


def _leaves(tree):
    """Fresh autograd leaves over ``tree``'s tensors (their grads
    accumulate across microbatches)."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _grads(tree):
    return tree_map(lambda t: t.grad if t.grad is not None
                    else torch.zeros_like(t), tree)


class _Link:
    """This rank's point-to-point ops with its neighbours in the
    ``"pipe"`` group: activations go to the next stage (tag 0),
    cotangents to the previous one (tag 1). ``wrap`` closes the ring
    (stage pp-1's next is stage 0), as the interleaved schedule needs.
    Every send travels with the receives of the same moment in one
    ``batch_isend_irecv``: in 1F1B's steady state neighbours send to
    each other at once, which two blocking calls would deadlock."""

    def __init__(self, mesh, shape, dtype, wrap=False):
        pp, s = mesh.shape["pipe"], mesh.coords["pipe"]
        self.group = mesh.group("pipe")
        self.staged = mesh.host_staged
        self.shape, self.dtype, self.device = shape, dtype, mesh.device
        has_next, has_prev = wrap or s < pp - 1, wrap or s > 0
        self.next = mesh.rank_at(pipe=(s + 1) % pp) if has_next else None
        self.prev = mesh.rank_at(pipe=(s - 1) % pp) if has_prev else None

    def exchange(self, fwd=None, bwd=None, recv_fwd=False, recv_bwd=False):
        """Send ``fwd`` to the next stage and ``bwd`` to the previous one
        (each where given), receive an activation from the previous stage
        and a cotangent from the next (where asked): ``(x, dy)``."""
        ops, x, dy = [], None, None
        if fwd is not None:
            ops.append(comm.P2POp("send", fwd.detach().contiguous(),
                                  self.next, self.group, tag=0))
        if bwd is not None:
            ops.append(comm.P2POp("send", bwd.detach().contiguous(),
                                  self.prev, self.group, tag=1))
        if recv_fwd:
            x = torch.empty(self.shape, dtype=self.dtype, device=self.device)
            ops.append(comm.P2POp("recv", x, self.prev, self.group, tag=0))
        if recv_bwd:
            dy = torch.empty(self.shape, dtype=self.dtype,
                             device=self.device)
            ops.append(comm.P2POp("recv", dy, self.next, self.group, tag=1))
        if ops:
            comm.batch_isend_irecv(ops, host_staged=self.staged)
        return x, dy

    def send_forward(self, y):
        self.exchange(fwd=y)

    def recv_forward(self):
        return self.exchange(recv_fwd=True)[0]

    def send_backward(self, dx):
        self.exchange(bwd=dx)

    def recv_backward(self):
        return self.exchange(recv_bwd=True)[1]

    def send_forward_recv_backward(self, y):
        return self.exchange(fwd=y, recv_bwd=True)[1]

    def send_backward_recv_forward(self, dx):
        return self.exchange(bwd=dx, recv_fwd=True)[0]


class _Stage:
    """This rank's stage of a schedule: its params as autograd leaves
    (``rounds[r]``: the blocks of its r-th chunk), its microbatches, the
    stash of microbatches in flight and the loss.

    ``keep_graph``: a forward keeps its autograd graph for the backward
    (GPipe; 1F1B without remat), else it runs without one and the
    backward recomputes it from the stashed input. ``layer_remat`` is
    the per-layer policy inside a kept graph (GPipe)."""

    def __init__(self, arch, params, rounds, toks, labs, keep_graph,
                 layer_remat=False):
        emb, _, head = arch.split(params)
        self.arch = arch
        self.emb, self.head = _leaves(emb), _leaves(head)
        self.rounds = [_leaves(b) for b in rounds]
        self.toks, self.labs = toks, labs
        self.M = len(toks)
        self.keep_graph = keep_graph
        self.layer_remat = layer_remat if keep_graph else False
        self.stash = {}
        self.loss = None

    def _run(self, r, x):
        blocks = self.rounds[r]
        names = list(blocks)
        per = {k: v.unbind(0) for k, v in blocks.items()}

        def body(carry, *leaves):
            return self.arch.block(dict(zip(names, leaves)), carry)

        run = core._remat_wrap(body, self.layer_remat)
        for i in range(len(per[names[0]])):
            x = run(x, *(per[k][i] for k in names))
        return x

    def _input(self, m, x):
        """The stage's input: stage 0's chunk 0 embeds microbatch m
        (``x`` None), any other takes the received ``x``."""
        if x is None:
            return self.arch.embed(self.emb, self.toks[m])
        return x.requires_grad_(True) if torch.is_grad_enabled() else x

    def forward(self, m, r, x=None):
        """Microbatch m through chunk r; returns the output."""
        with torch.set_grad_enabled(self.keep_graph):
            y = self._run(r, self._input(m, x))
        self.stash[(m, r)] = (x, y if self.keep_graph else None)
        COUNTERS["in_flight"] = len({k[0] for k in self.stash})
        COUNTERS["in_flight_max"] = max(COUNTERS["in_flight_max"],
                                        COUNTERS["in_flight"])
        return y

    def head_grad(self, m, y):
        """The head's loss of microbatch m at output ``y``, its grads
        (the cotangent ``1 / M``, as the JAX schedule's) into the head's
        leaves; returns the cotangent of ``y``."""
        y = y.detach().requires_grad_(True)
        loss = self.arch.head_loss(self.head, y, self.labs[m])
        scale = 1.0 / self.M
        torch.autograd.backward(loss, torch.full_like(loss, scale))
        part = loss.detach() * scale
        self.loss = part if self.loss is None else self.loss + part
        return y.grad

    def backward(self, m, r, dy):
        """Backpropagate ``dy`` through microbatch m's chunk r; returns
        the cotangent of its input (None where it embedded)."""
        x, y = self.stash.pop((m, r))
        COUNTERS["in_flight"] = len({k[0] for k in self.stash})
        if y is None:               # recompute the stage forward, once
            with torch.enable_grad():
                y = self._run(r, self._input(m, x))
        torch.autograd.backward(y, dy)
        return None if x is None else x.grad

    def result(self, mesh, blocks_grads):
        """``(loss, grads)``: the loss broadcast from the last stage over
        ``"pipe"``, the grads merged like the params."""
        pp = mesh.shape["pipe"]
        loss = (self.loss if self.loss is not None else
                torch.zeros((), dtype=torch.float32, device=mesh.device))
        buf = loss.reshape(1).clone()
        comm.broadcast(buf, src=mesh.rank_at(pipe=pp - 1),
                       group=mesh.group("pipe"))
        grads = self.arch.merge_grads(_grads(self.emb), blocks_grads,
                                      _grads(self.head))
        return buf[0], grads


def _no_graph(remat) -> bool:
    return remat not in (False, None, "none")


def _stage_shape(toks, params):
    """An activation between stages: ``(mb, S_local, H)``."""
    return (*toks[0].shape, params["blocks"]["ln1_g"].shape[-1])


# -- GPipe --------------------------------------------------------------------

def pipeline_hidden(cfg, params, tokens, pp: int, micro_batches: int,
                    compute_dtype=torch.bfloat16, remat=True, mesh=None,
                    arch: Optional[PipelineArch] = None, ring=None,
                    specs=None):
    """Tokens -> the final hidden states ``(B, S, H)`` of this rank's rows
    on the last stage (None on the others), microbatch by microbatch
    through the stages: GPipe's forward, without autograd (so ``remat``,
    kept for the JAX signature, has nothing to save)."""
    arch = arch or arch_for(cfg, compute_dtype, mesh, ring, specs)
    s = mesh.coords["pipe"]
    toks, _ = _microbatches(tokens, tokens, micro_batches, mesh,
                            arch.n_layers, pp, f"pp {pp}")
    link = _Link(mesh, _stage_shape(toks, params), compute_dtype)
    _, blocks, _ = arch.split(params)
    st = _Stage(arch, params, [blocks], toks, toks, keep_graph=False)
    ys = []
    for m in range(micro_batches):
        y = st.forward(m, 0, None if s == 0 else link.recv_forward())
        if s < pp - 1:
            link.send_forward(y)
        else:
            ys.append(y)
    st.stash.clear()
    COUNTERS["in_flight"] = 0
    return torch.cat(ys) if ys else None


def pipeline_forward(cfg, params, tokens, pp, micro_batches,
                     compute_dtype=torch.bfloat16, remat=True, mesh=None,
                     ring=None, specs=None):
    """Tokens -> fp32 logits of this rank's rows on the last stage (None
    on the others): the GPT head (``gpt_logits``) over
    :func:`pipeline_hidden`'s states; over a vocab-parallel mesh this
    rank's vocab columns."""
    y = pipeline_hidden(cfg, params, tokens, pp, micro_batches,
                        compute_dtype, remat, mesh=mesh, ring=ring,
                        specs=specs)
    if y is None:
        return None
    head = dict(params, wte=core._zgather(params["wte"],
                                          specs and specs["wte"], mesh))
    return core.gpt_logits(cfg, head, y, compute_dtype)


def pipeline_loss(cfg, params, tokens, labels, pp: int, micro_batches: int,
                  compute_dtype=torch.bfloat16, remat=True, mesh=None,
                  arch: Optional[PipelineArch] = None, ring=None,
                  specs=None):
    """GPipe's loss without grads (an evaluation): the mean over the
    global batch, on every rank."""
    arch = arch or arch_for(cfg, compute_dtype, mesh, ring, specs)
    y = pipeline_hidden(cfg, params, tokens, pp, micro_batches,
                        compute_dtype, remat, mesh=mesh, arch=arch)
    loss = torch.zeros(1, dtype=torch.float32, device=mesh.device)
    if y is not None:
        _, _, head = arch.split(params)
        with torch.no_grad():
            loss[0] = arch.head_loss(head, y, labels)
    comm.broadcast(loss, src=mesh.rank_at(pipe=pp - 1),
                   group=mesh.group("pipe"))
    return loss[0]


def pipeline_gpipe_grads(cfg, params, tokens, labels, pp: int,
                         micro_batches: int, compute_dtype=torch.bfloat16,
                         remat=True, mesh=None,
                         arch: Optional[PipelineArch] = None, ring=None,
                         specs=None):
    """GPipe (fill/drain): every microbatch's forward with its graph kept
    (the per-layer ``remat`` policy inside it), then every backward.
    Returns ``(loss, grads)``: the global loss on every rank and this
    rank's grads like ``params``."""
    arch = arch or arch_for(cfg, compute_dtype, mesh, ring, specs)
    M, s = micro_batches, mesh.coords["pipe"]
    first, last = s == 0, s == pp - 1
    toks, labs = _microbatches(tokens, labels, M, mesh, arch.n_layers, pp,
                               f"pp {pp}")
    link = _Link(mesh, _stage_shape(toks, params), compute_dtype)
    _, blocks, _ = arch.split(params)
    st = _Stage(arch, params, [blocks], toks, labs, keep_graph=True,
                layer_remat=remat)
    ys = []
    for m in range(M):
        ys.append(st.forward(m, 0, None if first else link.recv_forward()))
        if not last:
            link.send_forward(ys[-1])
    for m in range(M):
        dy = st.head_grad(m, ys[m]) if last else link.recv_backward()
        ys[m] = None
        dx = st.backward(m, 0, dy)
        if not first:
            link.send_backward(dx)
    return st.result(mesh, _grads(st.rounds[0]))


# -- 1F1B ---------------------------------------------------------------------

def pipeline_1f1b_grads(cfg, params, tokens, labels, pp: int,
                        micro_batches: int, compute_dtype=torch.bfloat16,
                        remat=True, mesh=None,
                        arch: Optional[PipelineArch] = None, ring=None,
                        specs=None):
    """1F1B: stage s runs ``min(pp - 1 - s, M)`` warm-up forwards, then
    one forward and one backward in turn, then the cool-down backwards;
    at most ``pp - s`` microbatches are in flight on it. Returns
    ``(loss, grads)`` as :func:`pipeline_gpipe_grads`."""
    arch = arch or arch_for(cfg, compute_dtype, mesh, ring, specs)
    M, s = micro_batches, mesh.coords["pipe"]
    first, last = s == 0, s == pp - 1
    toks, labs = _microbatches(tokens, labels, M, mesh, arch.n_layers, pp,
                               f"pp {pp}")
    link = _Link(mesh, _stage_shape(toks, params), compute_dtype)
    _, blocks, _ = arch.split(params)
    st = _Stage(arch, params, [blocks], toks, labs,
                keep_graph=not _no_graph(remat))
    nxt = {"f": 0, "b": 0}

    def fwd(x):
        m = nxt["f"]
        nxt["f"] += 1
        y = st.forward(m, 0, x)
        return y, (st.head_grad(m, y) if last else None)

    def bwd(dy):
        m = nxt["b"]
        nxt["b"] += 1
        return st.backward(m, 0, dy)

    def recv_x():
        return None if first else link.recv_forward()

    warm = min(pp - 1 - s, M)
    steady = M - warm
    for _ in range(warm):
        y, _ = fwd(recv_x())
        link.send_forward(y)
    x = recv_x() if steady else None
    for i in range(steady):
        y, dy = fwd(x)
        if not last:
            dy = link.send_forward_recv_backward(y)
        del y
        dx = bwd(dy)
        if i == steady - 1:
            if not first:
                link.send_backward(dx)
        else:
            x = None if first else link.send_backward_recv_forward(dx)
    for _ in range(warm):
        dx = bwd(link.recv_backward())
        if not first:
            link.send_backward(dx)
    return st.result(mesh, _grads(st.rounds[0]))


# -- interleaved 1F1B ---------------------------------------------------------

def _exchange_chunks(pieces, v, mesh, back=False):
    """Move chunks between their two homes, in one ``batch_isend_irecv``
    over ``"pipe"``: chunk ``c`` (layers ``[c*Lc, (c+1)*Lc)``) is stored
    by stage ``c // v`` as piece ``c % v`` of its ``"pipe"`` shard and run
    by stage ``c % pp`` in round ``c // pp``. ``pieces``: ``{name: [v
    tensors]}`` of this stage, by piece (forward: the weights go to the
    stages that run them) or by round (``back``: their grads come home);
    returns the same by round, or by piece."""
    pp, s = mesh.shape["pipe"], mesh.coords["pipe"]
    group = mesh.group("pipe")
    out = {name: [None] * v for name in pieces}
    ops = []
    for i, name in enumerate(sorted(pieces)):
        for c in range(v * pp):
            ends = ((c // v, c % v), (c % pp, c // pp))   # stored, run
            (src, si), (dst, di) = ends[::-1] if back else ends
            tag = i * v * pp + c
            if src == s == dst:
                out[name][di] = pieces[name][si]
            elif src == s:
                ops.append(comm.P2POp("send", pieces[name][si].contiguous(),
                                      mesh.rank_at(pipe=dst), group, tag))
            elif dst == s:
                out[name][di] = torch.empty_like(pieces[name][0])
                ops.append(comm.P2POp("recv", out[name][di],
                                      mesh.rank_at(pipe=src), group, tag))
    COUNTERS["chunk_bytes_sent"] += sum(
        op.tensor.numel() * op.tensor.element_size() for op in ops
        if op.op == "send")
    comm.batch_isend_irecv(ops, host_staged=mesh.host_staged)
    return out


def pipeline_interleaved_grads(cfg, params, tokens, labels, pp: int, v: int,
                               micro_batches: int,
                               compute_dtype=torch.bfloat16, remat=True,
                               mesh=None,
                               arch: Optional[PipelineArch] = None,
                               ring=None, specs=None):
    """Interleaved (virtual-stage) 1F1B: returns ``(loss, grads)``.

    The JAX package's lockstep timing, per rank: with m = G*pp + j and
    chunk c = r*pp + s, ``fwd(m, c)`` runs at tick ``G*v*pp + r*pp + j +
    s`` and ``bwd(m, c)`` at ``D + G*v*pp + (v-1-r)*pp + j + (pp-1-s)``,
    D = v*pp - 1; a tick runs this stage's forward and backward where
    the schedule has them, then one exchange with its neighbours (each
    output goes where the next tick consumes it, so a stage sends
    exactly what its neighbour receives)."""
    arch = arch or arch_for(cfg, compute_dtype, mesh, ring, specs)
    M, s = micro_batches, mesh.coords["pipe"]
    Pl = v * pp
    toks, labs = _microbatches(tokens, labels, M, mesh, arch.n_layers, Pl,
                               f"v*pp = {Pl}")
    if M % pp:
        raise ValueError(
            f"interleaved schedule needs micro_batches ({M}) divisible by "
            f"pp ({pp})")
    D = v * pp - 1
    T = D + (M // pp - 1) * v * pp + (v - 1) * pp + 2 * (pp - 1) + 1
    _, blocks, _ = arch.split(params)
    by_round = _exchange_chunks({k: list(b.chunk(v)) for k, b in
                                 blocks.items()}, v, mesh)
    rounds = [{k: by_round[k][r] for k in blocks} for r in range(v)]
    st = _Stage(arch, params, rounds, toks, labs,
                keep_graph=not _no_graph(remat))
    link = _Link(mesh, _stage_shape(toks, params), compute_dtype,
                 wrap=True)
    head_stage, emb_stage = s == pp - 1, s == 0

    def fwd_at(t):
        x = t - s
        if x < 0:
            return None
        m = (x // Pl) * pp + x % Pl % pp
        return (m, x % Pl // pp) if m < M else None

    def bwd_at(t):
        y = t - D - (pp - 1 - s)
        if y < 0:
            return None
        m = (y // Pl) * pp + y % Pl % pp
        return (m, v - 1 - y % Pl // pp) if m < M else None

    x_in = dy_in = None
    for t in range(T):
        f, b = fwd_at(t), bwd_at(t)
        y = dx = dy_head = None
        if f is not None:
            m, r = f
            inject = emb_stage and r == 0
            if not inject and x_in is None:
                raise RuntimeError(f"interleaved schedule: stage {s} has no "
                                   f"input for microbatch {m}, round {r}")
            y = st.forward(m, r, None if inject else x_in)
            if head_stage and r == v - 1:
                dy_head = st.head_grad(m, y)
                y = None               # the head consumed it
        if b is not None:
            m, r = b
            dx = st.backward(m, r, dy_head if head_stage and r == v - 1
                             else dy_in)
            if emb_stage and r == 0:
                dx = None              # went into the embedding
        f1, b1 = fwd_at(t + 1), bwd_at(t + 1)
        x_in, dy_in = link.exchange(
            fwd=y, bwd=dx,
            recv_fwd=f1 is not None and not (emb_stage and f1[1] == 0),
            recv_bwd=b1 is not None and not (head_stage and b1[1] == v - 1))
    g_rounds = [_grads(r) for r in st.rounds]
    home = _exchange_chunks({k: [g[k] for g in g_rounds] for k in blocks},
                            v, mesh, back=True)
    return st.result(mesh, {k: torch.cat(p) for k, p in home.items()})

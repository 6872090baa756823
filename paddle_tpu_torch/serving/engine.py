"""Serving engine: the paged-decode model runner (port of
``paddle_tpu.serving.engine``).

Four step kinds, every shape bucketed (``bucketing.bucket_for``) exactly
as in the JAX package, so the port pads the same rows and its kernels
see a closed set of launch shapes:

- ``decode``   — ``(B_bucket, 1)`` tokens, one per running request, the
  paged decode kernel (K-DEC) over the pool; write slots come from the
  page table and the context lengths;
- ``verify``   — ``(B_bucket, k+1)`` tokens, the speculative-decoding
  window (last committed token + k drafted), the paged multi-query
  kernel (K-MQ), causal within the window, returning the whole window's
  logits so the scheduler can accept the longest matching prefix;
- ``prefill_packed`` — all newly admitted requests packed into ONE
  ``(1, T_bucket)`` row with segment ids, through the segmented flash
  kernel (K-SEG), while each token's K/V is scattered into its
  request's pages;
- ``prefill_batch`` — one request per row with trailing pad, plain
  causal attention (K-BSHD): what ``generate()`` uses.

With ``ServingConfig(kv_dtype="int8")`` the pools are int8 with per-page
scales: every step names the pages it writes (``touched``) and how many
tokens each held before (``touched_valid``), built on the host with the
slots, and the kernels become K-DEC8 and K-MQ8.

PyTorch runs eagerly: the model's parameters are read live on every
step, and the pools are updated in place. Not ported: the compile
ledger, which has no counterpart without ``jit``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .bucketing import bucket_for
from .kv_cache import PagedKVCache

__all__ = ["ServingConfig", "ServingEngine"]


@dataclasses.dataclass
class ServingConfig:
    page_size: int = 16
    num_pages: Optional[int] = None   # None: max_batch * max seq pages + 1
    max_model_len: int = 256          # prompt + generated, per request
    max_batch: int = 32               # decode rows (top bucket)
    max_prefill_tokens: int = 512     # packed-prefill token cap
    min_batch_bucket: int = 1
    min_prefill_bucket: int = 32
    dtype: Optional[torch.dtype] = None  # KV pool dtype (default: model's)
    kv_dtype: str = "fp32"            # "int8": quantized pools + scales
    seed: int = 0                     # sampling rng


class ServingEngine:
    """Paged-KV model runner for ``GPTForCausalLM`` and
    ``LlamaForCausalLM``: the trunk (GPT's ``.gpt``, LLaMA's ``.model``)
    takes ``(input_ids, position_ids, caches=)``, the head is GPT's
    ``_logits`` or LLaMA's ``lm_head``; the pools keep the config's
    ``kv_heads``. Runs on the model's device."""

    def __init__(self, model, cfg: Optional[ServingConfig] = None):
        self.cfg = cfg or ServingConfig()
        self.model = model
        model.eval()
        mc = model.cfg
        self.device = next(model.parameters()).device
        self.num_heads = mc.num_heads
        self.num_kv_heads = getattr(mc, "kv_heads", None) or mc.num_heads
        self.head_dim = mc.head_dim
        self.vocab_size = mc.vocab_size
        # trunk and head discovery: GPT keeps them at .gpt and ._logits,
        # LLaMA at .model and .lm_head
        self._trunk = model.gpt if hasattr(model, "gpt") else model.model
        self._head = (model._logits if hasattr(model, "_logits")
                      else model.lm_head)
        if self.cfg.max_model_len > mc.max_position_embeddings:
            raise ValueError(
                f"max_model_len {self.cfg.max_model_len} exceeds the "
                f"model's max_position_embeddings "
                f"{mc.max_position_embeddings}")
        if self.cfg.max_prefill_tokens < self.cfg.max_model_len:
            # any legal context (e.g. a preempted request re-prefilling
            # prompt+generated) must fit one packed prefill
            raise ValueError(
                f"max_prefill_tokens {self.cfg.max_prefill_tokens} < "
                f"max_model_len {self.cfg.max_model_len}: a maximal "
                "context could never prefill")
        self.max_positions = mc.max_position_embeddings
        self.max_pages_per_seq = -(-self.cfg.max_model_len
                                   // self.cfg.page_size)
        num_pages = self.cfg.num_pages
        if num_pages is None:
            # worst case every decode row at full length, +1 for the
            # reserved garbage page
            num_pages = self.cfg.max_batch * self.max_pages_per_seq + 1
        self.kv = PagedKVCache(
            num_layers=mc.num_layers, num_pages=num_pages,
            page_size=self.cfg.page_size, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            dtype=self.cfg.dtype or next(model.parameters()).dtype,
            device=self.device, kv_dtype=self.cfg.kv_dtype)
        self._int8 = self.cfg.kv_dtype == "int8"
        self._rng = np.random.RandomState(self.cfg.seed)

    # -- page management (delegated to the scheduler-facing pool) ----------

    @property
    def pool(self):
        return self.kv.pool

    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pool pages one request can hold over its lifetime:
        prefill writes ``prompt_len`` tokens, decode grows a page each
        time the context crosses a boundary, and the FINAL generated
        token's K/V is never written."""
        return (prompt_len + max_new_tokens - 2) // self.kv.page_size + 1

    def refresh_params(self) -> None:
        """Kept for the JAX package's interface. The port's steps read
        the model's parameters live, so new weights (training,
        ``load_state_dict``) are served at once and there is nothing to
        re-snapshot."""

    # -- steps --------------------------------------------------------------

    def _to_device(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True) for a in arrays]

    @torch.no_grad()
    def decode(self, tokens: np.ndarray, page_tables: np.ndarray,
               context_lens: np.ndarray) -> np.ndarray:
        """One decode step for ``n`` running requests: ``tokens`` (n,)
        newest token ids, ``page_tables`` (n, max_pages_per_seq),
        ``context_lens`` (n,) tokens already in the pool. Writes each
        new token's K/V at position ``context_lens[i]`` and returns
        next-token logits ``(n, vocab)`` float32."""
        n = len(tokens)
        if n == 0:
            return np.zeros((0, self.vocab_size), np.float32)
        b = bucket_for(n, minimum=self.cfg.min_batch_bucket,
                       maximum=self.cfg.max_batch)
        ps = self.kv.page_size
        tok = np.zeros((b, 1), np.int64)
        tok[:n, 0] = tokens
        pt = np.zeros((b, self.max_pages_per_seq), np.int32)
        pt[:n, :page_tables.shape[1]] = page_tables
        cl = np.zeros((b,), np.int32)
        cl[:n] = context_lens
        # padding rows (cl 0, page 0) write and read slot 0 of the
        # reserved garbage page; their logits are discarded
        page = pt[np.arange(b), cl // ps].astype(np.int64)
        slots = page * ps + cl % ps
        # int8: each row touches the page its write lands in, holding
        # cl % ps valid tokens (padding rows touch garbage page 0)
        touched = (page, cl % ps) if self._int8 else ()
        tok_t, pos_t, pt_t, sl_t, slot_t, *tch = self._to_device(
            tok, cl[:, None].astype(np.int64), pt, cl + 1, slots, *touched)
        state = self.kv.make_state(
            "decode", slot_t, self.num_heads, page_table=pt_t,
            seq_lens=sl_t, **_touched_kw(tch))
        logits = _paged_forward(self, tok_t, pos_t, state, None)
        return logits[:n]

    @torch.no_grad()
    def verify(self, tokens: np.ndarray, page_tables: np.ndarray,
               context_lens: np.ndarray) -> np.ndarray:
        """One speculative verify step for ``n`` running requests:
        ``tokens`` (n, w), each row ``[last committed token, draft_1 ..
        draft_{w-1}]`` (short drafts zero-padded on the right; the caller
        ignores their logits rows), ``page_tables`` (n,
        max_pages_per_seq), ``context_lens`` (n,) tokens already in the
        pool. Writes all ``w`` tokens' K/V at positions
        ``context_lens[i] .. context_lens[i] + w - 1`` and returns the
        full window's logits ``(n, w, vocab)`` float32: row ``j`` is the
        next-token distribution after the window's first ``j + 1``
        tokens, so ``w == 1`` is a decode step."""
        n, w = tokens.shape
        if n == 0:
            return np.zeros((0, w, self.vocab_size), np.float32)
        b = bucket_for(n, minimum=self.cfg.min_batch_bucket,
                       maximum=self.cfg.max_batch)
        ps = self.kv.page_size
        maxp = self.max_pages_per_seq
        tok = np.zeros((b, w), np.int64)
        tok[:n] = tokens
        pt = np.zeros((b, maxp), np.int32)
        pt[:n, :page_tables.shape[1]] = page_tables
        cl = np.zeros((b,), np.int32)
        cl[:n] = context_lens
        pos = cl[:, None].astype(np.int64) + np.arange(w)[None, :]  # (b, w)
        # window rows past a request's own (truncated) draft still fill
        # the fixed window: past the page table's reach they would alias
        # a real page, so they go to the drop page instead
        lp = np.minimum(pos // ps, maxp - 1)
        slots = pt[np.arange(b)[:, None], lp].astype(np.int64) * ps + pos % ps
        slots = np.where(pos < maxp * ps, slots, self.kv.num_pages * ps)
        touched = ()
        if self._int8:
            # the window spans at most n_touch consecutive logical pages
            # from cl // ps; pages past the table's reach drop
            n_touch = (w + ps - 2) // ps + 1
            lpt = cl[:, None] // ps + np.arange(n_touch)[None, :]
            phys = pt[np.arange(b)[:, None], np.minimum(lpt, maxp - 1)]
            touched = (np.where(lpt < maxp, phys,
                                self.kv.num_pages).reshape(-1),
                       np.clip(cl[:, None] - lpt * ps, 0, ps).reshape(-1))
        # the model sees positions clamped to its table, as the JAX
        # package's gather clamps: only rows that are never committed
        # reach past it
        tok_t, pos_t, pt_t, sl_t, slot_t, *tch = self._to_device(
            tok, np.minimum(pos, self.max_positions - 1), pt, cl + w,
            slots.reshape(-1), *touched)
        state = self.kv.make_state(
            "verify", slot_t, self.num_heads, page_table=pt_t,
            seq_lens=sl_t, **_touched_kw(tch))
        gather = torch.arange(b * w, device=self.device)  # every row
        logits = _paged_forward(self, tok_t, pos_t, state, gather)
        return logits.reshape(b, w, -1)[:n]

    @torch.no_grad()
    def prefill_packed(self, seqs: Sequence[np.ndarray],
                       page_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Varlen prefill: the admitted requests' contexts packed into
        one row with segment ids (K-SEG), K/V scattered into each
        request's pages. Returns last-token logits ``(len(seqs), vocab)``
        float32."""
        total = sum(len(s) for s in seqs)
        tb = bucket_for(total, minimum=self.cfg.min_prefill_bucket,
                        maximum=self.cfg.max_prefill_tokens)
        nb = bucket_for(len(seqs), minimum=self.cfg.min_batch_bucket,
                        maximum=self.cfg.max_batch)
        ps = self.kv.page_size
        oob = self.kv.num_pages * ps  # dropped by the scatter
        tok = np.zeros((1, tb), np.int64)
        pos = np.zeros((1, tb), np.int64)
        seg = np.full((1, tb), -1, np.int32)
        slots = np.full((tb,), oob, np.int64)
        gather = np.zeros((nb,), np.int64)
        # int8: every page a prefill writes is touched with NOTHING valid
        # before it (a fresh or recycled allocation); sentinels drop
        touched = np.full((tb // ps + nb,), self.kv.num_pages, np.int64)
        tn = 0
        off = 0
        for i, (s, pages) in enumerate(zip(seqs, page_lists)):
            L = len(s)
            tok[0, off:off + L] = s
            pos[0, off:off + L] = np.arange(L)
            seg[0, off:off + L] = i
            pg = np.asarray(pages, np.int64)
            t = np.arange(L)
            slots[off:off + L] = pg[t // ps] * ps + t % ps
            npg = -(-L // ps)
            touched[tn:tn + npg] = pg[:npg]
            tn += npg
            gather[i] = off + L - 1
            off += L
        return self._prefill("prefill_packed", tok, pos, slots, seg,
                             gather, touched)[:len(seqs)]

    @torch.no_grad()
    def prefill_batch(self, seqs: Sequence[np.ndarray],
                      page_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Batch prefill: one request per row, trailing pad, plain causal
        attention (K-BSHD). Returns last-token logits
        ``(len(seqs), vocab)`` float32."""
        n = len(seqs)
        smax = max(len(s) for s in seqs)
        sb = bucket_for(smax, minimum=self.cfg.min_prefill_bucket,
                        maximum=self.cfg.max_model_len)
        nb = bucket_for(n, minimum=self.cfg.min_batch_bucket,
                        maximum=self.cfg.max_batch)
        ps = self.kv.page_size
        oob = self.kv.num_pages * ps
        tok = np.zeros((nb, sb), np.int64)
        pos = np.tile(np.arange(sb, dtype=np.int64)[None], (nb, 1))
        slots = np.full((nb, sb), oob, np.int64)
        gather = np.zeros((nb,), np.int64)
        npg_max = -(-sb // ps)
        touched = np.full((nb * npg_max,), self.kv.num_pages, np.int64)
        for i, (s, pages) in enumerate(zip(seqs, page_lists)):
            L = len(s)
            tok[i, :L] = s
            pg = np.asarray(pages, np.int64)
            t = np.arange(L)
            slots[i, :L] = pg[t // ps] * ps + t % ps
            npg = -(-L // ps)
            touched[i * npg_max:i * npg_max + npg] = pg[:npg]
            gather[i] = i * sb + L - 1
        return self._prefill("prefill_batch", tok, pos, slots.reshape(-1),
                             None, gather, touched)[:n]

    def _prefill(self, mode, tok, pos, slots, seg, gather, touched):
        arrays = [tok, pos, slots, gather] + ([] if seg is None else [seg])
        if self._int8:
            arrays += [touched, np.zeros_like(touched)]
        dev = self._to_device(*arrays)
        tok_t, pos_t, slot_t, gather_t = dev[:4]
        state = self.kv.make_state(
            mode, slot_t, self.num_heads,
            segment_ids=None if seg is None else dev[4],
            **_touched_kw(dev[4 + (seg is not None):]))
        return _paged_forward(self, tok_t, pos_t, state, gather_t)

    # -- sampling -----------------------------------------------------------

    def sample(self, logits: np.ndarray, temperature: float = 0.0,
               top_k: int = 0) -> np.ndarray:
        """Next tokens from ``(n, vocab)`` logits: greedy when
        ``top_k == 0`` or ``temperature <= 0``, else top-k sampling
        (engine-seeded numpy rng — deterministic per engine)."""
        if not top_k or temperature <= 0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        out = np.empty(len(logits), np.int32)
        for i, row in enumerate(logits):
            idx = np.argpartition(row, -top_k)[-top_k:]
            z = row[idx].astype(np.float64) / temperature
            z -= z.max()
            p = np.exp(z)
            p /= p.sum()
            out[i] = idx[self._rng.choice(top_k, p=p)]
        return out


def _touched_kw(arrays) -> dict:
    """The int8 write path's ``touched_pages`` / ``touched_valid`` from
    the step's device arrays (none outside int8 mode)."""
    if not arrays:
        return {}
    return {"touched_pages": arrays[0], "touched_valid": arrays[1]}


def _paged_forward(engine, tokens, positions, state, gather_idx):
    """Thread a PagedForwardState through the trunk, gather the requested
    rows (the last row when ``gather_idx`` is None: decode, S == 1),
    project to logits and bring them to the host as float32 numpy (the
    step's one intentional sync)."""
    hidden = engine._trunk(tokens, positions, caches=state)   # (B, S, H)
    if gather_idx is None:
        rows = hidden[:, -1]
    else:
        rows = hidden.reshape(-1, hidden.shape[-1])[gather_idx]
    return engine._head(rows).float().cpu().numpy()

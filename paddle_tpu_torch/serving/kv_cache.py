"""Paged KV cache: a preallocated pool + page-granular allocator (port of
``paddle_tpu.serving.kv_cache``).

K/V live in a shared pool of fixed-size **pages**:

    k_pools[layer]: (num_pages, page_size, num_kv_heads * head_dim)

and each request owns an ordered list of page ids (its *page table*).
Admission allocates pages, completion/eviction frees them, and decode
grows a request by one page exactly when its length crosses a page
boundary. Heads are packed along the last dimension, the layout the
paged decode kernel (K-DEC) reads.

Page 0 is **reserved as the garbage page**: bucketed batches carry
padding rows whose writes and page-table slots must point at a real
page, and the allocator never hands page 0 out. Out-of-range *slots*
(padding tokens of a prefill, verify rows past the table's reach) are
dropped: each pool's storage carries one extra **drop page** past the
last page, and every slot at or past ``num_pages * page_size`` lands
there, so the scatter never syncs the host to filter them.

Unlike the JAX package, whose pools flow functionally through jitted
steps, the port updates the pools **in place** (``index_copy_``): no
copy of the cache is ever made.

**int8 mode** (``kv_dtype="int8"``): K/V pools store int8, with a THIRD
per-layer pool of per-page, per-kv-head fp32 quantization scales::

    s_pools[layer]: (num_pages, 2, num_kv_heads)   # [0]=K, [1]=V

Quantization is symmetric absmax (``scale = absmax / 127``, values in
``[-127, 127]``), recomputed on every write (:func:`_requant_pages`):
the step's *touched* pages are gathered, dequantized with their old
scales, slots past each page's valid-before-write count zeroed (a stale
tenant of a recycled page, or a rejected draft, must never feed the
absmax), the new values merged in, and each page requantized under its
fresh scale. Touched entries equal to ``num_pages`` (sentinels) write
back into the drop page, as out-of-range slots do. The paged kernels
(K-DEC8, K-MQ8) fuse the dequant into their dot products.

:func:`copy_pages` is the disaggregated handoff's transfer: it copies
pages of every layer from one cache into another, in place, int8 scale
pools included. The JAX package's ``PagedKVCache.commit`` (the swap its
functional pools need after a copy) has no counterpart: no caller of the
port needs it, since its pools are written where they lie.
:func:`plan_kv_pool` sizes a pool against device memory.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence

import torch

from ..device import resolve_device
from ..ops import attention_dispatch as disp

__all__ = ["PagesExhausted", "PagePool", "PagedKVCache",
           "PagedForwardState", "PagedLayerView", "copy_pages",
           "plan_kv_pool"]


class PagesExhausted(RuntimeError):
    """The pool has fewer free pages than requested — the scheduler's
    signal to evict (preempt) a running request."""


class PagePool:
    """Host-side page allocator: a free list over ``num_pages`` pages,
    page 0 reserved (see module docstring). Double-free and foreign-page
    free raise — a page table bug must never silently corrupt the pool.

    **Leases** (disaggregated handoff): :meth:`lease` pins a set of live
    pages under an epoch-stamped lease id while their bytes are in
    flight to another pool. A leased page that is freed is *deferred* —
    it stays out of the free list until every lease on it is released,
    so a transfer can never read a recycled page. :meth:`release_lease`
    drops the pin (deferred pages then actually free);
    :meth:`reclaim_lease` is the orphan sweep for a lease whose epoch
    lost: it force-frees whatever the lease still pins.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is the "
                             "reserved garbage page)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = deque(range(1, num_pages))
        self._live = set()
        self._leases = {}       # lease_id -> {"epoch", "pages", "state"}
        self._lease_refs = {}   # page -> number of leases pinning it
        self._deferred = set()  # freed-while-leased: live, not reusable
        self._lease_seq = 0
        self.lease_reclaims = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        """Total usable pages (``num_pages`` minus the reserved garbage
        page) — the most a single request could ever hold."""
        return self.num_pages - 1

    @property
    def in_use(self) -> int:
        return len(self._live)

    @property
    def leased(self) -> int:
        """Pages currently pinned by at least one held lease."""
        return len(self._lease_refs)

    def allocate(self, n: int) -> List[int]:
        """``n`` distinct pages, or :class:`PagesExhausted` (allocating
        nothing) when fewer are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise PagesExhausted(
                f"need {n} page(s), {len(self._free)} free "
                f"(pool {self.num_pages}, {len(self._live)} live)")
        out = [self._free.popleft() for _ in range(n)]
        self._live.update(out)
        return out

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p not in self._live:
                raise ValueError(
                    f"freeing page {p} that is not live (double free, or "
                    "a page the pool never allocated)")
            if p in self._lease_refs:
                # freed under a lease: defer — the page stays live (and
                # unreadable by new tenants) until the lease releases
                if p in self._deferred:
                    raise ValueError(
                        f"freeing page {p} twice under a lease (double "
                        "deferred free)")
                self._deferred.add(p)
                continue
            self._live.discard(p)
            self._free.append(p)

    # -- transfer leases ---------------------------------------------------

    def lease(self, pages: Sequence[int], epoch: int) -> int:
        """Pin ``pages`` (all live, none already freed) under a new lease
        stamped with ``epoch``; returns the lease id. Leasing a dead or
        deferred page raises (lease-after-free)."""
        pages = list(pages)
        for p in pages:
            if p not in self._live or p in self._deferred:
                raise ValueError(
                    f"leasing page {p} that is not live (freed, deferred "
                    "or never allocated) — lease-after-free")
        self._lease_seq += 1
        lid = self._lease_seq
        self._leases[lid] = {"epoch": int(epoch), "pages": pages,
                             "state": "held"}
        for p in pages:
            self._lease_refs[p] = self._lease_refs.get(p, 0) + 1
        return lid

    def lease_info(self, lease_id: int) -> Optional[dict]:
        rec = self._leases.get(lease_id)
        return None if rec is None else dict(rec)

    def is_adoptable(self, pages: Sequence[int]) -> bool:
        """True when every page is live and not deferred."""
        return all(p in self._live and p not in self._deferred
                   for p in pages)

    def release_lease(self, lease_id: int) -> List[int]:
        """Drop the lease; pages whose last pin this was AND that were
        deferred-freed under it are freed now and returned. Releasing a
        lease that is not held raises."""
        rec = self._leases.get(lease_id)
        if rec is None or rec["state"] != "held":
            state = "unknown" if rec is None else rec["state"]
            raise ValueError(
                f"releasing lease {lease_id} that is not held "
                f"(state={state}) — double release?")
        rec["state"] = "released"
        freed = []
        for p in rec["pages"]:
            n = self._lease_refs.get(p, 0) - 1
            if n > 0:
                self._lease_refs[p] = n
                continue
            self._lease_refs.pop(p, None)
            if p in self._deferred:
                self._deferred.discard(p)
                self._live.discard(p)
                self._free.append(p)
                freed.append(p)
        return freed

    def reclaim_lease(self, lease_id: int) -> List[int]:
        """Orphan sweep: release the pins AND force-free any lease page
        still live. Returns the pages freed; double reclaim raises."""
        rec = self._leases.get(lease_id)
        if rec is None or rec["state"] == "reclaimed":
            raise ValueError(
                f"reclaiming lease {lease_id} that is "
                f"{'unknown' if rec is None else 'already reclaimed'}")
        freed = []
        if rec["state"] == "held":
            freed = self.release_lease(lease_id)
        rec["state"] = "reclaimed"
        for p in rec["pages"]:
            if (p in self._live and p not in self._deferred
                    and p not in self._lease_refs):
                self._live.discard(p)
                self._free.append(p)
                freed.append(p)
        self.lease_reclaims += 1
        return freed


# floor for recomputed absmax scales: an all-zero page (fresh
# allocation) still carries a finite, positive scale, so dequant
# arithmetic stays NaN-free everywhere (masked or not)
_SCALE_EPS = 1e-8


@dataclasses.dataclass
class PagedForwardState:
    """The per-forward paged view threaded through
    ``GPTModel.forward(caches=...)``. Attention layers write through
    :meth:`view`; the pools are updated in place.

    ``mode``: ``"decode"`` (one token per request, the paged kernel),
    ``"verify"`` (a speculative window of S = k + 1 tokens per request,
    the multi-query paged kernel, causal within the window, ``seq_lens``
    INCLUDING the window), ``"prefill_batch"`` (one request per row,
    trailing pad, plain causal attention) or ``"prefill_packed"`` (many
    requests packed into one row, segment-masked attention).
    """

    k_pools: list                      # per layer (P, page_size, nh_kv*d)
    v_pools: list
    k_stores: list                     # per layer (P + 1, page_size, hp)
    v_stores: list
    mode: str
    slot_mapping: torch.Tensor         # (T,) int64 flat slots; OOB drops
    num_heads: int
    num_kv_heads: int
    head_dim: int
    page_table: Optional[torch.Tensor] = None  # (B, max_pages) [decode]
    seq_lens: Optional[torch.Tensor] = None    # (B,) int32 incl. new token
    segment_ids: Optional[torch.Tensor] = None  # (B, S) [prefill_packed]
    # -- int8 mode (kv_dtype="int8") --------------------------------------
    kv_dtype: str = "fp32"
    s_pools: Optional[list] = None     # per layer (P, 2, nh_kv) fp32
    s_stores: Optional[list] = None    # per layer (P + 1, 2, nh_kv)
    touched_pages: Optional[torch.Tensor] = None  # (M,) int64 pages
    touched_valid: Optional[torch.Tensor] = None  # (M,) valid pre-write
    requant_plan: Optional[tuple] = None  # _requant_plan, made at layer 0

    def view(self, layer: int) -> "PagedLayerView":
        return PagedLayerView(self, layer)


class PagedLayerView:
    """One layer's window onto the forward state: ``update`` scatters the
    new K/V into the layer's pools, ``attend`` runs the mode's attention.
    What the attention modules consume (models/gpt.py)."""

    def __init__(self, state: PagedForwardState, layer: int):
        self.state = state
        self.layer = layer

    def update(self, k, v):
        """Write ``k``/``v`` ``(B, S, nh_kv, d)`` into this layer's pools
        at ``slot_mapping``; padding slots (>= pool size) are dropped.
        int8 mode requantizes every touched page (module docstring)."""
        st, i = self.state, self.layer
        if st.kv_dtype == "int8":
            if st.requant_plan is None:    # once per step, for all layers
                st.requant_plan = _requant_plan(
                    st.slot_mapping, st.touched_pages, st.touched_valid,
                    *st.k_pools[i].shape[:2])
            _requant_pages(st.k_stores[i], st.v_stores[i], st.s_stores[i],
                           k, v, st.requant_plan)
            return
        _scatter_pages(st.k_stores[i], k, st.slot_mapping)
        _scatter_pages(st.v_stores[i], v, st.slot_mapping)

    def attend(self, q, k, v, scale=None):
        """Mode-appropriate attention. ``q`` ``(B, S, nh, d)``; ``k``/
        ``v`` the CURRENT call's keys/values ``(B, S, nh_kv, d)`` (fresh
        prefills attend only themselves; decode and verify read the
        pools). Returns ``(B, S, nh, d)`` in q's dtype."""
        st = self.state
        b, s, nh, d = q.shape
        kp, vp = st.k_pools[self.layer], st.v_pools[self.layer]
        if st.mode in ("decode", "verify"):
            scales = None
            if st.kv_dtype == "int8":
                # the query keeps its dtype: the kernels read int8 pools
                # with a fp32 or bf16 query
                scales, qk = st.s_pools[self.layer], q
            else:
                qk = q.to(kp.dtype)
            if st.mode == "decode":
                o = disp.paged_attention(
                    qk[:, 0].contiguous(), kp, vp, st.page_table,
                    st.seq_lens, scale=scale, scales=scales)[:, None]
            else:
                # the speculative window: S = k + 1 rows whose K/V
                # update() just wrote, causal within the window
                o = disp.paged_multiquery_attention(
                    qk.contiguous(), kp, vp, st.page_table, st.seq_lens,
                    scale=scale, scales=scales)
            return o.to(q.dtype)
        rep = st.num_heads // st.num_kv_heads
        if rep > 1:  # GQA: expand kv heads for the dense/packed paths
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if st.mode == "prefill_packed":
            def packed(x):  # (B, S, nh*d); a strided view is copied
                return x.reshape(b, s, nh * d).contiguous()

            o = disp.segment_attention_packed(
                packed(q), packed(k), packed(v), nh, st.segment_ids,
                causal=True, scale=scale)
            return o.reshape(b, s, nh, d)
        if st.mode == "prefill_batch":
            # trailing-pad rows: plain causal masking already isolates
            # real tokens from the pad that FOLLOWS them
            return disp.causal_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), scale=scale)
        raise ValueError(f"unknown paged mode {st.mode!r}")


def _scatter_pages(store, vals, slots):
    """``store`` (P + 1, ps, hp): a layer's pool storage plus the drop
    page; ``vals`` (B, S, nh_kv, d); ``slots`` (B*S,) int64 flat token
    slots into the ``P*ps`` stream. Slots at or past ``P*ps`` land in
    the drop page (dropped). In place."""
    hp = store.shape[-1]
    flat = store.view(-1, hp)
    idx = slots.clamp(max=flat.shape[0] - 1)
    flat.index_copy_(0, idx, vals.reshape(-1, hp).to(store.dtype))
    return store


def _requant_plan(slots, touched, touched_valid, num_pages, page_size):
    """The int8 write's index work, the same for every layer of a step:
    ``(tp, tslot, keep)``. ``touched`` (M,) physical page ids, every page
    any of ``slots`` lands in (sentinels ``== num_pages`` write back into
    the drop page; padding rows may repeat garbage page 0, whose content
    is never read unmasked, so duplicate writebacks are harmless);
    ``touched_valid`` (M,) tokens already valid in each page BEFORE this
    step's writes. ``tp`` (M,) the pages to gather and write back,
    ``tslot`` (T,) each slot's row among the ``M * page_size`` gathered
    rows, or row ``M * page_size`` (dropped) for a slot outside the
    touched set or past the pool (the JAX package's ``inv`` row ``m``),
    ``keep`` (M, page_size) the valid-before-write rows."""
    p, ps = num_pages, page_size
    m = touched.shape[0]
    dev = touched.device
    tp = touched.long().clamp(0, p)     # sentinel -> the drop page
    # inverse page map: physical page -> gathered row, else row m
    inv = torch.full((p + 1,), m, dtype=torch.long, device=dev)
    inv[tp] = torch.arange(m, device=dev)
    sl = slots.long()
    tslot = (inv[(sl // ps).clamp(0, p)] * ps + sl % ps).clamp(max=m * ps)
    keep = (torch.arange(ps, device=dev)[None, :]
            < touched_valid.long()[:, None])
    return tp, tslot, keep


def _requant_pages(k_store, v_store, s_store, k, v, plan):
    """The int8 write path (module docstring), in place, K and V together.
    ``k_store``/``v_store`` (P + 1, ps, hp) int8 and ``s_store``
    (P + 1, 2, nh_kv) fp32, each ending in the drop page; ``k``/``v``
    (B, S, nh_kv, d) the new values; ``plan`` from
    :func:`_requant_plan`."""
    tp, tslot, keep = plan
    m, ps = keep.shape
    hp = k_store.shape[-1]
    nh_kv = s_store.shape[-1]
    shape = (m, ps, 2, nh_kv, hp // nh_kv)
    # gather, dequantize with the old scales, zero the stale rows
    g = torch.stack([k_store[tp], v_store[tp]], dim=2).view(shape).float()
    g = g * s_store[tp][:, None, :, :, None]
    g.masked_fill_(~keep[:, :, None, None, None], 0.0)
    # merge the new values (row m * ps takes the dropped slots)
    flat = torch.cat([g.view(m * ps, 2 * hp), g.new_zeros(1, 2 * hp)])
    new = torch.stack([k.reshape(-1, hp), v.reshape(-1, hp)], dim=1)
    flat.index_copy_(0, tslot, new.view(-1, 2 * hp).float())
    x = flat[:m * ps].view(shape)
    # symmetric absmax per (page, K/V, kv head), round half to even
    sc = (x.abs().amax(dim=(1, 4)) / 127.0).clamp_min(_SCALE_EPS)
    q = torch.round(x / sc[:, None, :, :, None]).clamp_(-127.0, 127.0)
    q = q.to(torch.int8).view(m, ps, 2, hp)
    k_store.index_copy_(0, tp, q[:, :, 0])
    v_store.index_copy_(0, tp, q[:, :, 1])
    s_store.index_copy_(0, tp, sc)


class PagedKVCache:
    """The pool pair per layer plus its allocator, sized once at engine
    construction on ``device`` (CUDA unless the caller passes ``"cpu"``).
    ``kv_dtype="fp32"``: unquantized pools in ``dtype`` (float32, the
    default, or bfloat16); ``kv_dtype="int8"``: int8 pools plus the
    per-page scale pools (``dtype`` is ignored)."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, dtype=None, device=None,
                 kv_dtype: str = "fp32"):
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype must be 'fp32' or 'int8', "
                             f"got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        if kv_dtype == "int8":
            dtype = torch.int8
        else:
            dtype = dtype or torch.float32
            if dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"KV pools are float32 or bfloat16, got "
                                f"{dtype}")
        device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.page_size = int(page_size)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.pool = PagePool(num_pages, page_size)

        def stores(shape, dt):   # the pools plus the drop page, and views
            st = [torch.zeros((num_pages + 1, *shape), dtype=dt,
                              device=device) for _ in range(num_layers)]
            return st, [s[:num_pages] for s in st]

        hp = num_kv_heads * head_dim
        self.k_stores, self.k_pools = stores((page_size, hp), dtype)
        self.v_stores, self.v_pools = stores((page_size, hp), dtype)
        self.s_stores = self.s_pools = None
        if kv_dtype == "int8":
            self.s_stores, self.s_pools = stores((2, num_kv_heads),
                                                 torch.float32)

    @property
    def num_pages(self) -> int:
        return self.pool.num_pages

    def pool_bytes(self) -> int:
        """Bytes of the K/V pools and, in int8 mode, their scales (the
        drop pages not counted, as the JAX package has none)."""
        return int(2 * self.num_layers * self.num_pages * self.page_size
                   * self.num_kv_heads * self.head_dim
                   * self.k_pools[0].element_size()
                   ) + self.scale_pool_bytes()

    def scale_pool_bytes(self) -> int:
        """Bytes of the per-page scale pools (0 outside int8 mode)."""
        if self.s_pools is None:
            return 0
        return int(self.num_layers * self.num_pages * 2
                   * self.num_kv_heads * 4)

    def make_state(self, mode: str, slot_mapping, num_heads: int,
                   page_table=None, seq_lens=None, segment_ids=None,
                   touched_pages=None,
                   touched_valid=None) -> PagedForwardState:
        return PagedForwardState(
            k_pools=self.k_pools, v_pools=self.v_pools,
            k_stores=self.k_stores, v_stores=self.v_stores, mode=mode,
            slot_mapping=slot_mapping, num_heads=num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            page_table=page_table, seq_lens=seq_lens,
            segment_ids=segment_ids, kv_dtype=self.kv_dtype,
            s_pools=self.s_pools, s_stores=self.s_stores,
            touched_pages=touched_pages, touched_valid=touched_valid)


def copy_pages(src_kv: PagedKVCache, dst_kv: PagedKVCache,
               src_pages: Sequence[int], dst_pages: Sequence[int],
               limit: Optional[int] = None) -> int:
    """The handoff transfer: copy ``src_pages`` of every layer of
    ``src_kv`` into ``dst_pages`` of ``dst_kv`` (a gather and an
    in-place ``index_copy_`` per layer into the stores, int8 scale pools
    included), so the adopting side reads the new bytes as it reads its
    own decode writes. Returns the number of pages copied; ``limit``
    truncates the copy (the partial-transfer fault injection): callers
    check the count against ``len(src_pages)`` before adopting. A cache
    on the CPU and one on a CUDA device never exchange pages (no
    fallback across devices)."""
    if len(src_pages) != len(dst_pages):
        raise ValueError(
            f"page-count mismatch: {len(src_pages)} src vs "
            f"{len(dst_pages)} dst")
    if src_kv.kv_dtype != dst_kv.kv_dtype:
        raise ValueError(
            f"kv_dtype mismatch: {src_kv.kv_dtype} -> {dst_kv.kv_dtype}")
    n = len(src_pages)
    if limit is not None:
        n = max(0, min(n, int(limit)))
    if n == 0:
        return 0
    geo = ("num_layers", "page_size", "num_kv_heads", "head_dim")
    if any(getattr(src_kv, a) != getattr(dst_kv, a) for a in geo):
        raise ValueError(
            "pool geometry mismatch: "
            + ", ".join(f"{a} {getattr(src_kv, a)} -> {getattr(dst_kv, a)}"
                        for a in geo))
    sdev, ddev = src_kv.k_stores[0].device, dst_kv.k_stores[0].device
    if sdev.type != ddev.type:
        raise ValueError(f"device mismatch: a {sdev} cache cannot hand "
                         f"pages to a {ddev} cache")
    sp, dp = list(src_pages)[:n], list(dst_pages)[:n]
    for pages, kv, side in ((sp, src_kv, "src"), (dp, dst_kv, "dst")):
        bad = [p for p in pages if not 0 <= int(p) < kv.num_pages]
        if bad:
            raise ValueError(f"{side} pages {bad} outside the pool "
                             f"(num_pages {kv.num_pages})")
    si = torch.tensor(sp, dtype=torch.long, device=sdev)
    di = torch.tensor(dp, dtype=torch.long, device=ddev)
    stores = [(src_kv.k_stores, dst_kv.k_stores),
              (src_kv.v_stores, dst_kv.v_stores)]
    if dst_kv.s_stores is not None:
        stores.append((src_kv.s_stores, dst_kv.s_stores))
    for src, dst in stores:
        for layer in range(dst_kv.num_layers):
            # the stores, never the views' temporaries: an advanced-index
            # read of a view is a copy, and a copy into it is lost
            dst[layer].index_copy_(0, di, src[layer].index_select(0, si)
                                   .to(ddev, dst[layer].dtype))
    return n


def _elem_bytes(dtype) -> int:
    """Bytes per element of a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    import numpy as np

    return int(np.dtype(dtype).itemsize)


def plan_kv_pool(model_cfg, page_size: int = 16,
                 hbm_fraction: float = 0.30,
                 trainer_cfg=None, capacity_bytes: Optional[int] = None,
                 dtype_bytes: Optional[int] = None, dtype=None,
                 kv_dtype: str = "fp32") -> dict:
    """Size the KV pool against device memory: capacity
    (``hw.hbm_bytes``, or an explicit override) minus the model's
    planned state bytes (``observability.plan_state_memory``, which
    charges a trainer's params plus AdamW moments, as the JAX package
    does), times ``hbm_fraction``, divided by the per-page cost across
    layers. Returns ``{num_pages, page_bytes, kv_bytes, budget_bytes,
    capacity_bytes, state_bytes, kv_dtype, dtype_bytes,
    scale_page_bytes, scale_bytes}``; ``num_pages`` is ``None`` when the
    device's capacity is unknown (the CPU) and no override was given.

    Per-element bytes come from the pool dtype: ``dtype`` (a torch dtype
    such as ``torch.bfloat16``, or a numpy one), or an explicit
    ``dtype_bytes``, defaulting to 4 (fp32). ``kv_dtype="int8"`` plans 1
    byte per element plus the per-page scale pool (2 fp32 scales per kv
    head per layer)."""
    from ..observability import hw, plan_state_memory

    nh_kv = getattr(model_cfg, "kv_heads", None) or model_cfg.num_heads
    d = model_cfg.head_dim
    layers = model_cfg.num_layers
    if kv_dtype == "int8":
        elem = 1
        scale_page_bytes = layers * 2 * nh_kv * 4  # fp32 K+V scales
    else:
        if dtype_bytes is not None:
            elem = int(dtype_bytes)
        elif dtype is not None:
            elem = _elem_bytes(dtype)
        else:
            elem = 4
        scale_page_bytes = 0
    page_bytes = 2 * layers * page_size * nh_kv * d * elem \
        + scale_page_bytes
    state_bytes = None
    try:
        plan = plan_state_memory(model_cfg, trainer_cfg)
        state_bytes = plan.get("total_per_device_bytes")
    except Exception:
        pass
    cap = capacity_bytes if capacity_bytes is not None else hw.hbm_bytes()
    if cap is None:
        return {"num_pages": None, "page_bytes": page_bytes,
                "kv_bytes": None, "budget_bytes": None,
                "capacity_bytes": None, "state_bytes": state_bytes,
                "kv_dtype": kv_dtype, "dtype_bytes": elem,
                "scale_page_bytes": scale_page_bytes, "scale_bytes": None}
    budget = max(0.0, (cap - (state_bytes or 0))) * float(hbm_fraction)
    num_pages = int(budget // page_bytes)
    if num_pages < 2:
        # a pool needs >= 2 pages (page 0 reserved): the budget does not
        # fit one, so report 0, never a plan that overshoots
        num_pages = 0
    return {"num_pages": num_pages, "page_bytes": page_bytes,
            "kv_bytes": num_pages * page_bytes,
            "budget_bytes": int(budget), "capacity_bytes": int(cap),
            "state_bytes": state_bytes,
            "kv_dtype": kv_dtype, "dtype_bytes": elem,
            "scale_page_bytes": scale_page_bytes,
            "scale_bytes": num_pages * scale_page_bytes}

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
(padding tokens of a prefill) are dropped: each pool's storage carries
one extra row past the last page, and every slot at or past
``num_pages * page_size`` lands there, so the scatter never syncs the
host to filter them.

Unlike the JAX package, whose pools flow functionally through jitted
steps, the port updates the pools **in place** (``index_copy_``): no
copy of the cache is ever made.

Not ported yet: int8 pools (``_requant_pages``), ``copy_pages`` and
``plan_kv_pool``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence

import torch

from ..ops import attention_dispatch as disp

__all__ = ["PagesExhausted", "PagePool", "PagedKVCache",
           "PagedForwardState", "PagedLayerView"]


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


@dataclasses.dataclass
class PagedForwardState:
    """The per-forward paged view threaded through
    ``GPTModel.forward(caches=...)``. Attention layers write through
    :meth:`view`; the pools are updated in place.

    ``mode``: ``"decode"`` (one token per request, the paged kernel),
    ``"prefill_batch"`` (one request per row, trailing pad, plain causal
    attention) or ``"prefill_packed"`` (many requests packed into one
    row, segment-masked attention).
    """

    k_pools: list                      # per layer (P, page_size, nh_kv*d)
    v_pools: list
    k_stores: list                     # per layer (P*page_size + 1, nh_kv*d)
    v_stores: list
    mode: str
    slot_mapping: torch.Tensor         # (T,) int64 flat slots; OOB drops
    num_heads: int
    num_kv_heads: int
    head_dim: int
    page_table: Optional[torch.Tensor] = None  # (B, max_pages) [decode]
    seq_lens: Optional[torch.Tensor] = None    # (B,) int32 incl. new token
    segment_ids: Optional[torch.Tensor] = None  # (B, S) [prefill_packed]

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
        at ``slot_mapping``; padding slots (>= pool size) are dropped."""
        st = self.state
        _scatter_pages(st.k_stores[self.layer], k, st.slot_mapping)
        _scatter_pages(st.v_stores[self.layer], v, st.slot_mapping)

    def attend(self, q, k, v, scale=None):
        """Mode-appropriate attention. ``q`` ``(B, S, nh, d)``; ``k``/
        ``v`` the CURRENT call's keys/values ``(B, S, nh_kv, d)`` (fresh
        prefills attend only themselves; decode reads the pools).
        Returns ``(B, S, nh, d)`` in q's dtype."""
        st = self.state
        b, s, nh, d = q.shape
        kp = st.k_pools[self.layer]
        if st.mode == "decode":
            o = disp.paged_attention(
                q[:, 0].to(kp.dtype).contiguous(), kp,
                st.v_pools[self.layer], st.page_table, st.seq_lens,
                scale=scale)
            return o[:, None].to(q.dtype)
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
    """``store`` (P*ps + 1, hp): a layer's pool storage plus the drop row;
    ``vals`` (B, S, nh_kv, d); ``slots`` (B*S,) int64 flat token slots
    into the ``P*ps`` stream. Slots at or past ``P*ps`` land in the drop
    row (dropped). In place."""
    n, hp = store.shape
    idx = slots.clamp(max=n - 1)
    store.index_copy_(0, idx, vals.reshape(-1, hp).to(store.dtype))
    return store


class PagedKVCache:
    """The pool pair per layer plus its allocator, sized once at engine
    construction on ``device``. ``dtype`` float32 (default) or bfloat16;
    int8 pools are not ported yet."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, dtype=None, device=None):
        dtype = dtype or torch.float32
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"KV pools are float32 or bfloat16, got {dtype}")
        self.num_layers = int(num_layers)
        self.page_size = int(page_size)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.pool = PagePool(num_pages, page_size)
        hp = num_kv_heads * head_dim
        rows = num_pages * page_size

        def store():
            return torch.zeros((rows + 1, hp), dtype=dtype, device=device)

        self.k_stores = [store() for _ in range(num_layers)]
        self.v_stores = [store() for _ in range(num_layers)]
        shape = (num_pages, page_size, hp)
        self.k_pools = [s[:rows].view(shape) for s in self.k_stores]
        self.v_pools = [s[:rows].view(shape) for s in self.v_stores]

    @property
    def num_pages(self) -> int:
        return self.pool.num_pages

    def pool_bytes(self) -> int:
        return int(2 * self.num_layers * self.num_pages * self.page_size
                   * self.num_kv_heads * self.head_dim
                   * torch.finfo(self.dtype).bits // 8)

    def make_state(self, mode: str, slot_mapping, num_heads: int,
                   page_table=None, seq_lens=None,
                   segment_ids=None) -> PagedForwardState:
        return PagedForwardState(
            k_pools=self.k_pools, v_pools=self.v_pools,
            k_stores=self.k_stores, v_stores=self.v_stores, mode=mode,
            slot_mapping=slot_mapping, num_heads=num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            page_table=page_table, seq_lens=seq_lens,
            segment_ids=segment_ids)

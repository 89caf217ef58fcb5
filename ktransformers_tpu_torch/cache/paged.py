"""Paged KV cache on the device and the host-side page allocator
(counterpart of ktransformers_tpu/cache/paged.py; MLA and GQA pools).

Pages are shared across layers by index: page p of layer l is bufs[l][p],
so one page id serves the whole model. Unlike the JAX package the pools are
updated IN PLACE (models/paged.py writes into them); a PagedKVCache is a
handle on buffers, not a value. A hybrid model's GatedDeltaNet layers hold
no pages: their two buffers are O(1) state per slot (``linear_slots`` rows,
the engine's decode-batch slots).

With ``summaries`` every page pool also keeps float32 key summaries a page
for sparse decode (ops/sparse_attention.py): smin / smax [P, R + Dr] (MLA:
the [ckv | k_pe] latent) or [P, Hkv, D] (GQA), and the plane its anchor
reads (ssum for block_mean, sfix for fixed, sdyn for dynamic), one a layer.
models/paged.py updates them in place with every page write;
``reset_page_summaries`` clears recycled pages.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.models.spec import ModelSpec


@dataclasses.dataclass
class PagedKVCache:
    """MLA: bufs_a[l] ckv pages [P, page, R], bufs_b[l] k_pe pages
    [P, page, Dr]. GQA: bufs_a[l] k pages, bufs_b[l] v pages, both
    [P, page, Hkv, D] (k roped). A GatedDeltaNet layer: bufs_a[l] the conv
    tails [slots, K, conv_dim], bufs_b[l] the float32 recurrent states
    [slots, Hv, dk, dv]."""

    bufs_a: list
    bufs_b: list
    page_size: int = 64
    linear_layers: tuple = ()  # layers whose buffers are slot state
    # per-page key summaries for sparse decode, a list of one tensor a
    # layer each, or None (dense only)
    smin: list | None = None
    smax: list | None = None
    ssum: list | None = None
    sfix: list | None = None
    sdyn: list | None = None

    PLANES = ("smin", "smax", "ssum", "sfix", "sdyn")
    FILL = {"smin": torch.inf, "smax": -torch.inf}

    def planes(self, li: int) -> dict | None:
        """Layer li's summary planes by name (the present ones), or None
        without summaries."""
        names = [n for n in self.PLANES if getattr(self, n) is not None]
        return {n: getattr(self, n)[li] for n in names} if names else None

    @property
    def paged_layers(self) -> list:
        """Indices of the layers whose buffers are page pools."""
        return [li for li in range(len(self.bufs_a))
                if li not in self.linear_layers]

    @property
    def num_pages(self) -> int:
        return self.bufs_a[self.paged_layers[0]].shape[0]

    @staticmethod
    def create(spec: ModelSpec, num_pages: int, page_size: int = 64,
               dtype=torch.bfloat16, summaries: bool = False,
               device="cuda", linear_slots: int = 8,
               anchor: str = "quest") -> "PagedKVCache":
        """Zeroed pools; with ``summaries`` the smin / smax planes (+inf /
        -inf) and, for ``anchor`` block_mean / fixed / dynamic, its zeroed
        ssum / sfix / sdyn plane."""
        a = spec.attention
        if summaries and spec.hybrid:
            raise ValueError("sparse page summaries with hybrid "
                             "linear-attention layers: not supported "
                             "together (as in the JAX package)")
        if a.kind == "mla":
            sa = (num_pages, page_size, a.kv_lora_rank)
            sb = (num_pages, page_size, a.qk_rope_head_dim)
            sp = (num_pages, a.kv_lora_rank + a.qk_rope_head_dim)
        else:
            sa = sb = (num_pages, page_size, a.num_kv_heads, a.head_dim)
            sp = (num_pages, a.num_kv_heads, a.head_dim)
        bufs_a, bufs_b, linear = [], [], []
        for li in range(spec.num_layers):
            if spec.layer_kind(li) == "linear":
                la = spec.linear_attn
                linear.append(li)
                bufs_a.append(torch.zeros(
                    (linear_slots, la.conv_kernel, la.conv_dim), dtype=dtype,
                    device=device))
                bufs_b.append(torch.zeros(
                    (linear_slots, la.num_v_heads, la.head_k_dim,
                     la.head_v_dim), dtype=torch.float32, device=device))
            else:
                bufs_a.append(torch.zeros(sa, dtype=dtype, device=device))
                bufs_b.append(torch.zeros(sb, dtype=dtype, device=device))
        wanted = ()
        if summaries:
            wanted = ("smin", "smax") + tuple(
                n for n, kind in (("ssum", "block_mean"), ("sfix", "fixed"),
                                  ("sdyn", "dynamic")) if anchor == kind)
        planes = {n: [torch.full(sp, PagedKVCache.FILL.get(n, 0.0),
                                 dtype=torch.float32, device=device)
                      for _ in range(spec.num_layers)] for n in wanted}
        return PagedKVCache(bufs_a=bufs_a, bufs_b=bufs_b,
                            page_size=page_size, linear_layers=tuple(linear),
                            **planes)

    def reset_page_summaries(self, pids) -> "PagedKVCache":
        """Clear the summaries of freshly (re)allocated pages in place: a
        previous occupant's extremes would loosen the selection bounds.
        Returns self."""
        if self.smin is None:
            return self
        idx = torch.as_tensor(list(pids), dtype=torch.int64,
                              device=self.smin[0].device)
        for n in self.PLANES:
            for plane in getattr(self, n) or ():
                plane[idx] = self.FILL.get(n, 0.0)
        return self

    def bytes_per_page(self) -> int:
        """Bytes one page id holds over all paged layers (both pools)."""
        per_page = 0
        for li in self.paged_layers:
            a, b = self.bufs_a[li], self.bufs_b[li]
            per_page += (a[0].numel() * a.element_size()
                         + b[0].numel() * b.element_size())
        return per_page

    def state_bytes(self) -> int:
        """Bytes of the linear layers' slot state (conv tails and
        recurrent states, every slot)."""
        return sum(self.bufs_a[li].numel() * self.bufs_a[li].element_size()
                   + self.bufs_b[li].numel() * self.bufs_b[li].element_size()
                   for li in self.linear_layers)


class PageAllocator:
    """Host-side free-list allocator with refcounts (prefix-cache pages are
    shared across queries).

    ``reserved`` pages at the front are never handed out. The serving
    engine reserves page 0 as a trash page: inactive padding rows of the
    fixed-shape decode batch write their KV through a zero page table, and
    those writes must land where no live query reads."""

    def __init__(self, num_pages: int, reserved: int = 0, on_alloc=None):
        self.num_pages = num_pages
        self.reserved = reserved
        self._free = list(range(num_pages - 1, reserved - 1, -1))
        self._refs = [0] * num_pages
        # callback(list[int]) on every allocation
        self.on_alloc = on_alloc

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        if len(self._free) < n:
            raise MemoryError(
                f"KV page pool exhausted ({n} requested, "
                f"{len(self._free)} free)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        if self.on_alloc is not None:
            self.on_alloc(pages)
        return pages

    def retain(self, pages: list[int]) -> None:
        for p in pages:
            if self._refs[p] <= 0:
                raise RuntimeError(f"retain of free page {p}")
            self._refs[p] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            if self._refs[p] <= 0:
                raise RuntimeError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return self._refs[page]

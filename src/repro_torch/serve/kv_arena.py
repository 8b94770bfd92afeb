"""Statically-planned paged KV arena for serving — the counterpart of
``repro.serve.kv_arena``, with the same layout, the same page tables and
the same allocation order.

Instead of one dense ``(batch_slots, max_len, ...)`` buffer per cache leaf,
the arena stores fixed-size **pages** in flat per-dtype planes and gives
each decode slot a **page table**:

* A *plane* is one ``(num_pages + 1, page_elems)`` tensor per dtype
  (bf16/f32 KV, int8 payloads and their bf16 scales land in separate
  planes).  Its last row is the *null row* (below).
* A *page* is ``page_size`` tokens' worth of every time-indexed cache leaf,
  packed back-to-back at static offsets inside the page row.  One page id
  is meaningful in every plane at once, so one page table per slot serves
  every leaf.

Cache leaves are classified by *probing* ``model.cache_specs`` (``meta``
tensors): a leaf whose extent grows by one page when ``max_len`` does is
**paged** on that (time) axis; any other (a rolling sliding-window cache,
which saturates at the window) is **resident**, one page per slot,
rewritten wholesale every step.

Allocation lives on the host in :class:`PagePool` (a LIFO free list, so
the page tables equal the reference's); device access is three functions:
:func:`gather_caches` (page tables -> the dense batched caches that
``decode_step`` takes), :func:`scatter_step` (persist each slot's one
written token row, plus the residents) and :func:`build_insert_fn` (copy a
prefilled per-request cache into freshly allocated pages).  They write the
planes in place, where the reference donates its buffers.

Unallocated table entries hold the sentinel ``num_pages``.  The reference
reads it with ``jnp.take(mode="fill")`` (zeros) and drops writes to it.
Here it indexes the planes' null row, which is zero, so a gather of an
unallocated page reads exact zeros and never goes out of bounds.  Writes
to it (inactive slots, the null-padded tail of an insert) may collide, so
each scatter and insert writes it and then zeroes it again: no boolean
mask, so no host synchronisation.  ``KVArena.nbytes`` counts the
``num_pages`` real rows only, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device


def tree_flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()
                 ) -> tuple[list[Any], tuple[tuple[str, ...], ...]]:
    """Leaves of a nested dict in ``jax.tree_util.tree_flatten`` order
    (keys sorted at every level), and their key paths."""
    leaves, paths = [], []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            sub, sub_paths = tree_flatten(v, prefix + (k,))
            leaves += sub
            paths += sub_paths
        else:
            leaves.append(v)
            paths.append(prefix + (k,))
    return leaves, tuple(paths)


def tree_unflatten(paths: Sequence[tuple[str, ...]], leaves: Sequence[Any]) -> dict:
    """The nested dict of :func:`tree_flatten`'s ``paths`` and ``leaves``."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class CacheLeaf:
    """Static placement of one cache leaf in the arena.

    ``shape`` is the per-slot shape (batch axis removed) at the arena's
    logical length; ``time_axis`` indexes into ``shape`` (``None`` =
    resident).  ``offset``/``numel`` address the leaf's segment inside a
    page row of its plane: for paged leaves ``numel`` is one
    ``page_size``-token chunk, for residents the whole per-slot state.
    """

    name: str
    shape: tuple[int, ...]
    dtype: str
    batch_axis: int
    time_axis: int | None
    plane: int
    offset: int
    numel: int

    @property
    def paged(self) -> bool:
        return self.time_axis is not None


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """Static page/plane layout for one model's serving caches.

    ``tokens`` is the arena's logical length (``max_len`` rounded up to a
    page multiple); every paged leaf's time axis has that extent.
    ``leaves`` follows :func:`tree_flatten` order, and ``treedef`` holds
    their key paths, to rebuild the cache tree.
    """

    page_size: int
    tokens: int
    pages_per_slot: int
    plane_dtypes: tuple[str, ...]
    plane_elems: tuple[int, ...]
    leaves: tuple[CacheLeaf, ...]
    treedef: tuple[tuple[str, ...], ...]

    @property
    def num_planes(self) -> int:
        return len(self.plane_dtypes)

    @property
    def has_paged(self) -> bool:
        return any(l.paged for l in self.leaves)

    @property
    def has_resident(self) -> bool:
        return any(not l.paged for l in self.leaves)

    def token_pages(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache rows (0 for a model
        with resident state only)."""
        if not self.has_paged or n_tokens <= 0:
            return 0
        return -(-int(n_tokens) // self.page_size)

    def pages_per_request(self, n_tokens: int) -> int:
        """Total pages a request holding ``n_tokens`` occupies (token pages
        plus the single resident page, when the model has resident state)."""
        return self.token_pages(n_tokens) + (1 if self.has_resident else 0)

    def page_bytes(self) -> int:
        return sum(w * _torch_dtype(d).itemsize
                   for w, d in zip(self.plane_elems, self.plane_dtypes))


def plan_kv_layout(
    cache_spec_fn: Callable[[int, int], Any],
    max_len: int,
    page_size: int,
) -> KVLayout:
    """Probe ``cache_spec_fn(batch, max_len)`` (a tree whose leaves have
    ``shape`` and ``dtype``, such as ``meta`` tensors) and compute the
    static layout.

    Classification is structural: the batch axis is the axis that moves
    when ``batch`` does, the time axis the one that grows by exactly one
    page when ``max_len`` grows by ``page_size``.  Leaves with no such axis
    become residents.
    """
    page_size = int(page_size)
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    tokens = -(-int(max_len) // page_size) * page_size
    base, paths = tree_flatten(cache_spec_fn(1, tokens))
    wide, _ = tree_flatten(cache_spec_fn(2, tokens))
    long, _ = tree_flatten(cache_spec_fn(1, tokens + page_size))

    plane_of: dict[str, int] = {}
    plane_dtypes: list[str] = []
    tok_elems: list[int] = []  # per-plane token-page row width
    res_elems: list[int] = []  # per-plane resident row width
    leaves: list[CacheLeaf] = []

    for path, spec, w_spec, l_spec in zip(paths, base, wide, long):
        name = "/".join(path)
        s, ws, ls = tuple(spec.shape), tuple(w_spec.shape), tuple(l_spec.shape)
        b_axes = [i for i, (a, b) in enumerate(zip(s, ws)) if a != b]
        if len(b_axes) != 1 or ws[b_axes[0]] - s[b_axes[0]] != 1:
            raise ValueError(
                f"cache leaf {name}: cannot identify batch axis ({s} vs {ws})")
        batch_axis = b_axes[0]
        t_axes = [i for i, (a, b) in enumerate(zip(s, ls)) if a != b]
        if len(t_axes) > 1:
            raise ValueError(
                f"cache leaf {name}: multiple axes track max_len ({s} vs {ls})")
        shape = tuple(d for i, d in enumerate(s) if i != batch_axis)
        time_axis = None
        if t_axes and ls[t_axes[0]] - s[t_axes[0]] == page_size:
            time_axis = t_axes[0] - (1 if batch_axis < t_axes[0] else 0)

        dt = _dtype_name(spec.dtype)
        if dt not in plane_of:
            plane_of[dt] = len(plane_dtypes)
            plane_dtypes.append(dt)
            tok_elems.append(0)
            res_elems.append(0)
        p = plane_of[dt]
        if time_axis is not None:
            chunk = list(shape)
            chunk[time_axis] = page_size
            numel = int(np.prod(chunk, dtype=np.int64))
            offset = tok_elems[p]
            tok_elems[p] += numel
        else:
            numel = int(np.prod(shape, dtype=np.int64)) if shape else 1
            offset = res_elems[p]
            res_elems[p] += numel
        leaves.append(CacheLeaf(
            name=name, shape=shape, dtype=dt, batch_axis=batch_axis,
            time_axis=time_axis, plane=p, offset=offset, numel=numel,
        ))

    return KVLayout(
        page_size=page_size,
        tokens=tokens,
        pages_per_slot=tokens // page_size,
        plane_dtypes=tuple(plane_dtypes),
        plane_elems=tuple(max(t, r) for t, r in zip(tok_elems, res_elems)),
        leaves=tuple(leaves),
        treedef=paths,
    )


# ---------------------------------------------------------------------------
# page allocation (host side, pure Python)
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list page allocator.  Deterministic (LIFO reuse) so serving runs
    are reproducible; allocation is all-or-nothing per request."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        self._used: set[int] = set()

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Allocate ``n`` pages, or ``None`` (and no state change) if fewer
        than ``n`` are free."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        return out

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p not in self._used:
                raise ValueError(f"double free / foreign page {p}")
            self._used.remove(p)
            self._free.append(p)


# ---------------------------------------------------------------------------
# device-side access (planes + tables, written in place)
# ---------------------------------------------------------------------------


def _chunk_shape(leaf: CacheLeaf, page_size: int) -> tuple[int, ...]:
    chunk = list(leaf.shape)
    chunk[leaf.time_axis] = page_size
    return tuple(chunk)


def _segment(plane: torch.Tensor, leaf: CacheLeaf, inner=None) -> torch.Tensor:
    """The leaf's columns of every row of ``plane``: a view, split into
    ``inner`` per row when given."""
    seg = plane[:, leaf.offset:leaf.offset + leaf.numel]
    return seg if inner is None else seg.view((plane.shape[0],) + tuple(inner))


def _batched(x: torch.Tensor, leaf: CacheLeaf) -> torch.Tensor:
    """A cache leaf with its batch axis moved to the front: (S, *shape)."""
    return torch.movedim(x, leaf.batch_axis, 0)


def _zero_null_rows(planes: Sequence[torch.Tensor]) -> None:
    for plane in planes:
        plane[-1].zero_()


@torch.inference_mode()
def gather_caches(layout: KVLayout, planes: Sequence[torch.Tensor],
                  page_tbl: torch.Tensor, resident_tbl: torch.Tensor) -> dict:
    """The dense batched cache tree that ``decode_step`` takes, each slot's
    rows read through its page table.  Unallocated entries read the zero
    null row, which the decode masks discard.

    ``page_tbl``: (slots, pages_per_slot) int; ``resident_tbl``: (slots,).
    """
    S = page_tbl.shape[0]
    ps, P = layout.page_size, layout.pages_per_slot
    flat_ids = page_tbl.reshape(-1)
    out = []
    for leaf in layout.leaves:
        seg = _segment(planes[leaf.plane], leaf)
        if not leaf.paged:
            x = seg.index_select(0, resident_tbl).view((S,) + leaf.shape)
            out.append(torch.movedim(x, 0, leaf.batch_axis).contiguous())
            continue
        rows = seg.index_select(0, flat_ids).view((S, P) + _chunk_shape(leaf, ps))
        # dims of rows: 0 = slot, 1 = page, 2 + j = the chunk's dim j; put
        # the slot at the batch axis and each page before its rows, then
        # merge (page, row) into the time axis: one copy
        order = []
        for j in range(len(leaf.shape)):
            order += [1, 2 + j] if j == leaf.time_axis else [2 + j]
        order.insert(leaf.batch_axis, 0)
        full = list(leaf.shape)
        full.insert(leaf.batch_axis, S)
        out.append(rows.permute(order).reshape(full))
    return tree_unflatten(layout.treedef, out)


@torch.inference_mode()
def scatter_step(layout: KVLayout, planes: Sequence[torch.Tensor],
                 page_tbl: torch.Tensor, resident_tbl: torch.Tensor,
                 caches: Mapping, pos: torch.Tensor) -> Sequence[torch.Tensor]:
    """Persist one decode step into the planes, in place: for each slot,
    the single token row written at ``pos`` (paged leaves) and the whole
    resident state (rewritten from zeros).  A slot whose table entry is the
    sentinel writes the null row, which is zeroed again after."""
    S = page_tbl.shape[0]
    ps = layout.page_size
    vals, _ = tree_flatten(caches)
    page_ids = torch.gather(page_tbl, 1, torch.div(pos, ps, rounding_mode="floor")[:, None])[:, 0]
    within = torch.remainder(pos, ps)
    s_idx = torch.arange(S, device=pos.device)
    for p, plane in enumerate(planes):
        res = []
        for lf, v in zip(layout.leaves, vals):
            if lf.plane != p:
                continue
            if not lf.paged:
                res.append((lf, v))
                continue
            # (S, T, *rest) -> the row each slot wrote, (S, *rest)
            tok = torch.movedim(_batched(v, lf), 1 + lf.time_axis, 1)[s_idx, pos]
            seg = _segment(plane, lf, _chunk_shape(lf, ps))
            seg[(page_ids,) + (slice(None),) * lf.time_axis + (within,)] = tok.to(plane.dtype)
        if res:
            rows = torch.zeros((S, plane.shape[1]), dtype=plane.dtype, device=plane.device)
            for lf, v in res:
                _segment(rows, lf).copy_(_batched(v, lf).reshape(S, lf.numel))
            plane[resident_tbl] = rows
    _zero_null_rows(planes)
    return planes


def build_insert_fn(layout: KVLayout):
    """The insert stage: copy a prefilled per-request cache (batch 1, dense
    at the arena's logical length) into freshly allocated pages, in place.
    Whole page rows are rebuilt from zeros, so slot reuse can never leak a
    previous request's state.  ``page_ids`` is null-padded to
    ``pages_per_slot``; ``resident_id`` is a 1-element tensor."""
    ps, P = layout.page_size, layout.pages_per_slot

    @torch.inference_mode()
    def insert(planes, pcache, page_ids, resident_id):
        vals, _ = tree_flatten(pcache)
        for p, plane in enumerate(planes):
            paged = [(lf, v) for lf, v in zip(layout.leaves, vals)
                     if lf.plane == p and lf.paged]
            res = [(lf, v) for lf, v in zip(layout.leaves, vals)
                   if lf.plane == p and not lf.paged]
            W = plane.shape[1]
            if paged:
                rows = torch.zeros((P, W), dtype=plane.dtype, device=plane.device)
                for lf, v in paged:
                    x = _batched(v, lf)[0]  # per-slot
                    t = lf.time_axis
                    x = x.reshape(lf.shape[:t] + (P, ps) + lf.shape[t + 1:])
                    _segment(rows, lf).copy_(torch.movedim(x, t, 0).reshape(P, lf.numel))
                plane[page_ids] = rows
            if res:
                row = torch.zeros((1, W), dtype=plane.dtype, device=plane.device)
                for lf, v in res:
                    _segment(row, lf).copy_(_batched(v, lf).reshape(1, lf.numel))
                plane[resident_id] = row
        _zero_null_rows(planes)
        return planes

    return insert


# ---------------------------------------------------------------------------
# the arena object (planes + tables + pool)
# ---------------------------------------------------------------------------


class KVArena:
    """Mutable serving arena: device planes, host page tables, page pool.

    The sentinel for "no page" is ``num_pages``: the index of each plane's
    zero null row (module docstring).
    """

    def __init__(self, layout: KVLayout, num_pages: int, num_slots: int, *,
                 device="cuda"):
        self.layout = layout
        self.num_pages = int(num_pages)
        self.num_slots = int(num_slots)
        self.null = self.num_pages
        self.device = resolve_device(device)
        self.pool = PagePool(num_pages)
        self.planes = [
            torch.zeros((self.num_pages + 1, w), dtype=_torch_dtype(d), device=self.device)
            for w, d in zip(layout.plane_elems, layout.plane_dtypes)
        ]
        self.page_tbl = np.full((num_slots, layout.pages_per_slot), self.null, np.int64)
        self.resident_tbl = np.full((num_slots,), self.null, np.int64)
        self._slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self._slot_resident: list[int | None] = [None] * num_slots

    @classmethod
    def auto_pages(cls, layout: KVLayout, num_slots: int) -> int:
        """Pool size at which admission can never starve: every slot can
        hold a full-length request simultaneously."""
        per_slot = layout.pages_per_slot * (1 if layout.has_paged else 0)
        per_slot += 1 if layout.has_resident else 0
        return max(1, num_slots * per_slot)

    def nbytes(self) -> int:
        """The pages' bytes (the null row is not counted)."""
        return self.num_pages * self.layout.page_bytes()

    # ---- slot lifecycle ---------------------------------------------------
    def acquire_slot(self, slot: int, n_tokens: int) -> bool:
        """Allocate the pages a fresh request needs (token pages for the
        prompt + the resident page).  All-or-nothing; False = not enough
        free pages, nothing changed."""
        n_tok = self.layout.token_pages(n_tokens)
        n_res = 1 if self.layout.has_resident else 0
        pages = self.pool.alloc(n_tok + n_res)
        if pages is None:
            return False
        if n_res:
            self._slot_resident[slot] = pages[0]
            self.resident_tbl[slot] = pages[0]
        tok_pages = pages[n_res:]
        self._slot_pages[slot] = tok_pages
        self.page_tbl[slot, :] = self.null
        self.page_tbl[slot, :len(tok_pages)] = tok_pages
        return True

    def extend_slot(self, slot: int) -> bool:
        """Grow a slot by one token page (generate crossed a page
        boundary).  False = pool exhausted (caller truncates)."""
        got = self.pool.alloc(1)
        if got is None:
            return False
        i = len(self._slot_pages[slot])
        self._slot_pages[slot].append(got[0])
        self.page_tbl[slot, i] = got[0]
        return True

    def page_for(self, slot: int, pos: int) -> bool:
        """Ensure the page covering position ``pos`` exists (allocating at
        most one — positions advance a token at a time)."""
        if not self.layout.has_paged:
            return True
        idx = pos // self.layout.page_size
        if idx < len(self._slot_pages[slot]):
            return True
        if idx != len(self._slot_pages[slot]):
            raise AssertionError(f"slot {slot}: non-contiguous page demand {idx}")
        return self.extend_slot(slot)

    def release_slot(self, slot: int) -> None:
        pages = list(self._slot_pages[slot])
        if self._slot_resident[slot] is not None:
            pages.append(self._slot_resident[slot])
        if pages:
            self.pool.free(pages)
        self._slot_pages[slot] = []
        self._slot_resident[slot] = None
        self.page_tbl[slot, :] = self.null
        self.resident_tbl[slot] = self.null

    # ---- device-table views -------------------------------------------
    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The page and resident tables on the device, in one transfer."""
        host = np.concatenate([self.page_tbl, self.resident_tbl[:, None]], axis=1)
        dev = torch.from_numpy(host).to(self.device)
        return dev[:, :-1], dev[:, -1]

    def insert_ids(self, slot: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Null-padded page-id vector + resident id for the insert stage,
        in one transfer."""
        ids = np.full((self.layout.pages_per_slot + 1,), self.null, np.int64)
        tok = self._slot_pages[slot]
        ids[:len(tok)] = tok
        rid = self._slot_resident[slot]
        if rid is not None:
            ids[-1] = rid
        dev = torch.from_numpy(ids).to(self.device)
        return dev[:-1], dev[-1:]


__all__ = [
    "CacheLeaf",
    "KVArena",
    "KVLayout",
    "PagePool",
    "build_insert_fn",
    "gather_caches",
    "plan_kv_layout",
    "scatter_step",
    "tree_flatten",
    "tree_unflatten",
]

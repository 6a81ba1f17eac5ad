"""Block-paged KV-cache accounting: the host-side page allocator.

The port's own copy of the reference's ``tpushare/workloads/paging.py``
(stdlib-only there too; the port imports nothing from ``tpushare``), so
the two engines share one set of paging semantics by construction:

- :class:`PageAllocator` — free-list page pool with per-owner block
  tables: alloc on prefill/decode-growth (``ensure``), recycle on
  retire/shed/quarantine (``release``), double-free and leak detection,
  occupancy/fragmentation accounting, reference-counted sharing and the
  transactional install/copy phases later slices use;
- page math (:func:`pages_for_rows`, :func:`rows_for_pages`,
  :func:`page_hbm_mib`, :func:`forecast_request_pages`, ...) — the one
  definition of what a page costs, shared by the admission forecast, the
  engine and the payload's pool sizing.

The device-side pool layout ``(L, n_pages, page_size, Hkv, hd)`` and the
block-table writes live in ``decode.py`` / ``ops/paged_attention.py``;
``serving.PagedServingEngine`` wires both halves together.
"""

from __future__ import annotations

from typing import Any

from tpushare_torch import consts
from tpushare_torch.workloads.overload import kv_cost_mib

__all__ = ["PagingError", "PagePoolExhausted", "PageAllocator",
           "pages_for_rows", "rows_for_pages", "kv_bytes_per_el",
           "kv_bytes_per_token", "page_hbm_mib",
           "pool_hbm_mib", "pages_for_hbm", "forecast_request_pages",
           "forecast_subscriber_pages", "eager_subscriber_pages"]

# the pool storage codecs (consts owns the tuple: the telemetry rider and
# the daemon sanitizer validate against the same values)
KV_CODECS = consts.KV_CODECS


class PagingError(ValueError):
    """Allocator contract violation: double-free, unknown owner, or a
    rows/pages figure that cannot be satisfied by construction. These are
    caller bugs — load problems raise :class:`PagePoolExhausted`."""


class PagePoolExhausted(RuntimeError):
    """The free list cannot cover an allocation. Carries the shortfall so
    the engine can pick a victim (or the admission gate can defer) with
    evidence instead of guesswork."""

    def __init__(self, message: str, needed: int = 0, free: int = 0) -> None:
        super().__init__(message)
        self.needed = int(needed)
        self.free = int(free)


def pages_for_rows(rows: int, page_size: int) -> int:
    """Pages needed to hold ``rows`` cache rows (ceil division) — THE
    rows->pages conversion (lint TPS011)."""
    if page_size < 1:
        raise PagingError(f"page_size {page_size} must be >= 1")
    if rows < 0:
        raise PagingError(f"rows {rows} must be >= 0")
    return -(-rows // page_size)


def rows_for_pages(pages: int, page_size: int) -> int:
    """Cache rows ``pages`` pages hold — the inverse conversion."""
    if page_size < 1:
        raise PagingError(f"page_size {page_size} must be >= 1")
    return pages * page_size


def page_rounded_rows(rows: int, page_size: int) -> int:
    """``rows`` rounded up to a whole number of pages — THE scratch
    sizing rule for page-installed prefills (registration and admission
    must agree on it, so it lives here with the other conversions)."""
    return rows_for_pages(pages_for_rows(rows, page_size), page_size)


def _check_shards(shards: int) -> int:
    """Validate a shard count (the tp*pp degree of a sharded pool).
    Every per-chip HBM figure in this module divides by it HERE — lint
    TPS011's discipline extends to sharding: a raw ``/ tp`` at a call
    site would hardcode a second definition of what one chip holds."""
    if not isinstance(shards, int) or shards < 1:
        raise PagingError(f"shards {shards!r} must be an int >= 1")
    return shards


def kv_bytes_per_el(codec: str, head_dim: int, shards: int = 1) -> float:
    """Effective HBM bytes per stored K/V ELEMENT under ``codec``,
    scale-plane overhead included — THE bytes-per-element definition
    (lint TPS011) every page/HBM conversion routes through:

    - ``"bf16"``: 2 bytes, no sidecar;
    - ``"int8"``: 1 byte per element plus one fp32 scale per
      (position, head) row of ``head_dim`` elements -> 1 + 4/head_dim.

    ``shards`` is the tp*pp degree of a SHARDED pool (multi-chip
    serving): every element lives on exactly one chip, so the PER-CHIP
    cost of one global element is 1/shards of the figure — a tp=4 pool
    charges each chip a quarter. Page/row FORECASTS stay in global page
    units regardless (pages are whole across shards; only their bytes
    split).

    Deriving the equal-HBM page budget, the admission math, the
    telemetry bytes-per-token rider, and the bench sizing from this one
    function is what makes them agree by construction."""
    if codec not in KV_CODECS:
        raise PagingError(f"kv codec {codec!r} not in {KV_CODECS}")
    if head_dim < 1:
        raise PagingError(f"head_dim {head_dim} must be >= 1")
    per_el = (1.0 + 4.0 / head_dim) if codec == "int8" else 2.0
    return per_el / _check_shards(shards)


def kv_bytes_per_token(n_layers: int, kv_heads: int, head_dim: int,
                       codec: str = "bf16", shards: int = 1) -> float:
    """HBM bytes ONE cache row (one token position) costs across every
    layer, K and V both, under ``codec`` — the figure the telemetry
    rider reports (consts.TELEMETRY_KV_BYTES_PER_TOKEN) and `top`
    renders, so operators can read a pool's packing density without
    re-deriving the layout. ``shards`` > 1 reports the PER-CHIP cost of
    a sharded pool's row."""
    return (2 * n_layers * kv_heads * head_dim
            * kv_bytes_per_el(codec, head_dim, shards))


def page_hbm_mib(page_size: int, n_layers: int, kv_heads: int,
                 head_dim: int, codec: str = "bf16",
                 shards: int = 1) -> float:
    """HBM cost (MiB) of ONE page across every layer, K and V both —
    defined through overload.kv_cost_mib so the paged and slot admission
    forecasts share one row-cost definition, with the bytes-per-element
    factor routed through :func:`kv_bytes_per_el` (lint TPS011).
    ``shards`` > 1 gives the PER-CHIP slice of a sharded pool's page."""
    return kv_cost_mib(n_layers, kv_heads, head_dim, page_size,
                       kv_bytes_per_el(codec, head_dim, shards))


def pool_hbm_mib(n_pages: int, page_size: int, n_layers: int,
                 kv_heads: int, head_dim: int,
                 codec: str = "bf16", shards: int = 1) -> float:
    """HBM cost (MiB) of the whole page pool — what the pool claims at
    engine construction, the figure an equal-HBM A/B holds constant.
    ``shards`` > 1 is the PER-CHIP claim of a tp×pp-sharded pool (the
    telemetry kv_pool_shard_mib rider and the per-chip gauge read
    exactly this)."""
    return n_pages * page_hbm_mib(page_size, n_layers, kv_heads, head_dim,
                                  codec, shards)


def pages_for_hbm(hbm_mib: float, page_size: int, n_layers: int,
                  kv_heads: int, head_dim: int,
                  codec: str = "bf16", shards: int = 1) -> int:
    """Pages an ``hbm_mib`` budget buys under ``codec`` (floor — a pool
    must never exceed the budget): the inverse of :func:`pool_hbm_mib`
    and THE equal-HBM sizing rule for codec A/Bs. An int8 pool gets
    ~2x the bf16 page count at the same budget — that surplus is the
    admitted-concurrency headroom the codec exists for. With
    ``shards`` > 1 the budget is PER CHIP and the answer is the global
    page count a tp×pp pool can hold at that per-chip budget."""
    if hbm_mib < 0:
        raise PagingError(f"hbm_mib {hbm_mib} must be >= 0")
    per_page = page_hbm_mib(page_size, n_layers, kv_heads, head_dim,
                            codec, shards)
    return int(hbm_mib / per_page)


def forecast_request_pages(prompt_rows: int, max_new: int, page_size: int,
                           lane_rows: int,
                           decode_fraction: float = 1.0,
                           spec_tail_rows: int = 0) -> int:
    """Admission forecast in PAGES: prompt pages + expected decode
    pages, capped at the lane's row bound. ``decode_fraction`` discounts
    the decode tail for loads that reliably stop early (eos-heavy
    traffic) — 1.0 is the safe no-overcommit forecast.
    ``spec_tail_rows`` charges the speculative-round scratch tail (a
    draft-and-verify round transiently writes k+1 rows past the live
    length before rejection truncates them back): an engine carrying a
    draft model passes k+1 so the gate's promise covers the round's
    transient peak, not just the final transcript."""
    if not 0.0 < decode_fraction <= 1.0:
        raise PagingError(f"decode_fraction {decode_fraction} must be in "
                          "(0, 1]")
    if spec_tail_rows < 0:
        raise PagingError(f"spec_tail_rows {spec_tail_rows} must be >= 0")
    expected = (prompt_rows + int(-(-max_new * decode_fraction // 1))
                + spec_tail_rows)
    return pages_for_rows(min(lane_rows, expected), page_size)


def forecast_subscriber_pages(prefix_rows: int, prompt_rows: int,
                              max_new: int, page_size: int,
                              lane_rows: int,
                              decode_fraction: float = 1.0,
                              spec_tail_rows: int = 0) -> int:
    """Admission forecast for a request SUBSCRIBING to a shared prefix:
    the pages its whole span (prefix + prompt + expected decode) needs,
    minus the FULL prefix pages it aliases instead of owning. The
    prefix's partial tail page (when ``prefix_rows`` doesn't land on a
    page boundary) is charged to the subscriber — its first suffix
    write copies that page private (copy-on-write at the page
    boundary), so the private-page bill is honest. This is THE charging
    rule (lint TPS011): forecasting a subscriber at full price would
    surrender exactly the admitted-concurrency win sharing exists
    for."""
    if prefix_rows < 0:
        raise PagingError(f"prefix_rows {prefix_rows} must be >= 0")
    span = forecast_request_pages(prefix_rows + prompt_rows, max_new,
                                  page_size, lane_rows, decode_fraction,
                                  spec_tail_rows)
    return span - prefix_rows // page_size


def eager_subscriber_pages(prefix_rows: int, prompt_rows: int,
                           page_size: int) -> int:
    """Pages admission must TAKE at admit time for a prefix subscriber
    (decode growth stays lazy): the padded span's pages net of the FULL
    prefix pages the lane only references. The eager half of
    ``forecast_subscriber_pages``'s charging rule, kept beside it so
    gate and forecast can never drift; ``prefix_rows == 0`` degrades to
    the plain prompt charge."""
    if prefix_rows < 0:
        raise PagingError(f"prefix_rows {prefix_rows} must be >= 0")
    return (pages_for_rows(prefix_rows + prompt_rows, page_size)
            - prefix_rows // page_size)


class PageAllocator:
    """Free-list allocator over ``n_pages`` fixed-size pages.

    Page 0 (the ``reserved`` prefix) is never handed out: the device
    block tables of retired lanes are zeroed, so their dead-lane writes
    land in the reserved trash page instead of a page another request
    now owns. Owners are opaque hashable keys (the engine uses lane
    indexes; the prefix registry uses its own pin keys).

    Pages are REFERENCE-COUNTED: ``ensure`` allocates at refcount 1,
    ``share`` splices already-allocated pages into another owner's
    table (refcount up — the shared-prefix cache), ``release``
    decrements and recycles only pages whose last reference dropped,
    and ``private_copy`` swaps one shared table entry for a fresh
    private page (the host half of copy-on-write — the engine
    device-copies the bytes, then commits the swapped table).

    Accounting invariants (asserted by the jax-free suite):
    - an allocated page's refcount equals the number of tables holding
      it; a page is free exactly when its refcount is 0;
    - the reserved trash prefix can never be shared, copied, or freed;
    - ``release`` of an unknown owner and any internal double-free raise
      :class:`PagingError` — never silent corruption;
    - ``free_pages + pages_in_use == usable_pages`` at all times
      (``pages_in_use`` is PHYSICAL — a page shared five ways counts
      once, so per-owner occupancy never double-counts shared pages);
    - after every owner releases, ``leaked() == 0``.
    """

    def __init__(self, n_pages: int, page_size: int,
                 reserved: int = 1) -> None:
        if page_size < 1:
            raise PagingError(f"page_size {page_size} must be >= 1")
        if reserved < 0:
            raise PagingError(f"reserved {reserved} must be >= 0")
        if n_pages <= reserved:
            raise PagingError(f"n_pages {n_pages} must exceed the "
                              f"reserved prefix {reserved}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.reserved = reserved
        # LIFO free list: recently-recycled pages are re-issued first
        # (their rows are the likeliest still resident in any cache
        # hierarchy between host and HBM)
        self._free: list[int] = list(range(n_pages - 1, reserved - 1, -1))
        self._free_set: set[int] = set(self._free)
        self._tables: dict[object, list[int]] = {}
        self._rows: dict[object, int] = {}
        # page -> reference count (present exactly while allocated)
        self._refs: dict[int, int] = {}
        # owner -> page ids spliced in via share() and not yet privatized
        # (the engine's CoW guard asks which table entries are writable)
        self._shared: dict[object, set[int]] = {}
        # counters the engine folds into stats/telemetry
        self.allocs = 0
        self.recycled = 0
        self.shares = 0
        self.peak_in_use = 0
        # cross-pool handoff (salvage) accounting: committed installs
        # vs aborted ones — a failover storm's leak audit reads these
        # to prove every reserved destination either became a table or
        # went back to the free list (docs/ROBUSTNESS.md "Fleet fault
        # tolerance")
        self.installs = 0
        self.install_aborts = 0

    # ---- capacity views ----------------------------------------------

    @property
    def usable_pages(self) -> int:
        return self.n_pages - self.reserved

    def free_pages(self) -> int:
        return len(self._free)

    def pages_in_use(self) -> int:
        return self.usable_pages - len(self._free)

    def owners(self) -> list[object]:
        return list(self._tables)

    def table(self, owner: object) -> list[int]:
        """The owner's block table (page ids in row order); copy — the
        allocator's internal list must not be aliased by device-update
        code."""
        return list(self._tables.get(owner, ()))

    def owned_pages(self, owner: object) -> int:
        return len(self._tables.get(owner, ()))

    def private_pages(self, owner: object) -> int:
        """Table entries the owner holds EXCLUSIVELY (not spliced in via
        :meth:`share`) — what admission charges a prefix subscriber."""
        return (len(self._tables.get(owner, ()))
                - len(self._shared.get(owner, ())))

    def shared_pages_of(self, owner: object) -> frozenset[int]:
        """Page ids in ``owner``'s table that alias another owner's
        pages — the set the engine's copy-on-write guard consults
        before any write could land in one."""
        return frozenset(self._shared.get(owner, ()))

    def shared_pages(self) -> int:
        """Physical pages currently referenced by more than one table."""
        return sum(1 for n in self._refs.values() if n > 1)

    def refcount(self, page: int) -> int:
        """References on ``page`` (0 = free/unknown)."""
        return self._refs.get(page, 0)

    def leaked(self) -> int:
        """Pages neither free nor reachable from any table — must be 0
        always (and ``pages_in_use`` must be 0 once every owner
        released). Counts DISTINCT pages: a shared page reachable from
        five tables is one physical page, not five."""
        owned: set[int] = set()
        for t in self._tables.values():
            owned.update(t)
        return self.pages_in_use() - len(owned)

    # ---- alloc / grow / recycle --------------------------------------

    def ensure(self, owner: object, rows: int) -> list[int]:
        """Grow ``owner``'s block table to cover ``rows`` cache rows;
        returns the NEWLY allocated page ids (possibly empty). All-or-
        nothing: on shortfall nothing is taken and
        :class:`PagePoolExhausted` carries the evidence."""
        table = self._tables.setdefault(owner, [])
        need = pages_for_rows(rows, self.page_size) - len(table)
        if need > len(self._free):
            if not table:
                del self._tables[owner]
            raise PagePoolExhausted(
                f"page pool exhausted: owner {owner!r} needs {need} more "
                f"page(s) for {rows} rows, {len(self._free)} free",
                needed=need, free=len(self._free))
        new = [self._free.pop() for _ in range(max(0, need))]
        for p in new:
            self._free_set.discard(p)
            self._refs[p] = 1
        table.extend(new)
        self.allocs += len(new)
        self._rows[owner] = max(rows, self._rows.get(owner, 0))
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use())
        return new

    def share(self, owner: object, page_ids: list[int]) -> None:
        """Splice already-allocated pages into ``owner``'s (empty) table
        by REFERENCE — the shared-prefix splice: the pages' bytes are
        served to this owner too, their refcounts go up, and
        :meth:`release` will decrement instead of recycling. The owner
        must not hold pages yet (the splice is the table's head; suffix
        pages ``ensure`` behind it), the trash prefix can never be
        shared, and a free or unknown page is corruption, not load."""
        if self._tables.get(owner):
            raise PagingError(f"share into non-empty table of {owner!r} "
                              "(the prefix splice must come first)")
        seen: set[int] = set()
        for p in page_ids:
            if p < self.reserved:
                raise PagingError(f"page {p} is in the reserved trash "
                                  "prefix and can never be shared")
            if p in self._free_set or p not in self._refs:
                raise PagingError(f"share of unallocated page {p}")
            if p in seen:
                raise PagingError(f"page {p} repeated in one share")
            seen.add(p)
        for p in page_ids:
            self._refs[p] += 1
        self._tables[owner] = list(page_ids)
        self._shared[owner] = set(page_ids)
        self._rows.setdefault(owner, 0)
        self.shares += len(page_ids)

    def begin_private_copy(self, owner: object,
                           index: int) -> tuple[int, int]:
        """Copy-on-write, host half, phase one: validate the SHARED page
        at table position ``index`` and reserve a fresh private
        destination page WITHOUT touching the table or refcounts of the
        old page. Returns ``(old, new)``; the caller device-copies
        old -> new and then either :meth:`commit_private_copy` (the
        atomic table-row swap lands) or :meth:`abort_private_copy`
        (``new`` returns to the pool untouched). Sequencing the copy
        between the two phases means a device failure mid-copy (e.g. a
        survivable RESOURCE_EXHAUSTED) leaves the table, the shared set,
        and every refcount exactly as they were — the write-isolation
        invariant cannot be stranded half-swapped. All-or-nothing like
        ensure: on an empty free list nothing changes and
        :class:`PagePoolExhausted` carries the evidence."""
        table = self._tables.get(owner)
        if table is None or not 0 <= index < len(table):
            raise PagingError(f"private_copy: owner {owner!r} has no "
                              f"table entry {index}")
        old = table[index]
        if old not in self._shared.get(owner, ()):
            raise PagingError(f"private_copy of page {old} that owner "
                              f"{owner!r} does not share (already "
                              "private?)")
        if not self._free:
            raise PagePoolExhausted(
                f"page pool exhausted: CoW for owner {owner!r} needs 1 "
                "page, 0 free", needed=1, free=0)
        new = self._free.pop()
        self._free_set.discard(new)
        self._refs[new] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use())
        return old, new

    def abort_private_copy(self, new: int) -> None:
        """Unwind :meth:`begin_private_copy` after a failed device copy:
        the reserved destination (refcount 1, in no table) goes back to
        the free list and the pool is exactly as before ``begin``."""
        if self._refs.get(new) != 1 or new in self._free_set:
            raise PagingError(f"abort_private_copy of page {new} that is "
                              "not a lone reserved destination")
        del self._refs[new]
        self._free.append(new)
        self._free_set.add(new)

    def commit_private_copy(self, owner: object, index: int, old: int,
                            new: int) -> None:
        """Copy-on-write, host half, phase two (after the device copy
        succeeded): swap ``new`` into the table row, drop this owner's
        reference on ``old``, and mark the row private. Pure host
        bookkeeping — validation raises before any mutation, so the
        commit itself cannot half-apply."""
        table = self._tables.get(owner)
        if table is None or not 0 <= index < len(table) \
                or table[index] != old:
            raise PagingError(f"commit_private_copy: owner {owner!r} "
                              f"table entry {index} is not page {old}")
        if old not in self._shared.get(owner, ()) \
                or self._refs.get(new) != 1 or new in self._free_set:
            raise PagingError(f"commit_private_copy of {old}->{new} "
                              "without a matching begin")
        table[index] = new
        self._shared[owner].discard(old)
        self._decref(old, owner)
        self.allocs += 1

    def begin_install(self, owner: object, rows: int) -> list[int]:
        """Cross-pool page handoff, host half, phase one: reserve the
        pages ``rows`` cache rows need for a NEW owner without creating
        its table — the install twin of :meth:`begin_private_copy`. The
        caller device-scatters the migrated page bytes into the
        reserved ids (decode.install_request_pages) and then either
        :meth:`commit_install` (the table exists atomically, bytes
        already in place) or :meth:`abort_install` (every reserved page
        returns to the pool untouched) — a device failure mid-scatter
        can never strand a half-installed owner. All-or-nothing like
        ``ensure``: on shortfall nothing is taken and
        :class:`PagePoolExhausted` carries the evidence."""
        if owner in self._tables:
            raise PagingError(f"begin_install into existing owner "
                              f"{owner!r} (handoff installs are whole "
                              "tables, never splices)")
        need = pages_for_rows(rows, self.page_size)
        if need > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted: install for owner {owner!r} needs "
                f"{need} page(s) for {rows} rows, {len(self._free)} free",
                needed=need, free=len(self._free))
        ids = [self._free.pop() for _ in range(need)]
        for p in ids:
            self._free_set.discard(p)
            self._refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use())
        return ids

    def _staged_only(self, page_ids: list[int], what: str) -> None:
        """Validate that every page id is a lone reserved destination
        (refcount 1, free-list absent, reachable from NO table) — a page
        another owner freshly ``ensure``d also has refcount 1, and
        stealing it into a second table would be silent corruption."""
        owned: set[int] = set()
        for t in self._tables.values():
            owned.update(t)
        for p in page_ids:
            if self._refs.get(p) != 1 or p in self._free_set \
                    or p in owned:
                raise PagingError(f"{what} of page {p} that is not a "
                                  "lone reserved destination")

    def abort_install(self, page_ids: list[int]) -> None:
        """Unwind :meth:`begin_install` after a failed device scatter:
        the reserved destinations (refcount 1, in no table) go back to
        the free list and the pool is exactly as before ``begin``."""
        self._staged_only(page_ids, "abort_install")
        for p in page_ids:
            del self._refs[p]
            self._free.append(p)
            self._free_set.add(p)
        self.install_aborts += 1

    def commit_install(self, owner: object, page_ids: list[int],
                       rows: int) -> None:
        """Cross-pool handoff, host half, phase two (after the device
        scatter landed): the reserved pages become ``owner``'s block
        table covering ``rows`` live rows. Pure host bookkeeping —
        validation raises before any mutation, so the commit itself
        cannot half-apply."""
        if owner in self._tables:
            raise PagingError(f"commit_install into existing owner "
                              f"{owner!r}")
        if pages_for_rows(rows, self.page_size) != len(page_ids):
            raise PagingError(
                f"commit_install of {len(page_ids)} page(s) does not "
                f"cover {rows} rows for owner {owner!r}")
        self._staged_only(page_ids, "commit_install")
        self._tables[owner] = list(page_ids)
        self._rows[owner] = rows
        self.allocs += len(page_ids)
        self.installs += 1

    def private_copy(self, owner: object, index: int) -> tuple[int, int]:
        """One-shot begin+commit for callers with no device copy between
        the phases (tests, host-only tools). The engine's CoW guard uses
        the split form so the device copy runs between reserve and
        swap."""
        old, new = self.begin_private_copy(owner, index)
        self.commit_private_copy(owner, index, old, new)
        return old, new

    def _decref(self, page: int, owner: object) -> bool:
        """Drop one reference; recycle to the free list when the last
        reference goes. True when the page was actually freed."""
        n = self._refs.get(page, 0)
        if n < 1 or page in self._free_set or page < self.reserved:
            # corrupted table — refuse to double-free into the pool
            raise PagingError(f"page {page} already free (double free "
                              f"by owner {owner!r})")
        if n > 1:
            self._refs[page] = n - 1
            return False
        del self._refs[page]
        self._free.append(page)
        self._free_set.add(page)
        self.recycled += 1
        return True

    def note_rows(self, owner: object, rows: int) -> None:
        """Record the owner's live row count (decode growth within
        already-allocated pages) — feeds fragmentation accounting."""
        if owner not in self._tables:
            raise PagingError(f"note_rows for unknown owner {owner!r}")
        self._rows[owner] = rows

    def release(self, owner: object) -> int:
        """Drop every page reference the owner holds (retire / shed /
        OOM quarantine all land here); returns the count actually
        RECYCLED — pages still referenced by another table (shared
        prefix pages, pinned registrations) keep their bytes and stay
        out of the free list. Unknown owners and double-frees raise
        :class:`PagingError`."""
        table = self._tables.pop(owner, None)
        if table is None:
            raise PagingError(f"release of unknown owner {owner!r} "
                              "(double free?)")
        freed = 0
        for p in table:
            freed += self._decref(p, owner)
        self._rows.pop(owner, None)
        self._shared.pop(owner, None)
        return freed

    def truncate(self, owner: object, rows: int) -> int:
        """Shrink the owner's block table to exactly the pages covering
        ``rows`` live rows, recycling the dropped tail — the
        speculative-rejection primitive: a rejected draft's scratch tail
        is a table truncation plus a page release, never a cache
        rewind. Returns the count actually RECYCLED (a shared page in
        the dropped tail — impossible for spec tails, which grow past
        the shared prefix head — just drops this owner's reference).
        Also records ``rows`` as the owner's live row count
        (:meth:`note_rows` semantics). Unknown owners and a ``rows``
        figure the kept table could not cover raise
        :class:`PagingError`."""
        table = self._tables.get(owner)
        if table is None:
            raise PagingError(f"truncate of unknown owner {owner!r}")
        keep = pages_for_rows(rows, self.page_size)
        if keep > len(table):
            raise PagingError(
                f"truncate of owner {owner!r} to {rows} rows needs {keep} "
                f"page(s) but the table holds {len(table)}")
        freed = 0
        shared = self._shared.get(owner)
        for p in table[keep:]:
            if shared is not None:
                shared.discard(p)
            freed += self._decref(p, owner)
        del table[keep:]
        self._rows[owner] = rows
        return freed

    # ---- occupancy / fragmentation -----------------------------------

    def occupancy_pct(self) -> float:
        """Pages in use over usable pages, percent."""
        if not self.usable_pages:
            return 0.0
        return 100.0 * self.pages_in_use() / self.usable_pages

    def fragmentation_pct(self) -> float:
        """Internal fragmentation: allocated rows not holding a live
        token, over all allocated rows (0 when nothing is allocated).
        The paged analog of the slot engine's dead-band waste — except
        bounded above by one page per request instead of by
        ``max_seq``. Both sides of the ratio are PHYSICAL: a shared
        prefix page's rows count once (under the owner that allocated
        them), and each subscriber contributes only the live rows of
        its private pages."""
        total = rows_for_pages(self.pages_in_use(), self.page_size)
        if not total:
            return 0.0
        live = 0
        for o, t in self._tables.items():
            cap = rows_for_pages(len(t), self.page_size)
            shared_rows = rows_for_pages(len(self._shared.get(o, ())),
                                         self.page_size)
            live += max(0, min(self._rows.get(o, 0), cap) - shared_rows)
        return 100.0 * max(0, total - live) / total

    def snapshot(self) -> dict[str, Any]:
        """Telemetry-shaped accounting view (plain numbers only)."""
        return {
            "pages_total": self.usable_pages,
            "pages_in_use": self.pages_in_use(),
            "pages_free": self.free_pages(),
            "pages_shared": self.shared_pages(),
            "occupancy_pct": round(self.occupancy_pct(), 1),
            "fragmentation_pct": round(self.fragmentation_pct(), 1),
            "peak_in_use": self.peak_in_use,
            "allocs": self.allocs,
            "recycled": self.recycled,
            "shares": self.shares,
            "installs": self.installs,
            "install_aborts": self.install_aborts,
        }

"""Continuous-batching slot scheduler (host-side control plane).

The engine owns the device state (params, KV/SSM cache, the per-slot token
and position vectors); the scheduler owns the *request* state: a FIFO
arrival queue, a slot table mapping batch rows to in-flight requests,
EOS / max-token completion, and per-request latency metrics. It never
touches the device — one scheduler tick per decode chunk is the only host work on
the decode path, so the dispatch queue stays full between syncs.

Semantics
---------
* A batch row of the decode step is a **slot**. A slot holds at most one
  request; finished slots are refilled from the queue between chunks
  instead of blocking the batch on its slowest member.
* Requests arrive at `arrival_time` (seconds on the engine's clock; 0 =
  already queued). Admission is FIFO among arrived requests.
* The engine decodes `sync_every` tokens device-side per chunk, then hands
  the whole (steps, B) token block to `observe()`. Tokens a slot produced
  *after* its EOS / token budget inside the chunk are discarded here and
  never counted — tok/s reports real generated tokens only.
* Completion timestamps are quantized to chunk boundaries (the host only
  observes tokens once per chunk); TTFT is exact (prefill is a sync point).
* With a `PageAllocator` attached (paged KV engines), admission is gated on
  **free pages, not free slots**: a request needing more pages than are
  currently free stays queued (head-of-line) until a retirement frees
  them, and one that can *never* fit (more pages than the pool or the
  per-request block table holds) is admitted with `pages=None` so the
  engine retires it as rejected. Pages free on retirement — EOS, budget,
  or rejection — so the pool can never leak across slot refills.
* Each request carries a **quality tier**: "premium" decodes on the exact
  round-once datapath, "bulk" may decode on the approximate-normalization
  datapath (core/chained_fma.approx_*). A decode chunk is shared by the
  whole batch, so the engine runs a chunk approximate only when *every*
  active slot is bulk — admission is therefore **tier-affine**: among
  arrived requests, one matching the active batch's (homogeneous) tier is
  preferred over the FIFO head, so tiers phase-separate and bulk chunks
  actually happen under mixed traffic. Premium requests never decode on
  the approximate path; bulk requests sharing a chunk with premium ones
  simply get exact arithmetic (quality floor, never a ceiling).
  `observe(..., mode=)` records which datapath produced each token, so
  the summary can report per-(tier, mode) token counts for the energy
  model (core/energy.py tier_energy_summary).
* **Two-pool mode** (disaggregated serving, DESIGN.md §10): the engine
  splits admission into a PREFILL pool (`begin_prefill` pulls arrived
  requests, takes their page leases, and `finish_prefill` stages the
  prefilled request + first token on a **ready queue**) and a DECODE pool
  (`admit_ready` binds staged requests to free slots between chunks — the
  only device work left is the block-table splice, so decode admissions
  never wait on prefill compute). Staging pages ARE pool pages: a request
  holds its leases from prefill admission through the ready queue to
  retirement, so the `pages_leaked == 0` invariant holds through the
  handoff. `ReplicaRouter` adds pick-least-loaded routing across N
  data-parallel engine replicas behind one arrival stream.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque

import numpy as np

TIERS = ("premium", "bulk")


class PageAllocator:
    """Host-side refcounted free list over the global KV page pool, with an
    optional prefix cache.

    Page ids `[reserved, n_pages)` are allocatable; ids below `reserved`
    (default: page 0, the trash page decode writes of unmapped slots land
    in — see models/layers.py PagedKVCache) are never handed out.
    `max_request_pages` caps one request (the device block table's width).

    Every allocatable page carries a **refcount** — the number of live
    request leases mapping it. `alloc` hands out pages at refcount 1;
    `retain` bumps a shared page for an additional reader (prefix-cache
    hit); `free` releases one lease per page and only returns a page to the
    free list when its refcount reaches 0 *and* the prefix cache is not
    holding it. A page is therefore in exactly one of three states:

      free    — on the free deque (mirrored by `_free_set`, kept in
                lockstep so double-free detection is O(1), not a
                set-rebuild per retirement)
      leased  — refcount ≥ 1: mapped into at least one live block table
      cached  — refcount 0 but registered in the prefix index: its content
                (a prompt-prefix KV run) is retained for future admissions
                and reclaimed lazily under pool pressure (LRU run order)

    `pages_leaked` accounting is the remainder: in_use − leased − cached,
    which must stay 0 — cached-but-unleased prefix pages are *not* leaks.

    Prefix cache (`prefix_caching=True`): prompts are indexed at page
    granularity. Boundary key i maps `(fingerprint, tier, tokens[:i·psz])`
    to the page holding that whole page of prompt KV; an additional *tail*
    key maps the full prompt to its last partial page. Lookup walks the
    chain for the longest cached whole-page run (capped so at least one
    prompt token is always left to prefill — the admission needs last-token
    logits), then checks the tail key for an exact full-prompt match. The
    key carries the request **tier** because the approximate-normalization
    tiers (DESIGN.md §6) make the arithmetic mode part of a page's
    identity: a bulk stream must never be served a premium-exact prefix
    (or vice versa) or the divergence-probe premium-identity guarantee
    silently breaks. `fingerprint` isolates engines (params/config/dtype).

    Cached pages are strictly read-only: anyone who must write into a
    cached or multiply-leased page (the first divergent token of a fork)
    copies it first — copy-on-write, orchestrated by the engine via
    `cow_fork` accounting here.
    """

    def __init__(self, n_pages: int, page_size: int,
                 max_request_pages: int | None = None, reserved: int = 1,
                 min_request_tokens: int = 1, prefix_caching: bool = False,
                 fingerprint: str = ""):
        assert n_pages > reserved, (n_pages, reserved)
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.reserved = int(reserved)
        self.max_request_pages = (self.capacity if max_request_pages is None
                                  else int(max_request_pages))
        # floor on a request's token allocation: engines with local-window
        # rings prefill fragments of at least `window` tokens, so the pages
        # must cover that floor too (see engine.new_frag)
        self.min_request_tokens = int(min_request_tokens)
        self._free = deque(range(reserved, n_pages))
        self._free_set = set(self._free)      # lockstep mirror of _free
        self._refcount = [0] * n_pages
        self.leased = 0                       # pages with refcount >= 1
        self.peak_in_use = 0                  # high-water mark of `leased`
        # prefix cache state
        self.prefix_caching = bool(prefix_caching)
        self.fingerprint = str(fingerprint)
        self._index: dict[tuple, int] = {}    # boundary/tail key -> page id
        self._page_key: dict[int, tuple] = {}  # inverse (1:1 — a page is
        #                                        registered under one key)
        # run = the set of keys ONE registration added, LRU-ordered; the
        # eviction unit (evicting a chain's middle entry would orphan the
        # deeper pages, so whole runs go at once)
        self._runs: OrderedDict[tuple, list[tuple]] = OrderedDict()
        self._run_of_key: dict[tuple, tuple] = {}
        self.prefix_evictions = 0             # runs reclaimed under pressure
        self.cow_forks = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the reserved trash page)."""
        return self.n_pages - self.reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.free_pages

    @property
    def cached(self) -> int:
        """Pages retained only by the prefix cache (refcount 0)."""
        return sum(1 for p in self._page_key if self._refcount[p] == 0)

    @property
    def leaked(self) -> int:
        """Pages neither free, leased, nor cached — must always be 0."""
        return self.in_use - self.leased - self.cached

    def _note_peak(self):
        # called wherever lease counts change — alloc, retain, free — so
        # refcount-bump admissions (cache hits that allocate nothing)
        # register peaks too, not just fresh allocations
        self.peak_in_use = max(self.peak_in_use, self.leased)

    def pages_needed(self, tokens: int) -> int:
        tokens = max(int(tokens), self.min_request_tokens, 1)
        return -(-tokens // self.page_size)

    def fits_ever(self, tokens: int) -> bool:
        """Could this request ever be admitted (given an empty pool)?"""
        n = self.pages_needed(tokens)
        return n <= min(self.capacity, self.max_request_pages)

    # ------------------------------------------------------------------
    # lease lifecycle
    # ------------------------------------------------------------------

    def _push_free(self, p: int):
        assert p not in self._free_set, ("double free", p)
        self._free.append(p)
        self._free_set.add(p)

    def _pop_free(self) -> int:
        p = self._free.popleft()
        self._free_set.remove(p)
        return p

    def allocatable(self, exclude: set[int] | None = None) -> int:
        """Pages an alloc could obtain right now: free plus cached pages in
        fully-idle runs (reclaimable via eviction). Runs containing any page
        in `exclude` are not counted — admission passes the pages it is
        about to retain, which pin their runs against eviction."""
        exclude = exclude or set()
        n = len(self._free)
        for keys in self._runs.values():
            pages = [self._index[k] for k in keys]
            if any(self._refcount[p] > 0 for p in pages):
                continue
            if exclude and not exclude.isdisjoint(pages):
                continue
            n += len(pages)
        return n

    def _evict_for(self, n: int):
        """Reclaim LRU fully-idle cached runs until `n` pages are free."""
        for run_id in list(self._runs):
            if len(self._free) >= n:
                break
            keys = self._runs[run_id]
            if any(self._refcount[self._index[k]] > 0 for k in keys):
                continue   # some page still leased: the run stays
            for k in keys:
                page = self._index.pop(k)
                del self._page_key[page]
                del self._run_of_key[k]
                self._push_free(page)
            del self._runs[run_id]
            self.prefix_evictions += 1

    def alloc(self, n: int) -> list[int] | None:
        """Lease `n` fresh pages (refcount 1 each), evicting idle cached
        prefix runs if the free list alone can't cover them; None if they
        aren't obtainable right now."""
        if n > self.max_request_pages:
            return None
        if n > len(self._free):
            self._evict_for(n)
        if n > len(self._free):
            return None
        pages = [self._pop_free() for _ in range(n)]
        for p in pages:
            assert self._refcount[p] == 0, p
            self._refcount[p] = 1
        self.leased += n
        self._note_peak()
        return pages

    def retain(self, pages: list[int]):
        """Add one lease per page (prefix-cache hit: a new block table maps
        already-resident pages; nothing is allocated)."""
        for p in pages:
            assert self.reserved <= p < self.n_pages, p
            assert p not in self._free_set, ("retain of a free page", p)
            if self._refcount[p] == 0:
                self.leased += 1
            self._refcount[p] += 1
        self._note_peak()

    def free(self, pages: list[int]):
        """Release one lease per page. A page whose last lease drops goes
        back to the free list unless the prefix cache retains it (then it
        parks as `cached` until evicted)."""
        for p in pages:
            assert self.reserved <= p < self.n_pages, p
            assert self._refcount[p] > 0, ("double free", p)
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self.leased -= 1
                if p not in self._page_key:
                    self._push_free(p)
        self._note_peak()

    def cow_fork(self, donor: int):
        """Account a copy-on-write fork: the caller copied `donor` into a
        freshly-`alloc`ed page device-side and remapped its block table;
        here the donor sheds that writer's lease (it stays cached/shared,
        read-only)."""
        self.cow_forks += 1
        self.free([donor])

    # ------------------------------------------------------------------
    # prefix cache
    # ------------------------------------------------------------------

    def _boundary_key(self, tier: str, prompt: list[int], i: int) -> tuple:
        return (self.fingerprint, tier, tuple(prompt[:i * self.page_size]))

    def _tail_key(self, tier: str, prompt: list[int]) -> tuple:
        return (self.fingerprint, tier, tuple(prompt), "tail")

    def prefix_lookup(self, prompt: list[int],
                      tier: str) -> tuple[list[int], int, int | None]:
        """Longest cached prefix of `prompt` under this tier's key space.

        Returns `(whole_pages, shared_tokens, tail_donor)`: the cached
        whole-page run (page ids in sequence order), the token count it
        covers, and — on an exact full-prompt match — the cached partial
        tail page to copy-on-write from (then `shared_tokens` is
        `len(prompt) - 1`: the last prompt token is always re-run so the
        admission has logits to sample the first generated token from).
        """
        if not self.prefix_caching:
            return [], 0, None
        plen = len(prompt)
        psz = self.page_size
        pages: list[int] = []
        touched: list[tuple] = []
        # cap the walk so >= 1 prompt token stays uncached (logits source)
        for i in range(1, (plen - 1) // psz + 1):
            key = self._boundary_key(tier, prompt, i)
            page = self._index.get(key)
            if page is None:
                break
            pages.append(page)
            touched.append(key)
        shared = len(pages) * psz
        tail_donor = None
        # a tail hit only pays when it extends sharing past the whole-page
        # run (plen-1 > W*psz, i.e. >= 2 prompt tokens on the tail page) —
        # otherwise the device copy buys nothing
        if len(pages) == plen // psz and plen % psz >= 2:
            key = self._tail_key(tier, prompt)
            tail_donor = self._index.get(key)
            if tail_donor is not None:
                shared = plen - 1
                touched.append(key)
        for key in touched:                    # LRU touch per involved run
            run = self._run_of_key.get(key)
            if run is not None and run in self._runs:
                self._runs.move_to_end(run)
        return pages, shared, tail_donor

    def prefix_register(self, prompt: list[int], pages: list[int],
                        tier: str) -> int:
        """Register a freshly-prefilled prompt's pages for reuse: one entry
        per whole prompt page plus a tail entry for the partial last page.
        Entries whose key already exists are skipped (first registrant
        wins; identical arithmetic makes the pages bit-identical anyway).

        The registrant keeps decoding into the tail page — that is safe:
        its decode writes land at rows >= plen % psz, past the cached
        prompt rows, and a future reader COW-copies the page then masks
        whatever stale rows it didn't overwrite by position (the same
        invariant normal paged decode relies on for recycled pages).
        Returns the number of pages newly registered."""
        if not self.prefix_caching:
            return 0
        plen = len(prompt)
        psz = self.page_size
        added: list[tuple] = []
        run_id = (self.fingerprint, tier, tuple(prompt))
        for i in range(1, plen // psz + 1):
            key = self._boundary_key(tier, prompt, i)
            if key in self._index:
                continue
            self._register_one(key, pages[i - 1], run_id, added)
        # tail entries with < 2 prompt rows never beat the whole-page run
        # (see prefix_lookup) — don't park a page in the cache for them
        if plen % psz >= 2:
            key = self._tail_key(tier, prompt)
            if key not in self._index:
                self._register_one(key, pages[plen // psz], run_id, added)
        if added:
            self._runs.setdefault(run_id, []).extend(added)
            self._runs.move_to_end(run_id)
        return len(added)

    def _register_one(self, key: tuple, page: int, run_id: tuple,
                      added: list[tuple]):
        assert page not in self._page_key, (page, "already registered")
        self._index[key] = page
        self._page_key[page] = key
        self._run_of_key[key] = run_id
        added.append(key)


class _ShardView:
    """One data shard's `PageAllocator` in the pool's global page ids: the
    shard's allocator hands out its local ids [1, n) (its own page 0 is
    its trash page) and this view adds the shard's first global id. The
    scheduler's page transaction runs on it as on a `PageAllocator`."""

    def __init__(self, alloc: PageAllocator, base: int, owner):
        self.allocator = alloc
        self.base = int(base)
        self._owner = owner

    def _local(self, pages):
        return [p - self.base for p in pages]

    def _global(self, pages):
        return [p + self.base for p in pages]

    @property
    def leased(self) -> int:
        return self.allocator.leased

    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages

    @property
    def cached(self) -> int:
        return self.allocator.cached

    def pages_needed(self, tokens: int) -> int:
        return self.allocator.pages_needed(tokens)

    def fits_ever(self, tokens: int) -> bool:
        return self.allocator.fits_ever(tokens)

    def allocatable(self, exclude: set[int] | None = None) -> int:
        return self.allocator.allocatable(set(self._local(exclude or ())))

    def prefix_lookup(self, prompt, tier):
        pages, shared, donor = self.allocator.prefix_lookup(prompt, tier)
        return (self._global(pages), shared,
                None if donor is None else donor + self.base)

    def prefix_peek(self, prompt, tier):
        """`prefix_lookup` with its touch of the LRU order undone: what
        the shard would give, with no side effect."""
        runs = self.allocator._runs
        order = list(runs)
        got = self.prefix_lookup(prompt, tier)
        for run in order:
            runs.move_to_end(run)
        return got

    def alloc(self, n: int) -> list[int] | None:
        got = self.allocator.alloc(n)
        self._owner._note_peak()
        return None if got is None else self._global(got)

    def retain(self, pages):
        self.allocator.retain(self._local(pages))
        self._owner._note_peak()

    def free(self, pages):
        self.allocator.free(self._local(pages))
        self._owner._note_peak()

    def cow_fork(self, donor: int):
        self.allocator.cow_fork(donor - self.base)

    def prefix_register(self, prompt, pages, tier) -> int:
        return self.allocator.prefix_register(prompt, self._local(pages),
                                              tier)


class ShardedPageAllocator:
    """One `PageAllocator` per data shard behind one interface: the page
    pool of serving over a `data` axis of `n_shards` ranks
    (`ServeEngine`). Shard i owns the slots [i·b, (i + 1)·b) of
    `n_slots` = n_shards·b and the global page ids [i·n, (i + 1)·n) of
    `n_pages` = n_shards·n, the page cut of `sharding.cache_specs`; its
    allocator is a `PageAllocator` over n pages whose local page 0, global
    i·n, is the shard's own trash page. A slot's pages come only from its
    shard's range, so every slot attends over pages its own data rank
    holds. The allocators themselves are the JAX package's bits: at one
    shard the ids are `PageAllocator`'s, and each shard's are those of a
    `PageAllocator` over its range.

    The scheduler takes a shard's `view(i)` for an admission's page
    transaction (the unified path: the slot's shard; the prefill pool: the
    shard `SlotScheduler.begin_prefill` picks); a request's retirement,
    prefix registration and copy-on-write fork route by its page ids. The
    pool's counts (`capacity`, `in_use`, `leased`, `cached`, `leaked`) are
    the shards' summed, `peak_in_use` the pool's high-water mark of
    `leased` and `peak_by_shard` each shard's."""

    def __init__(self, n_shards: int, n_pages: int, page_size: int,
                 n_slots: int, **kw):
        if n_pages % n_shards or n_slots % n_shards:
            raise ValueError(f"{n_pages} pages and {n_slots} slots do not "
                             f"split over {n_shards} data shards")
        self.n_shards = int(n_shards)
        self.pages_per_shard = n_pages // n_shards
        self.slots_per_shard = n_slots // n_shards
        self.page_size = int(page_size)
        self.shards = [_ShardView(PageAllocator(self.pages_per_shard,
                                                page_size, **kw),
                                  i * self.pages_per_shard, self)
                       for i in range(self.n_shards)]
        self.prefix_caching = self.shards[0].allocator.prefix_caching
        self.peak_in_use = 0

    def view(self, shard: int) -> _ShardView:
        return self.shards[shard]

    def shard_of_slot(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def shard_of_page(self, page: int) -> int:
        return page // self.pages_per_shard

    def _of(self, pages) -> _ShardView:
        return self.shards[self.shard_of_page(pages[0])]

    def _note_peak(self):
        self.peak_in_use = max(self.peak_in_use, self.leased)

    def _sum(self, name: str) -> int:
        return sum(getattr(s.allocator, name) for s in self.shards)

    @property
    def capacity(self) -> int:
        return self._sum("capacity")

    @property
    def in_use(self) -> int:
        return self._sum("in_use")

    @property
    def leased(self) -> int:
        return self._sum("leased")

    @property
    def cached(self) -> int:
        return self._sum("cached")

    @property
    def leaked(self) -> int:
        return self._sum("leaked")

    @property
    def cow_forks(self) -> int:
        return self._sum("cow_forks")

    @property
    def prefix_evictions(self) -> int:
        return self._sum("prefix_evictions")

    @property
    def peak_by_shard(self) -> list[int]:
        return [s.allocator.peak_in_use for s in self.shards]

    def free(self, pages):
        self._of(pages).free(pages)

    def retain(self, pages):
        self._of(pages).retain(pages)

    def cow_fork(self, donor: int):
        self._of([donor]).cow_fork(donor)

    def prefix_register(self, prompt, pages, tier) -> int:
        return self._of(pages).prefix_register(prompt, pages, tier)


@dataclasses.dataclass
class Request:
    """One generation request and (after serving) its result + metrics."""
    rid: int
    prompt: list[int]
    max_new_tokens: int
    arrival_time: float = 0.0
    tier: str = "premium"                # "premium" (exact) | "bulk" (approx)

    # filled in by the scheduler as the request is served
    tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    # KV pages mapped at admission (paged engines; leases released on
    # retirement, the list is kept as a record). None after admission =
    # could never fit the pool / block table — the engine retires it as
    # rejected. With prefix caching the first `shared_tokens // page_size`
    # entries are cache-hit pages (retained, not allocated).
    pages: list[int] | None = None
    # prompt tokens whose KV is served from the prefix cache (prefill
    # resumes at this offset; 0 = full prefill)
    shared_tokens: int = 0
    # cached partial tail page to copy-on-write from before this request's
    # first write (engine copies device-side into pages[shared_tokens //
    # page_size] then reports the fork; cleared back to None once done)
    cow_src: int | None = None
    # the data shard whose pages and slots serve it (a sharded pool's
    # `ShardedPageAllocator`; 0 with one allocator)
    shard: int = 0
    t_admitted: float | None = None
    t_first_token: float | None = None   # TTFT reference point
    t_done: float | None = None
    prefill_s: float = 0.0
    finish_reason: str = ""              # "eos" | "length"

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def n_generated(self) -> int:
        """Real generated tokens (post-EOS chunk padding never lands here)."""
        return len(self.tokens)

    @property
    def ttft(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time

    @property
    def decode_tok_s(self) -> float | None:
        """Decode-only rate: tokens after the first / time after TTFT."""
        if self.t_done is None or self.t_first_token is None:
            return None
        dt = self.t_done - self.t_first_token
        return (self.n_generated - 1) / dt if dt > 0 else None


@dataclasses.dataclass
class _Slot:
    req: Request | None = None


class SlotScheduler:
    """Slot table + arrival queue + per-request accounting."""

    def __init__(self, n_slots: int, eos_id: int = 2,
                 pages: PageAllocator | None = None):
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.pages = pages        # set by paged engines (serve() injects one)
        self.pending: deque[Request] = deque()
        # two-pool mode only (begin_prefill/finish_prefill/admit_ready):
        # prefilled requests staged for a decode slot, FIFO by prefill
        # completion; unified engines never touch it
        self.ready: deque[Request] = deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.finished: list[Request] = []
        self.depth_samples: list[int] = []
        self.ready_depth_samples: list[int] = []
        self._two_pool = False    # flipped by begin_prefill; gates summary
        self.page_util_samples: list[float] = []
        self.page_blocks = 0      # requests that ever waited for free pages
        self._blocked_rids: set[int] = set()
        self.refills = 0          # admissions into a previously-used slot
        self._slot_used = [False] * n_slots
        self._freed_slots: list[int] = []
        self._next_rid = 0
        # real generated tokens by (tier, datapath mode) — the energy
        # model's input. Prefill/first tokens are always exact; bulk
        # tokens decoded in a mixed (exact) chunk are counted honestly
        # as ("bulk", "exact").
        self.tier_mode_tokens: dict[tuple[str, str], int] = {}
        self.tier_affine_picks = 0   # admissions that skipped the FIFO head
        self.prefix_hits = 0         # admissions that mapped cached pages
        self.prefix_tokens_saved = 0  # prompt tokens not re-prefilled
        # speculative-decode accounting (engine.observe_spec): drafted
        # counts every draft token a live slot's iteration proposed,
        # accepted the ones the verify forward agreed with — the ratio is
        # the acceptance rate the draft-cost tradeoff lives or dies on
        self.spec_drafted = 0
        self.spec_accepted = 0
        # histogram of per-iteration accepted-prefix lengths (0 = reject-
        # all, k = the whole draft); live slots only
        self.spec_accept_hist: dict[int, int] = {}

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               arrival_time: float = 0.0, tier: str = "premium") -> Request:
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; have {TIERS}")
        req = Request(rid=self._next_rid, prompt=list(map(int, prompt)),
                      max_new_tokens=int(max_new_tokens),
                      arrival_time=float(arrival_time), tier=tier)
        self._next_rid += 1
        # keep the queue sorted by arrival (stable: ties stay in submit
        # order), so admission is FIFO among *arrived* requests — a late
        # submit with an early arrival_time must not be head-of-line
        # blocked behind a future arrival
        i = len(self.pending)
        while i > 0 and self.pending[i - 1].arrival_time > req.arrival_time:
            i -= 1
        self.pending.insert(i, req)
        return req

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.req is None]

    def next_arrival(self) -> float | None:
        return self.pending[0].arrival_time if self.pending else None

    def _active_tier(self) -> str | None:
        """The batch's tier iff every active slot shares one, else None."""
        tiers = {s.req.tier for s in self.slots if s.req is not None}
        return tiers.pop() if len(tiers) == 1 else None

    def _select_pending(self, now: float) -> int | None:
        """Index of the pending request to admit next: the earliest-arrived
        one matching the active batch's homogeneous tier (tier-affine — so
        mixed streams phase-separate and all-bulk chunks can run the
        approximate datapath), else the FIFO head. Returns None when
        nothing has arrived by `now`."""
        if not self.pending or self.pending[0].arrival_time > now:
            return None
        tier = self._active_tier()
        if tier is not None and self.pending[0].tier != tier:
            for i, req in enumerate(self.pending):
                if req.arrival_time > now:
                    break
                if req.tier == tier:
                    return i
        return 0

    def _sharded(self) -> bool:
        return isinstance(self.pages, ShardedPageAllocator)

    def _page_plan(self, cand: Request, pages, peek: bool = False):
        """The pages admitting `cand` from `pages` (the allocator, or one
        data shard's view of a `ShardedPageAllocator`) would take now:
        (hit, shared, donor, fresh), or None where they are not free now.
        `peek` (a shard's view): no side effect."""
        tokens = cand.prompt_len + cand.max_new_tokens
        needed = pages.pages_needed(tokens)
        lookup = pages.prefix_peek if peek else pages.prefix_lookup
        hit, shared, donor = lookup(cand.prompt, cand.tier)
        fresh = needed - len(hit)
        pinned = set(hit) | ({donor} if donor is not None else set())
        if (fresh > pages.allocatable(pinned) and pinned
                and self._sharded() and pages.leased == 0
                and needed <= pages.allocatable()):
            # a data shard's pool holds a few slots' pages: where no lease
            # in it is live, no retirement will ever free the pages its
            # cached run pins, so the request takes fresh pages (evicting
            # the run) and prefills its whole prompt, the same tokens
            hit, shared, donor, fresh, pinned = [], 0, None, needed, set()
        if fresh > pages.allocatable(pinned):
            return None
        return hit, shared, donor, fresh

    def _fits_now(self, cand: Request, shard: int) -> bool:
        """Whether data shard `shard` of a sharded pool takes `cand` now
        (or never could: the transaction passes it on to be rejected),
        with no side effect."""
        pages = self.pages.view(shard)
        return (not pages.fits_ever(cand.prompt_len + cand.max_new_tokens)
                or self._page_plan(cand, pages, peek=True) is not None)

    def _note_block(self, cand: Request):
        # count *requests* that waited, not poll attempts — the loop
        # re-asks every chunk tick while the head is blocked
        if cand.rid not in self._blocked_rids:
            self._blocked_rids.add(cand.rid)
            self.page_blocks += 1

    def _page_transaction(self, cand: Request, shard: int = 0) -> bool:
        """Page-gate one candidate and, on success, take its leases and
        fill `pages/shared_tokens/cow_src` in place. Returns False when
        the candidate must stay queued (could fit an empty pool but not
        the current one); a candidate that can NEVER fit passes with
        `pages=None` for the engine to reject. Shared by the unified path
        (`admit`) and the prefill pool (`begin_prefill`). A sharded pool
        (`ShardedPageAllocator`) takes the pages from data shard
        `shard`'s range, and `cand.shard` records it."""
        pages = self.pages.view(shard) if self._sharded() else self.pages
        cand.shard = shard
        tokens = cand.prompt_len + cand.max_new_tokens
        if not pages.fits_ever(tokens):
            cand.pages = None
            return True
        plan = self._page_plan(cand, pages)
        if plan is None:
            self._note_block(cand)
            return False
        hit, shared, donor, fresh = plan
        # transaction: pin the hit pages (+ COW donor) with leases FIRST
        # so the fresh alloc's eviction pass cannot reclaim them, then
        # allocate the remainder — the allocatable() gate above
        # guarantees this succeeds
        if hit or donor is not None:
            pages.retain(hit + ([donor] if donor is not None else []))
        fresh_pages = pages.alloc(fresh)
        assert fresh_pages is not None, (fresh, "gate lied")
        cand.pages = hit + fresh_pages
        cand.shared_tokens = shared
        cand.cow_src = donor
        if shared:
            self.prefix_hits += 1
            self.prefix_tokens_saved += shared
        return True

    def admit(self, slot_idx: int, now: float) -> Request | None:
        """Admit the next pending request (see `_select_pending`) into
        `slot_idx` if one has arrived by `now`.

        With a page allocator attached, admission is additionally gated on
        free pages: a candidate that could fit an empty pool but not the
        current one stays queued (returns None — the slot idles until a
        retirement frees pages); one that could never fit is admitted with
        `pages=None` for the engine to reject."""
        i = self._select_pending(now)
        if i is None:
            return None
        cand = self.pending[i]
        shard = 0
        if self._sharded():
            shard = self.pages.shard_of_slot(slot_idx)
            if not self._fits_now(cand, shard):
                # the engine tries the next free slot: a block counts only
                # where no shard with a free slot takes the request now
                if not any(self._fits_now(cand, self.pages.shard_of_slot(s))
                           for s in self.free_slots()):
                    self._note_block(cand)
                return None
        if (self.pages is not None
                and not self._page_transaction(cand, shard)):
            return None
        req = cand
        del self.pending[i]
        if i > 0:
            self.tier_affine_picks += 1
        req.slot = slot_idx
        req.t_admitted = now
        if self._slot_used[slot_idx]:
            self.refills += 1
        self._slot_used[slot_idx] = True
        self.slots[slot_idx].req = req
        return req

    def reject(self, slot_idx: int, now: float,
               reason: str = "rejected") -> Request:
        """Retire the just-admitted request without serving it (e.g. the
        engine found it cannot fit the cache); the batch keeps going."""
        slot = self.slots[slot_idx]
        req = slot.req
        assert req is not None
        self._finish(slot, req, reason, now)
        return req

    def start(self, slot_idx: int, first_token: int, now: float,
              prefill_s: float = 0.0):
        """Record the prefill's argmax token (the first generated token)."""
        slot = self.slots[slot_idx]
        req = slot.req
        assert req is not None
        req.t_first_token = now
        req.prefill_s = prefill_s
        self._accept(slot, req, int(first_token), now)

    # ------------------------------------------------------------------
    # two-pool admission (disaggregated serving, DESIGN.md §10)
    # ------------------------------------------------------------------

    def ready_depth(self) -> int:
        return len(self.ready)

    def begin_prefill(self, now: float) -> Request | None:
        """Pull the next arrived request into the PREFILL pool. Page-gated
        exactly like `admit` — staging pages ARE pool pages (the handoff
        moves ownership, not bytes between pools), so a request holds its
        leases from here through the ready queue to retirement and the
        `pages_leaked == 0` invariant holds at every point. Selection is
        plain FIFO among arrived requests: tier affinity is applied
        downstream at `admit_ready`, where the decode batch whose tier
        matters actually lives. Returns None when nothing has arrived by
        `now` or the head is blocked on pages. A returned request with
        `pages=None` can never fit — retire it via `reject_prefill`.

        A sharded pool (`ShardedPageAllocator`) stages the request in the
        first shard of `_prefill_shards`' order whose pages it fits now
        (`req.shard`): a rule of the scheduler's own state, so every rank
        of a data axis picks the same shard."""
        self._two_pool = True
        if not self.pending or self.pending[0].arrival_time > now:
            return None
        cand = self.pending[0]
        shard = 0
        if self._sharded():
            shard = next((s for s in self._prefill_shards()
                          if self._fits_now(cand, s)), None)
            if shard is None:
                self._note_block(cand)
                return None
        if (self.pages is not None
                and not self._page_transaction(cand, shard)):
            return None
        self.pending.popleft()
        cand.t_admitted = now
        return cand

    def _prefill_shards(self) -> list[int]:
        """The shards a prefill may stage in, in the order it tries them:
        the fewest staged requests on the ready queue first, then the most
        allocatable pages, then the lowest index (one shard, 0, for an
        unsharded pool)."""
        if not self._sharded():
            return [0]
        depth = [0] * self.pages.n_shards
        for r in self.ready:
            depth[r.shard] += 1
        return sorted(range(self.pages.n_shards), key=lambda s: (
            depth[s], -self.pages.view(s).allocatable(), s))

    def reject_prefill(self, req: Request, now: float,
                       reason: str = "rejected") -> Request:
        """Retire a prefill-pool request without serving it (it can never
        fit the pool / block table); it never held a decode slot."""
        self._finish(None, req, reason, now)
        return req

    def finish_prefill(self, req: Request, first_token: int, now: float,
                       prefill_s: float = 0.0) -> bool:
        """Prefill-pool completion: record TTFT and the first generated
        token, then stage the request on the ready queue for the decode
        pool. A first-token EOS (or a 1-token budget) finishes the request
        right here — its pages free (or park as prefix-cached) without
        ever touching a decode slot. Returns True iff staged."""
        req.t_first_token = now
        req.prefill_s = prefill_s
        self._accept(None, req, int(first_token), now)
        if req.t_done is None:
            self.ready.append(req)
            return True
        return False

    def admit_ready(self, slot_idx: int, now: float) -> Request | None:
        """Bind the next ready (already-prefilled) request to a free
        decode slot. Tier-affine like `_select_pending` — a staged request
        matching the active batch's homogeneous tier is preferred — so the
        two-pool engine phase-separates mixed streams exactly like the
        unified one. The only device work this admission needs is the
        block-table splice (engine._bind): the KV pages were handed off at
        prefill completion. A sharded pool binds only a request staged in
        the slot's own shard (its pages are there)."""
        mine = [j for j, r in enumerate(self.ready)
                if not self._sharded()
                or r.shard == self.pages.shard_of_slot(slot_idx)]
        if not mine:
            return None
        i = mine[0]
        tier = self._active_tier()
        if tier is not None and self.ready[i].tier != tier:
            for j in mine:
                if self.ready[j].tier == tier:
                    i = j
                    break
        req = self.ready[i]
        del self.ready[i]
        if i > mine[0]:
            self.tier_affine_picks += 1
        req.slot = slot_idx
        if self._slot_used[slot_idx]:
            self.refills += 1
        self._slot_used[slot_idx] = True
        self.slots[slot_idx].req = req
        return req

    # ------------------------------------------------------------------
    # decode ticks
    # ------------------------------------------------------------------

    def positions(self) -> np.ndarray:
        """(B,) int32 next-decode positions, derived from request progress
        (free slots report 0). Introspection/tests only — the engine's
        device-side pos vector is the single authoritative copy."""
        return np.array(
            [0 if s.req is None
             else s.req.prompt_len + max(1, s.req.n_generated) - 1
             for s in self.slots], np.int32)

    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    def drained(self) -> bool:
        return (not self.pending and not self.ready
                and self.num_active() == 0)

    def observe(self, chunk_tokens: np.ndarray, now: float,
                mode: str = "exact"):
        """Consume one decode chunk: (steps, B) tokens fetched from device.

        Row s of the chunk is the token each slot emitted at step s. Tokens
        for free slots, and steps after a slot finished mid-chunk, are
        discarded (the device keeps decoding every row; the garbage never
        reaches a request).

        `mode` is the datapath the engine ran this chunk on ("exact" |
        "approx"); accepted tokens are credited to (tier, mode) for the
        energy accounting.
        """
        steps, B = chunk_tokens.shape
        assert B == self.n_slots, (B, self.n_slots)
        for s in range(steps):
            for i, slot in enumerate(self.slots):
                if slot.req is None:
                    continue
                self._accept(slot, slot.req, int(chunk_tokens[s, i]), now,
                             mode=mode)
        self.depth_samples.append(len(self.pending))
        self.ready_depth_samples.append(len(self.ready))
        if self.pages is not None and self.pages.capacity:
            self.page_util_samples.append(
                self.pages.in_use / self.pages.capacity)

    def observe_spec(self, chunk_tokens: np.ndarray, accepted: np.ndarray,
                     now: float, mode: str = "exact"):
        """Consume one speculative decode chunk (engine._spec_chunk_fn):
        `chunk_tokens` (iters, B, k+1) verify-target tokens, `accepted`
        (iters, B) accepted-prefix lengths. Iteration s of slot i emitted
        `chunk_tokens[s, i, :accepted[s, i] + 1]` — the accepted draft
        prefix plus the free verify token; the rejected tail is rolled
        back on device (position non-advance) and discarded here. EOS or
        budget exhaustion inside an iteration retires the request between
        tokens, so post-EOS emissions are dropped exactly like post-finish
        steps in plain `observe`.
        """
        iters, B, k1 = chunk_tokens.shape
        assert B == self.n_slots, (B, self.n_slots)
        for s in range(iters):
            for i, slot in enumerate(self.slots):
                if slot.req is None:
                    continue
                a = int(accepted[s, i])
                self.spec_drafted += k1 - 1
                self.spec_accepted += a
                self.spec_accept_hist[a] = (
                    self.spec_accept_hist.get(a, 0) + 1)
                for t in range(a + 1):
                    if slot.req is None:     # finished mid-iteration
                        break
                    self._accept(slot, slot.req, int(chunk_tokens[s, i, t]),
                                 now, mode=mode)
        self.depth_samples.append(len(self.pending))
        self.ready_depth_samples.append(len(self.ready))
        if self.pages is not None and self.pages.capacity:
            self.page_util_samples.append(
                self.pages.in_use / self.pages.capacity)

    def _accept(self, slot: _Slot | None, req: Request, token: int,
                now: float, mode: str = "exact"):
        # slot=None: prefill-pool request not yet bound to a decode slot
        # (two-pool mode's finish_prefill)
        req.tokens.append(token)
        key = (req.tier, mode)
        self.tier_mode_tokens[key] = self.tier_mode_tokens.get(key, 0) + 1
        if token == self.eos_id:
            self._finish(slot, req, "eos", now)
        elif req.n_generated >= req.max_new_tokens:
            self._finish(slot, req, "length", now)

    def cow_done(self, req: Request):
        """The engine finished copying `req.cow_src` into the request's own
        tail page: release the donor's copy-window lease (it stays cached
        for the next reader) and count the fork."""
        assert req.cow_src is not None
        self.pages.cow_fork(req.cow_src)
        req.cow_src = None

    def _finish(self, slot: _Slot | None, req: Request, reason: str,
                now: float):
        req.finish_reason = reason
        req.t_done = now
        self.finished.append(req)
        if slot is not None:
            slot.req = None
        if self.pages is not None and req.pages:
            # every retirement path — EOS, budget, rejection — returns the
            # request's pages; `req.pages` stays as the record of what ran
            self.pages.free(req.pages)
            if req.cow_src is not None:
                # retired before the engine ran the COW copy (e.g. engine
                # rejection): drop the donor's copy-window lease too
                self.pages.free([req.cow_src])
                req.cow_src = None
        if req.slot >= 0:
            self._freed_slots.append(req.slot)

    def drain_freed(self) -> list[int]:
        """Slots freed since the last call (any retirement reason). Paged
        engines use this to clear the freed rows' device block tables
        before the pages can be reallocated to another slot."""
        freed, self._freed_slots = self._freed_slots, []
        return freed

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def summary(self) -> dict:
        done = self.finished
        ttfts = [r.ttft for r in done if r.ttft is not None]
        gen = sum(r.n_generated for r in done)
        out = {
            "requests": len(done),
            "generated_tokens": gen,       # real tokens, no post-EOS padding
            "prompt_tokens": sum(r.prompt_len for r in done),
            "eos_finishes": sum(1 for r in done if r.finish_reason == "eos"),
            "rejected": sum(1 for r in done
                            if r.finish_reason == "rejected"),
            "slot_refills": self.refills,
            "mean_queue_depth": float(np.mean(self.depth_samples))
            if self.depth_samples else 0.0,
            "max_queue_depth": max(self.depth_samples, default=0),
        }
        if self._two_pool:
            # ready-queue depth percentiles (sampled per decode chunk,
            # like depth_samples): how far ahead the prefill pool runs
            rd = self.ready_depth_samples or [0]
            out["ready_depth_p50"] = float(np.percentile(rd, 50))
            out["ready_depth_p90"] = float(np.percentile(rd, 90))
            out["ready_depth_max"] = int(max(rd))
        if ttfts:
            out["ttft_mean_s"] = float(np.mean(ttfts))
            out["ttft_max_s"] = float(np.max(ttfts))
        rates = [r.decode_tok_s for r in done if r.decode_tok_s]
        if rates:
            out["decode_tok_s_mean_per_req"] = float(np.mean(rates))
        if any(r.tier != "premium" for r in done) or any(
                m != "exact" for _, m in self.tier_mode_tokens):
            # tier section only when the stream actually used the knob
            out["tier_requests"] = {
                t: sum(1 for r in done if r.tier == t) for t in TIERS
                if any(r.tier == t for r in done)}
            out["tier_mode_tokens"] = {
                f"{t}/{m}": n
                for (t, m), n in sorted(self.tier_mode_tokens.items())}
            out["tier_affine_picks"] = self.tier_affine_picks
        if self.spec_drafted:
            out |= {
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "spec_accept_rate": round(
                    self.spec_accepted / self.spec_drafted, 4),
            }
        if self.pages is not None:
            out |= {
                "page_size": self.pages.page_size,
                "pages_total": self.pages.capacity,
                "pages_peak_in_use": self.pages.peak_in_use,
                # three-way split: leased (live block tables), cached
                # (prefix index retains them, refcount 0 — NOT leaks),
                # leaked (unaccounted — must be 0, drained or not)
                "pages_leased": self.pages.leased,
                "pages_cached": self.pages.cached,
                "pages_leaked": self.pages.leaked,
                "page_blocks": self.page_blocks,
                "page_util_mean": round(float(
                    np.mean(self.page_util_samples)), 4)
                if self.page_util_samples else 0.0,
            }
            if self._sharded():
                out["pages_peak_by_shard"] = self.pages.peak_by_shard
            if self.pages.prefix_caching:
                out |= {
                    "prefix_hits": self.prefix_hits,
                    "prefix_tokens_saved": self.prefix_tokens_saved,
                    "cow_forks": self.pages.cow_forks,
                    "prefix_evictions": self.pages.prefix_evictions,
                }
        return out


class ReplicaRouter:
    """Pick-least-loaded routing across N data-parallel engine replicas
    behind one arrival stream (DESIGN.md §10). Load is the outstanding
    token estimate — prompt plus decode budget of everything routed to a
    replica and not yet reported complete — so a burst of long-prompt
    requests spreads instead of round-robining onto one replica. Ties
    break to the lowest index, which makes routing a pure function of the
    submitted stream: replica assignment never depends on wall clock, so
    the REPRO_DISAGG digest contract extends across replicas."""

    def __init__(self, n_replicas: int):
        if n_replicas < 1:
            raise ValueError(f"n_replicas={n_replicas}; want >= 1")
        self.n = int(n_replicas)
        self.outstanding = [0] * self.n   # token estimate in flight
        self.routed = [0] * self.n        # requests sent, lifetime

    def route(self, prompt_len: int, max_new_tokens: int) -> int:
        i = min(range(self.n), key=lambda j: (self.outstanding[j], j))
        self.outstanding[i] += int(prompt_len) + int(max_new_tokens)
        self.routed[i] += 1
        return i

    def complete(self, replica: int, prompt_len: int, max_new_tokens: int):
        """Report a routed request finished. Online servers call this per
        retirement; the offline driver routes the whole stream up-front
        against the submit-time estimates and never calls it."""
        self.outstanding[replica] -= int(prompt_len) + int(max_new_tokens)
        assert self.outstanding[replica] >= 0, (replica, "over-completed")

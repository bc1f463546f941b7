"""Continuous-batching serving engine.

* **Slot table**: batch row == slot. The host-side `SlotScheduler`
  admits queued requests into free slots and retires finished ones
  between decode chunks.
* **Per-slot positions**: the decode step takes a (B,) position vector,
  so sequences at different depths share one decode GEMM batch
  (M = batch rows per GEMM).
* **One host sync per chunk**: `sync_every` decode steps run back to back
  on the device; their tokens are fetched once per chunk.
* **Paged KV** (default, `REPRO_KV=paged`): a global page pool with
  per-slot block tables; the scheduler's `PageAllocator` hands pages out
  at admission. Each admission prefills a dense batch-1 fragment and
  `_insert_impl` scatters it into the pool and binds the slot's
  block-table row.
* **Ring KV** (`REPRO_KV=ring` / `kv_layout="ring"`): a dense per-slot
  ring of `cache_len` rows (`new_cache()`; on the card `cache_len` rounded
  up to a page and at least `max_seq_len`, so the decode kernel walks a
  ring slot as it walks a pool slot of `max_seq_len` tokens: `ring_len`;
  a local layer's ring has `window` rows); an admission's fragment is a
  whole ring row, copied into its slot. No allocator, no prefix cache; a
  request whose prompt plus budget exceeds `cache_len` is rejected (it
  would wrap a global-attention ring). `generate()` (static batches)
  always runs on rings.
* **Disaggregated serving** (`disagg=True`, `REPRO_DISAGG=1`; DESIGN.md
  §10): a prefill pool of `prefill_workers` prefills a chunk stages each
  finished prompt's pages in the shared pool (the handoff: `_scatter_impl`,
  then a device sync) and queues the request; decode admissions bind
  ready requests to free slots (`_bind_impl`), so a decode chunk never
  waits on a prefill's compute. Paged layout only (`disagg_on`); the
  tokens are the unified engine's.
* **Quality tiers** (DESIGN.md §6): a decode chunk runs the approximate
  datapath (`mode="approx"`) only when every active slot is a `bulk`
  request; prefill is always exact. `divergence_probe` measures the
  approximate tier's logits against the exact ones on one prompt.
* **Self-speculative decoding** (DESIGN.md §9; `spec_k >= 1`,
  `REPRO_SPEC_K`, kill switch `REPRO_SPEC_DECODE=0`): each iteration
  drafts `spec_k` tokens with an early-exit forward over the first
  `spec_draft_layers` superblocks, verifies them in one full-depth
  forward whose B·(spec_k + 1) query rows fold into the decode batch,
  and advances each slot by its accepted prefix plus one. Greedy streams
  equal the plain chunked decode's.
* **Prompt-length bucketing** (`bucket_prompts=True`,
  `REPRO_PREFILL_BUCKET=1`): each prefill suffix is right-padded to a
  bucket length (`_bucket_len`), so a mixed stream runs a few prefill
  shapes; padded rows get position -1 and the first token reads the real
  last row. `prefill_compiles` counts the distinct prefill shapes.

* **Local windows** (gemma2, gemma3): a local-window layer keeps a dense
  ring of `window` rows inside the paged layout too, so a paged cache is
  a mixed tree of pool leaves and dense rings; the splices skip or
  row-splice each kind. The prefill fragment is floored at `window`
  tokens (`_frag_floor`), and the floor turns off prefix caching, disagg
  and bucketing, and spec where `spec_k + 1 > window`, as in the JAX
  engine. With spec on, every local ring (pool, fragment and ring
  layout alike) has `window + spec_k` rows rounded up to a page
  (`_local_rows`), so a verify's writes never overwrite a row a live
  window reads (ROADMAP F6; the JAX engine keeps `window` rows and its
  spec stream under local windows is not its plain one).

* **Frontend archs** (whisper, pixtral): `serve()` refuses them, as the
  JAX engine does; `generate(frontend=)` serves them in static batches.
  The encoder-decoder re-encodes its frames at every decode step, as the
  JAX engine does; the VLM prefills [patches ‖ prompt] and decodes from
  position `frontend_tokens + T` without the patches (ROADMAP F8: the
  JAX engine passes them to every decode step, which makes each step a
  fresh prefill of the patches and the one token).

* **MoE** (granite, llama4): every forward the engine runs threads a
  cache, so its MoE layers take the dropless dispatch
  (`model._sublayer`, models/moe.py): no token is dropped,
  and a padded or foreign row never takes a real token's expert slot.
  The engine gates nothing on it, as the JAX engine does not.

* **SSM and hybrid** (mamba2, hymba): every layer keeps a per-slot Mamba2
  state (fp32) and conv tail beside (hymba) or instead of (mamba2) its
  KV. An admission's fragment carries the prompt's final state, which
  `_insert_impl` row-copies into the slot; the pool splices pass the
  state through. mamba2 has no KV to page, so the engine takes the ring
  layout whatever it is asked (`kv_layout` says which it took), and a
  ring request is never rejected for its length. A recurrent state
  cannot un-see a token, so prefix caching, disagg, bucketing and spec
  are off for both families, as in the JAX engine.

* **Tensor parallelism** (a mesh whose `model` axis has N > 1 ranks,
  `parallel.sharding.set_active_mesh`; every family): every rank runs
  this engine on its parameter shards, and every cache, pool and
  fragment is built on the rank's KV heads, padded to a multiple of N
  where N does not divide them (`init_cache(kv_pad_to=, kv_shards=)`;
  an SSM layer's state and conv tail whole on every rank, the mixer's
  gather layout).
  The layers write and attend over the rank's heads; the forward hands
  back whole logits, so every rank picks the same tokens. Every rank
  runs the same host loop: the clock the scheduler reads is rank 0's
  (`_agreed_clock`, one broadcast a reading), so arrivals at a rate
  admit the same requests at the same ticks on every rank, and
  `generate()` times its prefill and decode on it too. A prefill
  fragment is born on the pool's layout (the rank's KV heads), so the
  disagg handoff scatters it as it is: the JAX engine's
  `reshard_handoff` before the scatter has nothing to move here.

* **Data parallelism** (a mesh whose `data` axis has D > 1 ranks; every
  family, beside any `model` axis), the layout of `sharding.cache_specs`:
  - where D divides the batch, data rank r serves the slots [r·B/D,
    (r + 1)·B/D): it holds only their ring rows, SSM states, conv tails,
    token and position vectors (`init_cache(data_shards=)`), decodes only
    them, and a paged pool holds its shard's P/D pages, the block table
    whole with the pool's global page ids (each rank's layers read its
    own rows of it, relative to its first page). One `PageAllocator` a
    data shard (`ShardedPageAllocator`): a slot's pages come only from
    its shard's range, each shard's own first page its trash page, so
    every slot's attention stays on its own rank (no collective in the
    decode step; the decode kernel's plan and F9's runs as in one
    process). The pool is sized D·(⌈(B/D)·cache_len/page⌉ + 1) pages,
    where the JAX package's `pool_pages_for` rounds B·cache_len/page + 1
    up to a multiple of D: each shard keeps its own trash page. A prefill
    runs on the ranks of the owning data coordinate only, so a fragment is
    born on the rank that scatters it (the JAX fragment is replicated
    over `data`; the contents are equal), its first token broadcast over
    `data`; under FSDP (`cfg.fsdp`) every data rank runs every prefill,
    since each forward gathers the layers' weights over `data`. After
    each decode chunk (and spec verify) the ranks all-gather their slots'
    tokens (and accepted counts) over `data`, so every rank's replicated
    `SlotScheduler` sees the whole chunk and admits alike. The prefix
    cache is per shard; the prefill pool stages a request in the shard
    `SlotScheduler.begin_prefill` picks, and a free slot binds the oldest
    ready request of its own shard. `generate()` serves the rank's rows
    of the static batch and gathers the tokens. Sampling (`greedy=False`)
    draws one uniform a slot from the shared generator: every rank draws
    the whole batch's and keeps its slots' (`_pick`), so a slot samples
    with the number it takes in one process. A sampled token therefore
    depends on its slot, and where the two-pool loop binds a request to
    another slot than one process does, its sampled stream is another
    sample (the same on every rank); greedy streams never move.
  - where D does not divide the batch (the batch-1 long-context case),
    the ring layout splits every slot's ring rows into D blocks of R/D
    (`init_cache(data_shards=)`; on the card R/D whole pages). Tokens,
    positions and the forward are replicated: every rank prefills the
    prompt into a whole ring and keeps its block, writes a decode step's
    K/V row only where it holds row pos % R, attends over its rows (the
    decode kernel's log-sum-exp output) and folds the ranks' partial
    attentions by their log-sum-exps (`layers.seq_sharded`). The SSM
    state is replicated, as `cache_specs` has it. A paged pool is refused
    there (`model.check_parallel`).
  The summary's stream digest, request counts and page stats are global,
  the same on every rank.

Where the JAX engine donates the cache buffer to a jitted update, this
engine updates the cache tensors in place (`_scatter_impl`, `_bind_impl`,
`_insert_impl`, `_clear_slot_impl`, the decode step's KV write) and says
so at each site.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import optflags
from repro_torch.core.precision import current_policy, use_policy
from repro_torch.kernels import autotune
from repro_torch.kernels.ops import fused_decode_supported
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import KVCache, PagedKVCache, padded_kvh
from repro_torch.parallel import sharding as S
from repro_torch.train.step import (make_bucketed_prefill_step,
                                    make_draft_step, make_prefill_step,
                                    make_serve_step, make_verify_step)
from .scheduler import PageAllocator, ShardedPageAllocator, SlotScheduler


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def _bucket_len(n: int) -> int:
    """Smallest length of 8, 12, 16, 24, 32, 48, 64, ... that is >= n:
    neighbours are at most 1.5x apart, so bucketed prefill pads at most
    50 % while a mixed-length stream runs O(log) prefill shapes."""
    b = 8
    while b < n:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else b * 4 // 3
    return b


def _draft(draft_step, params, tok, cache, pos, k: int):
    """k greedy early-exit draft steps from each slot's last token at its
    position → (drafts (B, k), cache). The drafts thread the shared cache:
    draft i attends over draft i-1's early-layer keys; the verify later
    rewrites every row a draft wrote."""
    drafts = []
    for _ in range(k):
        logits, cache = draft_step(params, tok[:, None], cache, pos)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        pos = pos + 1
        drafts.append(tok)
    return torch.stack(drafts, dim=1), cache


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: Any, batch: int,
                 cache_len: int, eos_id: int = 2,
                 cache_dtype=torch.float32, sync_every: int = 8,
                 kv_layout: str | None = None, page_size: int = 16,
                 pool_pages: int | None = None,
                 max_seq_len: int | None = None, spec_k: int | None = None,
                 spec_draft_layers: int | None = None,
                 disagg: bool | None = None, prefill_workers: int = 1,
                 bucket_prompts: bool | None = None, device=None):
        """Under the active mesh (`parallel.sharding.active_mesh`) the
        engine serves on its `model` and `data` axes: `params` are this
        rank's shards, every cache holds this rank's KV heads, padded to a
        multiple of the `model` axis's size (`init_cache(kv_pad_to=)`),
        and this data rank's slots, or its block of every ring's rows
        where the `data` axis does not divide `batch` (the module
        docstring).

        `cache_len` is the per-request capacity of the ring layout and
        sizes the paged one's pool: by default it holds `batch · cache_len`
        tokens plus the trash page, while `max_seq_len` (default
        `cache_len`, rounded up to a page) caps one request. `device`
        defaults to the device the parameters live on.

        `spec_k` (default REPRO_SPEC_K, 0 = off) is the self-speculative
        draft length, `spec_draft_layers` the draft's superblocks (default
        half the stack); `disagg` (default REPRO_DISAGG) selects the
        two-pool serve loop, `prefill_workers` the prefills the prefill
        pool runs a chunk; `bucket_prompts` (default REPRO_PREFILL_BUCKET)
        pads prefill suffixes to bucket lengths."""
        M.check_supported(cfg)
        self.mesh = S.active_mesh()
        self.tp = S.axis_count("model")
        # the batch axes together (`data`, or `pod` and `data`, pod-major)
        self.dp = S.batch_count()
        self.dp_rank = S.batch_index()
        # the batch-1 long-context layout: D does not divide the batch, so
        # every ring's rows split over `data` and the forward is replicated
        self.seq_split = batch % self.dp != 0
        dp_all = self.dp
        if self.seq_split:
            # over `data` alone, as `cache_specs` cuts the rows (a `pod`
            # axis holds copies)
            self.dp, self.dp_rank = (S.axis_count("data"),
                                     S.axis_index("data"))
        # the slots this rank decodes: [slot0, slot0 + rows)
        self.rows = batch if self.seq_split else batch // self.dp
        self.slot0 = 0 if self.seq_split else self.dp_rank * self.rows
        kv_layout = kv_layout or optflags.kv_layout()
        if kv_layout not in ("ring", "paged"):
            raise ValueError(
                f"REPRO_KV/kv_layout={kv_layout!r}; want 'ring' or 'paged'")
        if cfg.family == "ssm":
            kv_layout = "ring"   # no KV to page; the state is O(1) a slot
        if self.tp > 1 or dp_all > 1:
            M.check_parallel(cfg, self.tp, dp_all, serving=True,
                             batch=batch, kv_layout=kv_layout)
        if self.tp > 1:
            if padded_kvh(cfg.num_kv_heads, self.tp) % self.tp:
                raise ValueError(
                    f"{cfg.name}: {cfg.num_kv_heads} KV heads do not split "
                    f"over {self.tp} ranks and pad_kv_heads is off")
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device) if device is not None \
            else params["embed"].device
        self.batch = batch
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self.sync_every = max(1, int(sync_every))
        self._disagg_arg = disagg
        self.prefill_workers = max(1, int(prefill_workers))
        self._bucket_arg = bucket_prompts
        self.spec_k = (optflags.spec_k() if spec_k is None
                       else max(0, int(spec_k)))
        n_super = cfg.num_layers // cfg.stack_period
        self.spec_draft_layers = (
            min(max(1, int(spec_draft_layers)), n_super)
            if spec_draft_layers else max(1, n_super // 2))
        self.kv_layout = kv_layout
        self.page_size = int(page_size)
        self.max_seq_len = _round_up(max_seq_len or cache_len, self.page_size)
        self.max_pages = self.max_seq_len // self.page_size
        # a ring's rows: on the card a whole number of pages, at least
        # max_seq_len, so its slots split across the decode kernel's
        # cluster as a pool slot of max_seq_len tokens does (the rows past
        # cache_len stay masked at position -1; the reject rule stays on
        # cache_len)
        self.ring_len = (max(_round_up(cache_len, self.page_size),
                             self.max_seq_len)
                         if self.device.type == "cuda" else cache_len)
        if self.seq_split:
            # each data rank's block of a ring: R/D rows (whole pages on
            # the card)
            self.ring_len = _round_up(self.ring_len, self._ring_quantum())
        # local-window rings survive in the paged layout (bounded by the
        # window, they strand no capacity); a prefill fragment must carry
        # rings of the same length, so fragments, and the pages an
        # admission takes, are floored at `window` tokens
        local = any(cfg.layer_kind(j).get("attn") == "local"
                    for j in range(cfg.stack_period))
        self._frag_floor = (cfg.window if local and cfg.window
                            and cfg.window < self.max_seq_len else 1)
        if self.device.type == "cuda" and local and cfg.window:
            # on the card the decode kernel walks a dense ring as pages of
            # `page_size` rows (`dense_pool_view`): a local ring's rows
            # must split into whole pages
            ring_rows = self._local_rows() or min(
                cfg.window, self.max_seq_len if kv_layout == "paged"
                else self.ring_len)
            if ring_rows % self.page_size:
                raise ValueError(
                    f"{cfg.name}: a local ring of {ring_rows} rows does not "
                    f"split into pages of {self.page_size} rows for the "
                    f"decode kernel; take a page size that divides the "
                    f"window {cfg.window}")
        # +1 a data shard: its reserved trash page (at D > 1 the JAX
        # package's `pool_pages_for` rounds batch·cache_len/page + 1 up to
        # a multiple of D instead; here each shard keeps its own)
        self.pool_pages = int(
            pool_pages
            or self.dp * (_round_up(self.rows * cache_len, self.page_size)
                          // self.page_size + 1))
        if kv_layout == "paged" and self.pool_pages % self.dp:
            raise ValueError(f"a pool of {self.pool_pages} pages does not "
                             f"split over {self.dp} data shards")
        self._prefills: dict[int, Any] = {}
        self._bucketed_prefills: dict[int, Any] = {}
        # distinct prefill shapes run: (prefix_len, T, bucketed), the
        # summary's `prefill_compiles`
        self._prefill_shapes: set[tuple[int, int, bool]] = set()
        self._serve_step = make_serve_step(cfg, self.page_size)
        # decode chunks keyed (steps or iters, greedy, mode, spec_k), 0 for
        # the plain chunk: the JAX engine's jit-cache key
        self._chunks: dict[tuple[int, bool, str, int], Any] = {}
        # non-finite logits counted on the device (`_note_logits`); serve()
        # and generate() reset it
        self._nonfinite = 0
        self.last_stats: dict[str, float] = {}
        # autotune misses during the last serve()'s decode chunks
        self.decode_misses = 0

    def _local_rows(self) -> int | None:
        """The rows of every local-window ring under speculative decoding:
        `window + spec_k` rounded up to a page, where spec is on and a
        local window sits below `max_seq_len` (`_frag_floor > 1`); else
        None, and a local ring keeps `window` rows. A verify writes
        positions pos..pos+k, which in a ring of R rows land on positions
        at most pos + k - R; with R >= window + k those are at most
        pos - window, outside every window a query at pos or later reads,
        where a ring of `window` rows loses rows the verify's earlier rows
        and the next step's query still attend to (ROADMAP F6)."""
        if self._frag_floor == 1 or not self.spec_decoding_on():
            return None
        return _round_up(self.cfg.window + self.spec_k, self.page_size)

    def _heads(self) -> dict:
        """The caches' KV heads: padded to the `model` axis and this
        rank's share of them (every head in one process)."""
        return {"kv_pad_to": self.tp, "kv_shards": self.tp}

    def _ring_quantum(self) -> int:
        """What a ring's rows are rounded up to where they split over
        `data`: D blocks of whole pages on the card (the decode kernel
        walks a block as pages), D rows on the CPU."""
        return self.dp * (self.page_size if self.device.type == "cuda"
                          else 1)

    def new_cache(self, batch: int | None = None, rows: int | None = None):
        """The ring layout's serving cache: this rank's piece (its slots,
        or its block of every ring's rows, `init_cache(data_shards=)`).
        `batch` given: a whole cache of that many rows (a prefill fragment,
        the probe's), on no data shard. `rows` overrides `ring_len`."""
        return M.init_cache(self.cfg, batch or self.batch,
                            rows or self.ring_len, dtype=self.cache_dtype,
                            device=self.device,
                            local_rows=self._local_rows(),
                            data_shards=1 if batch else self.dp,
                            **self._heads())

    def new_pool(self):
        """Paged serve cache: page pools + per-slot block tables (this
        data rank's shard of the pages, and of the dense rows, beside the
        whole block table)."""
        return M.init_cache(self.cfg, self.batch, self.max_seq_len,
                            dtype=self.cache_dtype, device=self.device,
                            paged=(self.pool_pages, self.page_size),
                            local_rows=self._local_rows(),
                            data_shards=self.dp, **self._heads())

    def new_frag(self, prompt_len: int):
        """Dense batch-1 prefill fragment: the prompt rounded up to whole
        pages, and floored at `window` tokens (`_frag_floor`); its local
        rings have the pool's rows (`_local_rows` under spec)."""
        cap = _round_up(max(prompt_len, self._frag_floor), self.page_size)
        return M.init_cache(self.cfg, 1, cap, dtype=self.cache_dtype,
                            device=self.device,
                            local_rows=self._local_rows(), **self._heads())

    def _agreed_clock(self, clock):
        """`clock` as every rank of the mesh reads it: the reading of the
        mesh's first rank (data 0, model 0), broadcast at each call over
        the `data` axis, then over the `model` axis (on the host over
        gloo, on the card over nccl). Every admission, arrival wait and
        fast-forward of `serve` reads it, so the ranks take the same
        decisions at the same ticks and call their collectives in the same
        order. The clock itself without a mesh."""
        if self.tp == 1 and S.batch_count() == 1:
            return clock
        import torch.distributed as dist

        groups = (([S.batch_group()] if S.batch_count() > 1 else [])
                  + ([S.axis_group("model")] if self.tp > 1 else []))
        dev = self.device if dist.get_backend(groups[0]) == "nccl" else "cpu"

        def agreed():
            t = torch.tensor([clock()], dtype=torch.float64, device=dev)
            for group in groups:
                dist.broadcast(t, src=dist.get_global_rank(group, 0),
                               group=group)
            return float(t)

        return agreed

    def _shard_of(self, slot: int) -> int:
        """The data coordinate that holds `slot`'s rows (every rank's own
        where the rings split by rows)."""
        return self.dp_rank if self.seq_split else slot // self.rows

    def _over_data(self) -> bool:
        """Whether the ranks of the `data` axis hold different slots."""
        return self.dp > 1 and not self.seq_split

    def _from_shard(self, value, shard: int):
        """An int that data coordinate `shard` computed (None on the other
        data ranks), on every rank: one broadcast over `data`."""
        if not self._over_data():
            return value
        import torch.distributed as dist

        group = S.batch_group()
        dev = self.device if dist.get_backend(group) == "nccl" else "cpu"
        t = torch.tensor([0 if value is None else int(value)],
                         dtype=torch.int64, device=dev)
        dist.broadcast(t, src=dist.get_global_rank(group, shard),
                       group=group)
        return int(t)

    def _gather_rows(self, x, dim: int = 1):
        """Every data rank's slots' `x` (its rows along `dim`) joined in
        slot order: the whole batch's, on every rank."""
        if not self._over_data():
            return x
        from repro_torch.parallel.collectives import all_gather
        return all_gather(x, dim, S.batch_group())

    def _ring_split(self):
        """The context the decode steps run in: the rings' rows split
        over `data` (`layers.seq_sharded`) where the batch does not."""
        from repro_torch.models.layers import seq_sharded
        return seq_sharded(self.seq_split)

    def prefix_caching_on(self) -> bool:
        """Prefix sharing (REPRO_PREFIX_CACHE, default on) is sound only
        where every prompt page is a pure function of the prompt tokens:
        the paged layout without local-window rings (their fragment floor
        couples neighbours) and without a per-slot recurrent state
        (ssm, hybrid)."""
        return (optflags.prefix_cache_enabled() and self.kv_layout == "paged"
                and self._frag_floor == 1 and not M.has_ssm(self.cfg))

    def disagg_on(self) -> bool:
        """The two-pool split (REPRO_DISAGG / `disagg`, default off) is
        sound exactly where prefix sharing is: a handed-off page run must
        mean the same to whichever decode slot binds it, so pages must be a
        pure function of the prompt: the paged layout without local-window
        rings or a recurrent state. An ineligible engine serves unified,
        without a word, as `spec_decoding_on` does."""
        on = (self._disagg_arg if self._disagg_arg is not None
              else optflags.disagg_enabled())
        return (bool(on) and self.kv_layout == "paged"
                and self._frag_floor == 1 and not M.has_ssm(self.cfg))

    def bucketing_on(self) -> bool:
        """Prompt-length bucketing (REPRO_PREFILL_BUCKET / `bucket_prompts`,
        default off) is sound only without local-window rings (a ring
        write past the real prompt length could wrap onto live rows) and
        without a recurrent state (padding tokens would advance it)."""
        on = (self._bucket_arg if self._bucket_arg is not None
              else optflags.prefill_bucket_enabled())
        return bool(on) and self._frag_floor == 1 and not M.has_ssm(self.cfg)

    def spec_decoding_on(self) -> bool:
        """Self-speculative decoding is armed (`spec_k >= 1` and the
        REPRO_SPEC_DECODE kill switch up) and sound: the stack has at
        least two superblocks to exit early from, and every dense ring (a
        local window; the ring layout) holds the verify block's
        `spec_k + 1` rows without collision: the JAX engine's gate. Where
        it is on, local rings grow to `window + spec_k` rows rounded up to
        a page (`_local_rows`): a ring of `window` rows would lose, to a
        verify's writes, rows that earlier verify rows and a query after a
        rejection attend to, and the JAX engine, which keeps `window`
        rows, gives a spec stream under local windows that is not its
        plain one (ROADMAP F6). An ssm or hybrid state cannot roll back a
        rejected draft, so spec is off for them."""
        n_super = self.cfg.num_layers // self.cfg.stack_period
        min_ring = (self._frag_floor if self._frag_floor > 1
                    else (self.cache_len if self.kv_layout == "ring"
                          else None))
        return (optflags.spec_decode_enabled() and self.spec_k >= 1
                and n_super >= 2 and not M.has_ssm(self.cfg)
                and (min_ring is None or self.spec_k + 1 <= min_ring))

    def _fingerprint(self) -> str:
        """Cache-key component isolating engines whose pages would not be
        interchangeable: config, cache dtype, GEMM backend."""
        raw = f"{self.cfg!r}|{self.cache_dtype}|{optflags.gemm_backend()}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def new_allocator(self) -> PageAllocator | ShardedPageAllocator:
        """The pool's allocator: one `PageAllocator`, or one a data shard
        (`ShardedPageAllocator`) where the slots split over `data`."""
        kw = dict(max_request_pages=self.max_pages,
                  min_request_tokens=self._frag_floor,
                  prefix_caching=self.prefix_caching_on(),
                  fingerprint=self._fingerprint())
        if self.dp > 1:
            return ShardedPageAllocator(self.dp, self.pool_pages,
                                        self.page_size, self.batch, **kw)
        return PageAllocator(self.pool_pages, self.page_size, **kw)

    @property
    def page_base(self) -> int:
        """This data rank's first global page id (0 in one process)."""
        return self.dp_rank * (self.pool_pages // self.dp)

    # ------------------------------------------------------------------
    # cache splices (all in place on the pool tensors)
    # ------------------------------------------------------------------

    @staticmethod
    def _scatter_impl(cache, frag, block_row, keep: int = 0, base: int = 0):
        """Write a batch-1 fragment's rows into the page pool, IN PLACE,
        without touching any block table. Rows land at flat offsets
        `block_row[t // psz] · psz + t % psz` after the positions of every
        page in `block_row` are wiped to -1 (recycled pages still hold the
        previous owner's positions, which the mask would otherwise see).
        The first `keep` pages are shared prefix-cache pages: their wipe
        and writes go to the trash page 0 instead. Dense leaves (local
        rings) have no pool and pass through: `_insert_impl` row-splices
        them, as do SSM states. `base`: the pool holds a data shard's
        pages, global ids [base, base + n_pages), `block_row`'s ids (the
        trash page of `keep` and unmapped entries the shard's own page
        `base`)."""
        for full_c, one_c in zip(cache, frag):
            full, one = full_c.get("kv"), one_c.get("kv")
            if not isinstance(full, PagedKVCache):
                continue
            n_super, n_pages, psz = full.k.shape[:3]
            npp = one.k.shape[2] // psz
            dev = full.k.device
            lane = torch.arange(psz, device=dev)
            row = block_row.to(dev).long()
            row = torch.where(row >= 0, row - base, -1)
            dest_row = torch.where(torch.arange(npp, device=dev) < keep, 0,
                                   row[:npp])
            dest_row = torch.where(dest_row >= 0, dest_row, 0)
            dest = (dest_row[:, None] * psz + lane).reshape(-1)
            wipe_row = torch.where(row >= 0, row, 0)
            wipe_row = torch.where(
                torch.arange(row.shape[0], device=dev) < keep, 0, wipe_row)
            wipe = (wipe_row[:, None] * psz + lane).reshape(-1)
            kf = full.k.view(n_super, n_pages * psz, *full.k.shape[3:])
            vf = full.v.view(n_super, n_pages * psz, *full.v.shape[3:])
            pf = full.positions.view(n_super, n_pages * psz)
            kf[:, dest] = one.k[:, 0].to(kf.dtype)             # in place
            vf[:, dest] = one.v[:, 0].to(vf.dtype)             # in place
            pf[:, wipe] = -1                                    # in place
            pf[:, dest] = one.positions[:, 0].to(pf.dtype)      # in place
        return cache

    @staticmethod
    def _bind_impl(cache, block_row, slot: int):
        """Map a scattered page run into batch row `slot` (in place). Dense
        leaves and SSM states have no block table and pass through."""
        for c in cache:
            if isinstance(c.get("kv"), PagedKVCache):
                bt = c["kv"].block_table
                bt[:, slot] = block_row.to(bt.device, bt.dtype)  # in place
        return cache

    @staticmethod
    def _insert_impl(cache, frag, slot: int, block_row=None, keep: int = 0,
                     base: int = 0, row: int | None = None, block: int = 0):
        """Splice a batch-1 fragment into slot `slot`, in place. Pool
        leaves (`block_row` given): page scatter, then the block-table
        bind. Dense leaves (the ring layout, and local rings in the paged
        one): the fragment's leaf is a whole ring row (`new_cache(batch=1)`,
        or a fragment floored at the window), copied over the slot's row,
        positions included, so nothing of the slot's previous request
        stays visible. SSM leaves (the state and the conv tail) are
        per-slot rows in either layout and are copied the same way, so
        the slot decodes from its prompt's final state. The unified path
        runs both halves here, the two-pool path the pool half at the
        handoff and the bind at admission.

        Under a `data` axis: `base` is the rank's first global page id,
        `row` the slot's row in the rank's dense leaves (default `slot`)
        and `block` the rank's block of a ring whose rows split over
        `data` (`_copy_rows_impl`). `frag` None: another data rank holds
        the slot, and only the block table, whole on every rank, is
        bound."""
        if block_row is not None:
            if frag is not None:
                cache = ServeEngine._scatter_impl(cache, frag, block_row,
                                                  keep, base)
            cache = ServeEngine._bind_impl(cache, block_row, slot)
        if frag is None:
            return cache
        return ServeEngine._copy_rows_impl(
            cache, frag, slot if row is None else row, block)

    @staticmethod
    def _copy_rows_impl(cache, frag, row: int, block: int = 0):
        """`_insert_impl`'s dense half: the fragment's ring rows (the ring
        layout, local rings) and SSM state and tail copied over cache row
        `row`, in place. Where the cache's rings hold one data rank's
        block of R/D rows (the rows split over `data`), the fragment's
        whole ring gives block `block` of them."""
        for full_c, one_c in zip(cache, frag):
            pairs = list(zip(full_c.get("ssm", ()), one_c.get("ssm", ())))
            if isinstance(full_c.get("kv"), KVCache):
                pairs += zip(full_c["kv"], one_c["kv"])
            for full, one in pairs:
                src = one[:, 0]
                if src.shape[1:] != full.shape[2:]:
                    n = full.shape[2]
                    src = src[:, block * n:(block + 1) * n]
                full[:, row] = src.to(full.dtype)               # in place
        return cache

    @staticmethod
    def _load_prefix_impl(frag, cache, src_row, prefix_len: int,
                          base: int = 0):
        """Load a shared prompt prefix from pool pages into the dense
        fragment's first `prefix_len` rows (in place on the fragment).
        `src_row` holds the source page ids in sequence order (the hit
        pages, plus the copy-on-write donor's partial page last). Dense
        leaves and SSM states are left as they are (prefix caching is off
        where a stack has local rings or a recurrent state). `base`: the
        pool's first global page id (a data shard's pool)."""
        for one_c, full_c in zip(frag, cache):
            one, full = one_c.get("kv"), full_c.get("kv")
            if not isinstance(full, PagedKVCache):
                continue
            n_super, _, psz = full.k.shape[:3]
            dev = full.k.device
            lane = torch.arange(psz, device=dev)
            src = ((src_row.to(dev).long()[:, None] - base) * psz
                   + lane).reshape(-1)[:prefix_len]
            kf = full.k.reshape(n_super, -1, *full.k.shape[3:])[:, src]
            vf = full.v.reshape(n_super, -1, *full.v.shape[3:])[:, src]
            one.k[:, 0, :prefix_len] = kf.to(one.k.dtype)       # in place
            one.v[:, 0, :prefix_len] = vf.to(one.v.dtype)       # in place
            one.positions[:, 0, :prefix_len] = torch.arange(
                prefix_len, dtype=one.positions.dtype, device=dev)
        return frag

    @staticmethod
    def _clear_slot_impl(cache, slot: int, row: int | None = None,
                         held: bool = True):
        """Free a slot's cache row, in place. Pool leaves: unmap its
        block-table rows so its decode writes fall to the trash page
        before its pages are reused. Dense leaves (rings, local rings):
        set its positions to -1 (every row masked). SSM states stay: the
        next admission overwrites the row whole. Under a `data` axis: `row`
        is the slot's row in the rank's dense leaves (default `slot`);
        `held` False, another data rank holds the slot, and only the block
        table, whole on every rank, is unmapped."""
        for c in cache:
            kv = c.get("kv")
            if isinstance(kv, PagedKVCache):
                kv.block_table[:, slot] = -1                    # in place
            elif kv is not None and held:
                kv.positions[:, slot if row is None else row] = -1
        return cache

    def _local_row(self, slot: int) -> int | None:
        """`slot`'s row in this rank's caches and token and position
        vectors; None where another data rank holds it."""
        if self._shard_of(slot) != self.dp_rank:
            return None
        return slot - self.slot0

    def _prefill_for(self, prefix_len: int):
        fn = self._prefills.get(prefix_len)
        if fn is None:
            fn = self._prefills[prefix_len] = make_prefill_step(
                self.cfg, prefix_len)
        return fn

    def _bucketed_prefill_for(self, prefix_len: int):
        fn = self._bucketed_prefills.get(prefix_len)
        if fn is None:
            fn = self._bucketed_prefills[prefix_len] = \
                make_bucketed_prefill_step(self.cfg, prefix_len)
        return fn

    def _pick(self, logits, greedy: bool, gen, spread: bool = True):
        """Next tokens from (..., V) logits: argmax, or a sample: the first
        token whose cumulative probability exceeds a uniform drawn from the
        explicit generator, one a row. `spread`: the leading dim holds this
        data rank's slots of the batch, so the uniforms of every data
        rank's slots are drawn and this rank's kept. Each slot then samples
        with the number it takes in one process, and the ranks'
        generators stay in step (`_skip_pick` for a pick made on another
        rank)."""
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        n = flat.shape[0]
        if spread and self._over_data():
            u = self._uniforms(n * self.dp, gen)
            u = u[self.dp_rank * n:(self.dp_rank + 1) * n]
        else:
            u = self._uniforms(n, gen)
        cdf = flat.cumsum(dim=-1)
        idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
        return idx[:, 0].clamp_max(flat.shape[-1] - 1).to(
            torch.int32).reshape(probs.shape[:-1])

    def _uniforms(self, n: int, gen):
        return torch.rand((n,), generator=gen, dtype=torch.float32,
                          device=self.device)

    def _skip_pick(self, greedy: bool, gen):
        """The generator's draw of a batch-1 `_pick` another data rank
        made: keeps this rank's generator in step with it."""
        if not greedy:
            self._uniforms(1, gen)

    def _page_row(self, req):
        """The request's -1-padded (max_pages,) page run on the device and
        its shared leading page count; (None, None) on the ring layout."""
        if self.kv_layout != "paged":
            return None, None
        r = np.full((self.max_pages,), -1, np.int32)
        r[:len(req.pages)] = req.pages
        return (torch.from_numpy(r).to(self.device),
                req.shared_tokens // self.page_size)

    def _admit_prefill(self, scheduler, req, cache, greedy: bool, gen,
                       shard: int):
        """`_prefill_request` where data coordinate `shard` holds the
        request's slot or pages: there it runs and its first token is
        broadcast over `data`; elsewhere only the scheduler's copy-on-write
        accounting runs (every rank's scheduler is the same), and under
        FSDP the prefill too, its results dropped (each forward gathers
        the weights over `data`, so every data rank runs every forward).
        Returns (frag or None, first, row, keep)."""
        mine = shard == self.dp_rank or not self._over_data()
        if mine or self.cfg.fsdp:
            frag, first, row, keep = self._prefill_request(
                scheduler, req, cache, greedy, gen, owner=mine)
        else:
            if req.cow_src is not None:
                scheduler.cow_done(req)
            self._skip_pick(greedy, gen)
            row, keep = self._page_row(req)
            frag = first = None
        return (frag if mine else None, self._from_shard(
            first if mine else None, shard), row, keep)

    def _prefill_request(self, scheduler, req, cache, greedy: bool, gen,
                         owner: bool = True):
        """Build the dense fragment (prefix-cache load included), prefill
        the uncached suffix and pick the first token. Returns (frag,
        first, row, keep): `row` is the -1-padded (max_pages,) page run,
        `keep` the shared leading page count (both None on the ring
        layout, whose fragment is a whole ring row). With bucketing on the
        suffix is padded to `_bucket_len(suffix)` where that still fits
        one request (`max_seq_len`, or the ring's `cache_len`); a paged
        fragment rounded up past the request's pages scatters its padding
        pages to the trash page (`_scatter_impl`). `owner` False (a data
        rank that runs an FSDP prefill in step with the owner): no prefix
        load from pages it does not hold, no logits counted."""
        paged = self.kv_layout == "paged"
        shared = req.shared_tokens if paged else 0
        suffix = req.prompt_len - shared
        Tb = suffix
        bucketed = self.bucketing_on()
        if bucketed:
            b = _bucket_len(suffix)
            if shared + b <= (self.max_seq_len if paged else self.cache_len):
                Tb = b
        frag = (self.new_frag(shared + Tb) if paged
                else self.new_cache(batch=1))
        if shared:
            src = list(req.pages[:shared // self.page_size])
            if req.cow_src is not None:
                src.append(req.cow_src)
            if owner:
                frag = self._load_prefix_impl(
                    frag, cache, torch.tensor(src, dtype=torch.int32),
                    shared, self.page_base)
            if req.cow_src is not None:
                scheduler.cow_done(req)
        padded = np.zeros((1, Tb), np.int32)
        padded[0, :suffix] = req.prompt[shared:]
        tokens = torch.from_numpy(padded).to(self.device)
        self._prefill_shapes.add((shared, Tb, bucketed))
        if bucketed:
            logits, frag = self._bucketed_prefill_for(shared)(
                self.params, tokens, frag, suffix - 1, req.prompt_len)
        else:
            logits, frag = self._prefill_for(shared)(self.params, tokens,
                                                     frag)
        if owner:
            self._note_logits(logits)
        first = int(self._pick(logits[:, -1], greedy, gen, spread=False)[0])
        return (frag, first) + self._page_row(req)

    def _must_reject(self, req) -> bool:
        """A just-admitted request the engine cannot serve. Paged: the
        allocator marked it unallocatable (more pages than the pool or the
        per-request block table holds). Ring: prompt plus budget would
        wrap the global-attention ring (an SSM stack has none: its state
        is O(1) a slot)."""
        if self.kv_layout == "paged":
            return req.pages is None
        return (self.cfg.family != "ssm"
                and req.prompt_len + req.max_new_tokens > self.cache_len)

    def _note_logits(self, logits):
        # device-side count of non-finite logits over the real vocabulary
        # (padding columns are -inf by design); read once after serving
        bad = (~torch.isfinite(logits[..., :self.cfg.vocab_size])).sum()
        self._nonfinite = self._nonfinite + bad

    def _chunk_fn(self, steps: int, greedy: bool, mode: str = "exact"):
        """`steps` decode iterations back to back, no host sync inside.

        Returns run(params, tok, cache, pos, frontend, gen) → (tok, cache,
        pos, gen, toks (steps, B)); the caller fetches `toks` once per
        chunk. `mode` selects the SA datapath for the chunk's policy."""
        key = (steps, greedy, mode, 0)      # 0: the non-speculative chunk
        if key not in self._chunks:
            serve_step = self._serve_step

            def run(params, tok, cache, pos, frontend, gen):
                pol = dataclasses.replace(current_policy(), mode=mode)
                toks = []
                with use_policy(pol), self._ring_split():
                    for _ in range(steps):
                        logits, cache = serve_step(params, tok[:, None],
                                                   cache, pos, frontend)
                        self._note_logits(logits)
                        tok = self._pick(logits[:, -1], greedy, gen)
                        pos = pos + 1
                        toks.append(tok)
                return tok, cache, pos, gen, torch.stack(toks)

            self._chunks[key] = run
        return self._chunks[key]

    def _spec_chunk_fn(self, iters: int, greedy: bool, mode: str, k: int):
        """`iters` draft-then-verify iterations back to back, no host sync
        inside. Each drafts k tokens a slot with the early-exit step (greedy
        whatever the sampling), scores [tok ‖ drafts] with one verify
        forward and advances every slot by its accepted prefix plus one:

        * verify column t's target is the token plain decode would emit at
          position pos + t, so the longest prefix where draft == target is
          correct output, and column `acc` rides free (a reject-all
          iteration still emits one token);
        * rollback is the position's non-advance: verify writes past the
          new position stay masked (positions <= pos) and the next
          iteration overwrites them in place.

        Returns run(params, tok, cache, pos, frontend, gen) → (tok, cache,
        pos, gen, toks (iters, B, k+1), accs (iters, B)); the caller
        fetches `toks` and `accs` once per chunk and hands them to
        `scheduler.observe_spec`. `mode` selects the SA datapath."""
        key = (iters, greedy, mode, k)
        if key not in self._chunks:
            draft_step = make_draft_step(self.cfg, self.spec_draft_layers,
                                         self.page_size)
            verify_step = make_verify_step(self.cfg, self.page_size)

            def run(params, tok, cache, pos, frontend, gen):
                if frontend is not None:
                    raise ValueError("serve() is text-only")
                pol = dataclasses.replace(current_policy(), mode=mode)
                toks, accs = [], []
                with use_policy(pol), self._ring_split():
                    for _ in range(iters):
                        drafts, cache = _draft(draft_step, params, tok,
                                               cache, pos, k)   # (B, k)
                        block = torch.cat([tok[:, None], drafts], dim=1)
                        logits, cache = verify_step(params, block, cache,
                                                    pos)
                        self._note_logits(logits)
                        out = self._pick(logits, greedy, gen)  # (B, k+1)
                        match = (drafts == out[:, :-1]).to(torch.int32)
                        acc = torch.cumprod(match, dim=1).sum(dim=1).to(
                            torch.int32)                         # (B,)
                        tok = torch.gather(out, 1, acc[:, None].long())[:, 0]
                        pos = pos + acc + 1
                        toks.append(out)
                        accs.append(acc)
                return (tok, cache, pos, gen, torch.stack(toks),
                        torch.stack(accs))

            self._chunks[key] = run
        return self._chunks[key]

    def spec_timing_probe(self, reps: int = 3) -> dict:
        """Per-iteration wall time of the draft (k early-exit steps) and of
        the verify at this engine's serving shapes, on a fresh cache (the
        same operations; serve() cannot split the two without a sync
        between them). Timed with CUDA events on the card and the host
        clock on the CPU. Returns {"draft_s", "verify_s"}."""
        k = self.spec_k
        draft_step = make_draft_step(self.cfg, self.spec_draft_layers,
                                     self.page_size)
        verify_step = make_verify_step(self.cfg, self.page_size)
        cache = (self.new_pool() if self.kv_layout == "paged"
                 else self.new_cache())
        zeros = torch.zeros((self.rows,), dtype=torch.int32,
                            device=self.device)
        block = torch.zeros((self.rows, k + 1), dtype=torch.int32,
                            device=self.device)

        def draft():
            with self._ring_split():
                _draft(draft_step, self.params, zeros, cache, zeros, k)

        def verify():
            with self._ring_split():
                verify_step(self.params, block, cache, zeros)

        cuda = self.device.type == "cuda"
        out = {}
        for name, fn in (("draft_s", draft), ("verify_s", verify)):
            fn()                                            # warm
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                end.synchronize()
                out[name] = start.elapsed_time(end) / 1000.0 / reps
            else:
                t = time.monotonic()
                for _ in range(reps):
                    fn()
                out[name] = (time.monotonic() - t) / reps
        return out

    # ------------------------------------------------------------------
    # quality-tier instrumentation
    # ------------------------------------------------------------------

    def macs_per_token(self) -> int:
        """Model MACs per generated token ≈ the parameter count (every
        dense weight element is one MAC a token at decode); feeds the
        per-tier energy model (core/energy.py). The parameter tree keeps
        the JAX package's leaves and shapes (padded vocabulary included),
        so this is the JAX engine's count."""
        return int(sum(t.numel() for t in M.tree_leaves(self.params)))

    def _probe_logits(self, prompt, steps: int):
        """The divergence probe's logits, each (steps, vocab_size) fp32
        numpy over the real vocabulary: the exact pass (greedy from the
        prefill's token) and the approximate pass teacher-forced on the
        exact pass's tokens. Both decode from the same post-prefill cache:
        the decode step writes the cache in place, so the approximate
        pass starts from a copy taken before the exact pass runs."""
        prompt = [int(t) for t in prompt]
        T = len(prompt)
        if T + steps > self.cache_len:
            raise ValueError(f"probe needs {T + steps} cache slots; "
                             f"engine has {self.cache_len}")
        V = self.cfg.vocab_size
        cache0 = self.new_cache(batch=1)
        tokens = torch.tensor(prompt, dtype=torch.int32,
                              device=self.device)[None]
        with use_policy(dataclasses.replace(current_policy(), mode="exact")):
            logits, cache0 = self._prefill_for(0)(self.params, tokens, cache0)
        first = int(torch.argmax(logits[0, -1, :V]))
        cache_a = M.tree_map(torch.clone, cache0)

        def run_mode(mode, cache, teacher):
            pol = dataclasses.replace(current_policy(), mode=mode)
            rows, tok = [], first
            with use_policy(pol):
                for i in range(steps):
                    if teacher is not None:
                        tok = teacher[i]
                    logits, cache = self._serve_step(
                        self.params,
                        torch.tensor([[tok]], dtype=torch.int32,
                                     device=self.device),
                        cache, torch.tensor([T + i], dtype=torch.int32,
                                            device=self.device))
                    row = logits[0, -1, :V].to(torch.float32).cpu().numpy()
                    rows.append(row)
                    tok = int(row.argmax())
            return np.stack(rows)

        le = run_mode("exact", cache0, None)
        teacher = [first] + [int(r.argmax()) for r in le[:-1]]
        la = run_mode("approx", cache_a, teacher)
        return le, la

    def divergence_probe(self, prompt, steps: int = 16) -> dict:
        """The bulk tier's divergence from the exact datapath on this
        engine's weights: prefill `prompt` once, exact, on a batch-1
        dense cache; decode `steps` tokens exact, then teacher-force the
        same tokens through the approximate datapath from the same cache
        state, and compare each step's next-token logits.

        Returns {"steps", "max_ulp", "kl_mean", "max_abs_diff"}: max_ulp is
        the largest per-logit distance in units in the last place (the
        ordered int32 mapping), kl_mean the mean per-step KL(exact ‖
        approx) of the next-token distributions. The logits are compared
        over the real vocabulary: the padding logits are -inf in both
        passes (the JAX probe, which keeps them, reports NaN for
        kl_mean and max_abs_diff where the vocabulary is padded)."""
        le, la = self._probe_logits(prompt, steps)

        def ordered(x):
            b = x.view(np.int32).astype(np.int64)
            return np.where(b < 0, -(b & 0x7FFFFFFF), b)

        max_ulp = int(np.max(np.abs(ordered(le) - ordered(la))))
        pe = torch.log_softmax(torch.from_numpy(le), dim=-1)
        pa = torch.log_softmax(torch.from_numpy(la), dim=-1)
        kl = torch.sum(torch.exp(pe) * (pe - pa), dim=-1)
        return {"steps": int(steps), "max_ulp": max_ulp,
                "kl_mean": float(torch.mean(kl)),
                "max_abs_diff": float(np.max(np.abs(le - la)))}

    # ------------------------------------------------------------------
    # static-batch generation
    # ------------------------------------------------------------------

    def generate(self, prompts, max_new_tokens: int, frontend=None,
                 greedy: bool = True, rng: torch.Generator | None = None):
        """prompts (B, T) int → (B, ≤ max_new_tokens) int32 tensor on the
        CPU.

        Static batch on a ring cache: one batched prefill, then lock-step
        decode in chunks of `sync_every` steps; EOS is checked once per
        fetched chunk, so a batch that finishes early stops at chunk
        granularity. `last_stats` records the prefill/decode wall split
        and the non-finite logits over the real vocabulary.

        `frontend` (B, S, d_model) feeds a frontend arch. The
        encoder-decoder passes it to every forward, so every decode step
        re-runs the encoder, as the JAX engine does. A VLM passes it to
        the prefill only, over a ring of at least S + T + max_new_tokens
        rows (rounded up to a page on the card), and decodes from
        position S + T: the greedy stream is the one full forwards over
        [patches ‖ prompt ‖ generated] give (ROADMAP F8; the JAX engine
        hands the patches to every decode step, where its forward
        prepends them to the one token, and starts decoding at T).

        Under a `data` axis that divides the batch, each data rank
        prefills and decodes its own rows of `prompts` (and `frontend`)
        and the tokens are gathered over `data` a chunk, so every rank
        returns the whole batch's; where it does not divide the batch,
        every rank prefills the whole batch into whole rings, keeps its
        block of their rows and decodes under `layers.seq_sharded`."""
        prompts = torch.as_tensor(prompts, dtype=torch.int32,
                                  device=self.device)
        B, T = prompts.shape
        assert B == self.batch, (B, self.batch)
        gen = rng
        if gen is None and not greedy:
            gen = torch.Generator(device=self.device).manual_seed(0)
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        vlm = self.cfg.family == "vlm" and frontend is not None
        if frontend is not None:
            frontend = torch.as_tensor(frontend, device=self.device)
        mine = slice(self.slot0, self.slot0 + self.rows)
        prompts = prompts[mine]
        if frontend is not None:
            frontend = frontend[mine]
        clock = self._agreed_clock(time.monotonic)
        t0 = clock()
        rows = None
        if vlm:
            # F8: the ring holds the patches, the prompt and every new
            # token; decode starts after the patches and the prompt, and
            # no decode step sees the patches again
            rows = frontend.shape[1] + T + max_new_tokens
            if self.device.type == "cuda":
                rows = _round_up(rows, self.page_size)
            rows = max(rows, self.ring_len)
            if self.seq_split:
                rows = _round_up(rows, self._ring_quantum())
            start, step_frontend = frontend.shape[1] + T, None
        else:
            start, step_frontend = T, frontend
        # where the rings split by rows, the prompts fill whole rings and
        # each rank keeps its block
        cache = (self.new_cache(batch=B, rows=rows) if self.seq_split
                 else self.new_cache(rows=rows))
        logits, cache = self._prefill_for(0)(self.params, prompts, cache,
                                             frontend)
        if self.seq_split:
            part = self.new_cache(rows=rows)
            for b in range(B):
                part = self._copy_rows_impl(part, M.tree_map(
                    lambda t, b=b: t[:, b:b + 1], cache), b, self.dp_rank)
            cache = part
        self._note_logits(logits)
        tok = self._pick(logits[:, -1], greedy, gen)
        # sync: the prefill boundary (TTFT)
        first = self._gather_rows(tok, 0).cpu().numpy()
        t_prefill = clock() - t0
        pos = torch.full((self.rows,), start, dtype=torch.int32,
                         device=self.device)
        cols = [first]
        done = first == self.eos_id
        while len(cols) < max_new_tokens and not done.all():
            steps = min(self.sync_every, max_new_tokens - len(cols))
            tok, cache, pos, gen, toks = self._chunk_fn(steps, greedy)(
                self.params, tok, cache, pos, step_frontend, gen)
            t_np = self._gather_rows(toks).cpu().numpy()  # a chunk's sync
            cols.extend(t_np)
            done |= (t_np == self.eos_id).any(axis=0)
        self.last_stats = {"prefill_s": t_prefill,
                           "decode_s": clock() - t0 - t_prefill,
                           "decode_tokens": (len(cols) - 1) * B,
                           "nonfinite_logits": self._nonfinite_total()}
        return torch.from_numpy(np.stack(cols, axis=1).astype(np.int32))

    def _nonfinite_total(self) -> int:
        """The non-finite logits counted on the device, over every data
        rank's slots."""
        n = self._nonfinite
        if self._over_data():
            from repro_torch.parallel.collectives import all_reduce
            n = all_reduce(n.reshape(1).clone(), S.batch_group())
        return int(n.sum())

    # ------------------------------------------------------------------
    # continuous batching
    # ------------------------------------------------------------------

    def serve(self, scheduler: SlotScheduler, greedy: bool = True,
              rng: torch.Generator | None = None,
              clock=time.monotonic) -> dict:
        """Run the continuous-batching loop until the scheduler drains.
        Per-request results live on `scheduler.finished`; returns
        `scheduler.summary()` merged with the engine's wall-time split
        (`prefill_busy_s`, `decode_busy_s`, `handoff_s`, `decode_stall_s`),
        `disagg` (the two-pool loop ran; the scheduler then adds
        `ready_depth_p50`) and `nonfinite_logits` (logits over the real vocabulary that were not
        finite, prefill, decode and verify); `chunks_exact` and
        `chunks_approx` where an approximate chunk ran; with speculative
        decoding on, `spec_k`, `spec_draft_layers`, `spec_iters` and
        `spec_accept_hist` beside the scheduler's `spec_drafted`,
        `spec_accepted` and `spec_accept_rate`."""
        assert scheduler.n_slots == self.batch, (
            scheduler.n_slots, self.batch)
        if self.cfg.family == "vlm" or self.cfg.is_encdec:
            # prefill and decode below run frontend=None: a vlm/enc-dec
            # arch would skip its frontend and generate garbage
            raise ValueError(
                "continuous serving is text-only (per-slot frontends are a "
                "ROADMAP item); use ServeEngine.generate for frontend archs")
        B = self.batch
        paged = self.kv_layout == "paged"
        if paged and scheduler.pages is None:
            scheduler.pages = self.new_allocator()
        gen = rng
        if gen is None and not greedy:
            gen = torch.Generator(device=self.device).manual_seed(0)
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        clock = self._agreed_clock(clock)
        t0 = clock()
        skew = 0.0          # engine-time fast-forward for frozen clocks

        def now():
            return clock() - t0 + skew

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        cache = self.new_pool() if paged else self.new_cache()
        # this rank's slots' tokens and positions (the whole batch's in
        # one process)
        tok = torch.zeros((self.rows,), dtype=torch.int32,
                          device=self.device)
        pos = torch.zeros((self.rows,), dtype=torch.int32,
                          device=self.device)
        # the wall split: handoff = the page scatter and block-table
        # writes; decode_stall = admission wall while another slot waits
        # to decode (unified: the whole prefill and insert; two-pool: only
        # the synced handoff, what a prefill pool on devices of its own
        # would leave). One device serves both pools here, so the stall is
        # the modelled decode-blocking time; wall_s and ITL are measured.
        prefill_s = decode_s = handoff_s = decode_stall_s = 0.0
        chunk_modes = {"exact": 0, "approx": 0}
        spec = self.spec_decoding_on()
        disagg = self.disagg_on()
        # a spec iteration emits 1..spec_k+1 tokens: the chunk's emission
        # capacity matches the plain chunk's sync_every tokens
        spec_iters = (max(1, -(-self.sync_every // (self.spec_k + 1)))
                      if spec else 0)
        spec_chunks = 0

        # warm-up chunk before the timed loop (kernel libraries load on
        # first use). Safe on the fresh cache: no block table is mapped,
        # so paged writes land on the trash page, and an admission
        # overwrites a ring row whole; tok/pos are discarded.
        t_c = clock()
        # the autotuner's lookups that fell back to the heuristic during
        # the decode chunks (the warm-up's too): 0 once every decode shape
        # is tuned (`launch/serve.py --autotune-decode`)
        misses0 = autotune.MISSES
        warm = (self._spec_chunk_fn(spec_iters, greedy, "exact", self.spec_k)
                if spec else self._chunk_fn(self.sync_every, greedy))
        cache = warm(self.params, tok, cache, pos, None, gen)[1]
        sync()
        compile_s = clock() - t_c
        self.decode_misses = autotune.MISSES - misses0

        def clear_freed():
            # unmap freed slots before their pages can be reallocated (a
            # ring row is masked whole until its next admission)
            nonlocal cache
            for freed in scheduler.drain_freed():
                # the block table is whole on every rank, the rows on the
                # data rank that holds the slot
                row = self._local_row(freed)
                cache = self._clear_slot_impl(cache, freed, row,
                                              held=row is not None)

        while not scheduler.drained():
            clear_freed()
            if disagg:
                # decode-pool admissions: bind already-prefilled requests
                # off the ready queue (a block-table write, no prefill
                # compute), so free slots refill between chunks at the
                # handoff's cost only (a sharded pool binds a slot only
                # to a request staged in its own shard)
                for slot in scheduler.free_slots():
                    req = scheduler.admit_ready(slot, now())
                    if req is None:
                        if scheduler.ready_depth() == 0:
                            break
                        continue
                    t_h = now()
                    cache = self._bind_impl(cache, self._page_row(req)[0],
                                            slot)
                    # the first token came from finish_prefill: resume
                    # after it
                    row = self._local_row(slot)
                    if row is not None:
                        tok[row] = req.tokens[0]
                        pos[row] = req.prompt_len
                    handoff_s += now() - t_h
                # prefill pool: up to `prefill_workers` prefills a chunk,
                # stopping once the ready queue could refill every slot
                n_pf = 0
                while (n_pf < self.prefill_workers
                       and scheduler.ready_depth() < B):
                    req = scheduler.begin_prefill(now())
                    if req is None:
                        break
                    if self._must_reject(req):
                        scheduler.reject_prefill(req, now())
                        continue
                    t_p = now()
                    frag, first, row, keep = self._admit_prefill(
                        scheduler, req, cache, greedy, gen, req.shard)
                    dt = now() - t_p
                    prefill_s += dt
                    # the handoff: scatter the staged fragment's pages into
                    # the pool (on the data rank that holds the shard's
                    # pages), then sync: the one wall decode can block on
                    # (the fragment holds the pool's KV heads already, so
                    # no reshard between the two pools)
                    t_h = now()
                    if frag is not None:
                        cache = self._scatter_impl(cache, frag, row, keep,
                                                   self.page_base)
                    sync()
                    dt_h = now() - t_h
                    handoff_s += dt_h
                    if scheduler.num_active() > 0:
                        decode_stall_s += dt_h
                    # register BEFORE the scheduler sees the first token: a
                    # first-token EOS retires the request at once, and its
                    # registered pages must park as cached
                    scheduler.pages.prefix_register(req.prompt, req.pages,
                                                    req.tier)
                    scheduler.finish_prefill(req, first, now(), prefill_s=dt)
                    n_pf += 1
            else:
                for slot in scheduler.free_slots():
                    req = scheduler.admit(slot, now())
                    if req is None:
                        if isinstance(scheduler.pages, ShardedPageAllocator):
                            # another shard's pages may still take it
                            continue
                        break
                    if self._must_reject(req):
                        scheduler.reject(slot, now())
                        continue
                    t_p = now()
                    frag, first, row, keep = self._admit_prefill(
                        scheduler, req, cache, greedy, gen,
                        self._shard_of(slot))
                    t_h = now()
                    # the pages scattered and the rows copied where this
                    # rank holds the slot (`frag` None elsewhere), the
                    # block-table row bound on every rank
                    cache = self._insert_impl(
                        cache, frag, slot, row, keep, self.page_base,
                        self._local_row(slot), self.dp_rank)
                    if paged:
                        # register the prompt's pages BEFORE the scheduler
                        # sees the first token: a first-token EOS retires
                        # the request at once, and registered pages must
                        # park as cached
                        scheduler.pages.prefix_register(req.prompt,
                                                        req.pages, req.tier)
                    handoff_s += now() - t_h
                    local = self._local_row(slot)
                    if local is not None:
                        tok[local] = first
                        pos[local] = req.prompt_len
                    dt = now() - t_p
                    prefill_s += dt
                    if scheduler.num_active() > 1:
                        decode_stall_s += dt
                    scheduler.start(slot, first, now(), prefill_s=dt)
            clear_freed()

            if scheduler.num_active() == 0:
                if scheduler.ready_depth() > 0:
                    # staged but unbound work: the next pass binds it
                    continue
                nxt = scheduler.next_arrival()
                if nxt is None:
                    break
                wait = nxt - now()
                if wait > 0:
                    before = clock()
                    time.sleep(min(wait, 0.05))
                    if clock() == before:
                        skew += wait
                continue

            # the chunk's datapath: approximate only when EVERY active slot
            # is a bulk request (the tier is a quality floor: bulk slots
            # that share a chunk with premium ones get exact arithmetic);
            # tier-affine admission phase-separates mixed streams so
            # all-bulk chunks occur
            active_tiers = {s.req.tier for s in scheduler.slots
                            if s.req is not None}
            mode = "approx" if active_tiers == {"bulk"} else "exact"
            chunk_modes[mode] += 1
            t_d = now()
            misses0 = autotune.MISSES
            if spec:
                tok, cache, pos, gen, toks, accs = self._spec_chunk_fn(
                    spec_iters, greedy, mode, self.spec_k)(
                    self.params, tok, cache, pos, None, gen)
                # the chunk's host sync (the whole batch's, gathered
                # over `data`)
                toks_np = self._gather_rows(toks).cpu().numpy()
                accs_np = self._gather_rows(accs).cpu().numpy()
                decode_s += now() - t_d
                spec_chunks += 1
                scheduler.observe_spec(toks_np, accs_np, now(), mode=mode)
            else:
                tok, cache, pos, gen, toks = self._chunk_fn(
                    self.sync_every, greedy, mode)(self.params, tok, cache,
                                                   pos, None, gen)
                # the chunk's single host sync (the whole batch's)
                toks_np = self._gather_rows(toks).cpu().numpy()
                decode_s += now() - t_d
                scheduler.observe(toks_np, now(), mode=mode)
            self.decode_misses += autotune.MISSES - misses0

        summary = scheduler.summary()
        if chunk_modes["approx"]:
            summary |= {"chunks_exact": chunk_modes["exact"],
                        "chunks_approx": chunk_modes["approx"]}
        summary |= {"prefill_s": round(prefill_s, 4),
                    "decode_s": round(decode_s, 4),
                    "compile_s": round(compile_s, 4),
                    "wall_s": round(now(), 4),
                    "prefill_busy_s": round(prefill_s, 4),
                    "decode_busy_s": round(decode_s, 4),
                    "handoff_s": round(handoff_s, 4),
                    "decode_stall_s": round(decode_stall_s, 4),
                    "prefill_compiles": len(self._prefill_shapes),
                    "disagg": disagg}
        if spec_chunks:
            summary |= {"spec_k": self.spec_k,
                        "spec_draft_layers": self.spec_draft_layers,
                        "spec_iters": spec_chunks * spec_iters,
                        "spec_accept_hist": dict(sorted(
                            scheduler.spec_accept_hist.items()))}
        if paged:
            # the paged decode-attention path the chunks ran (`gather` and
            # the ring attend over dense rows: on the card through the
            # paged-decode kernel, on the CPU through decode_attention)
            impl = optflags.decode_attn_impl()
            if impl == "fused" and not fused_decode_supported(
                    current_policy()):
                impl = "gather"
            summary["decode_attn"] = impl
        summary["nonfinite_logits"] = self._nonfinite_total()
        served = summary["requests"] - summary["rejected"]
        if decode_s > 0 and served:
            decode_tokens = summary["generated_tokens"] - served
            summary["decode_tok_s"] = round(decode_tokens / decode_s, 2)
        self.last_stats = summary
        return summary

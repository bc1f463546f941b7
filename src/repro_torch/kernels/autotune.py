"""Tile and cluster autotuner for the port's SA GEMM and paged decode (the
JAX package's `repro/kernels/autotune.py`, with the Hopper kernels' knobs).

What is tuned:

* the SA GEMM's `mma` route (bf16 x bf16): the tile `mma_plan(tile=)`
  takes, per (M, N, K, dtype, epilogue) — `decode` (one m16 row block, W by
  TMA; swept only where M <= 32), `small` (64 x 64) and `large` (128 x 128
  on `wgmma`), and the heuristic's own (`default_tile`: `mma_plan`'s rule,
  DECODE_MAX_M and `large_pays`). K is never split on any tile, so every
  candidate gives the same bits (ROADMAP F2) and only the time differs.
  The other routes are not tuned: `split3`, `simt` and `partial` have one
  plan each, fixed by their order of sums (`fp32_k_plan`, ROADMAP F2b), so
  the JAX package's backward blocks (`_bwd_blocks`) have no counterpart;
* the paged decode's cluster size (`n_split` of `split_plan`), per (g, hd,
  page size, pages a slot, pool dtype): every n_split from 1 to
  MAX_CLUSTER that `split_plan` admits, deduplicated by the plan it gives.
  The key has no batch (the JAX key has one): a slot's blocks, and so its
  bits, are then the same in any batch, as ROADMAP F2 requires. Another
  n_split sums the cluster's partials in another order, so it may change
  the output's last bits.

Winners live in two layers: an in-process dict on tuple keys, which the hot
path reads (`lookup`, `lookup_decode_attn`: one dict access, no string
built, no file read after the first), and a JSON file shared across
processes (default ``~/.cache/repro_torch/autotune.json``, or
``REPRO_AUTOTUNE_CACHE``), keyed by `torch.cuda.get_device_name()`::

    {"version": 1,
     "entries": {"NVIDIA H100 80GB HBM3|4x5120x5120|bfloat16|none":
                     {"tile": "decode", "us": 41.2},
                 "NVIDIA H100 80GB HBM3|dattn|5x128|16x9|float32":
                     {"n_split": 6, "us": 14.9}}}

An entry that does not parse as one of these (another device's are read
but not used; a JAX package entry, `{"blocks": [...]}`, is skipped) is kept
when the file is rewritten. A corrupt or unreadable file is ignored. Writes
merge under an flock and replace the file by a rename.

A lookup sweeps only when asked (`sweep=True`, or ``REPRO_AUTOTUNE=1``),
never while a CUDA graph is being captured; otherwise a miss returns the
heuristic, counted in `MISSES`, and is not remembered, so a later sweep in
the same process can still take the key. With no cache entry every lookup
gives the choice the kernels made before the tuner existed.

Timing runs the kernel itself (`sa_matmul._launch` with the tile forced,
`paged_decode_cuda` with n_split given) on the card: CUDA events around
each call after a 256 MB write that evicts L2, a warm-up call, the median
of `reps`. The sweep's launches are taken back out of the kernels' launch
counters, so a tuned run counts only its own launches. On the CPU the port
runs the plain versions and consults no cache; `tune` there needs a
`timer` (tests drive the sweep, the cache and the lookups with a fake one).
"""
from __future__ import annotations

import contextlib
import json
import os

try:
    import fcntl
except ImportError:  # pragma: no cover - non-posix
    fcntl = None

import torch

from . import sa_decode_attention as _decode
from . import sa_matmul as _mm

_VERSION = 1
# (m, n, k, dtype, epilogue) -> tile; (g, hd, psz, max_pages, dtype) ->
# n_split. Only entries of this process's device.
_MEM: dict[tuple, str] = {}
_MEM_DATTN: dict[tuple, int] = {}
_DISK_LOADED = False
_DEVICE: str | None = None

MISSES = 0    # lookups that fell back to the heuristic
# every sweep run since `reset()`, in order: {"kind": "gemm", "key": (m, n,
# k, dtype, epilogue), ...} or {"kind": "decode_attn", "key": (g, hd, psz,
# max_pages, dtype), ...}, with the heuristic's choice, the winner and each
# candidate's µs
SWEPT: list[dict] = []

# M up to which the decode tile (one m16 row block a block) is swept
DECODE_SWEEP_MAX_M = 32
MMA_CANDIDATES = ("decode", "small", "large")

_POOL_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                     torch.float16: "float16"}


def device_name() -> str:
    """The cache's namespace: the card's name (`cpu` without one)."""
    global _DEVICE
    if _DEVICE is None:
        _DEVICE = (torch.cuda.get_device_name()
                   if torch.cuda.is_available() else "cpu")
    return _DEVICE


def production_dtype() -> str:
    """The operand type the SA GEMM's `mma` route takes on the card: the
    policy casts bf16 in there (`PrecisionPolicy.cast_in`). The CPU runs
    the plain version and never looks the cache up."""
    return "bfloat16"


def cache_path() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


def gemm_key(m: int, n: int, k: int, dtype: str, epilogue: str) -> str:
    return f"{device_name()}|{m}x{n}x{k}|{dtype}|{epilogue}"


def decode_attn_key(g: int, hd: int, psz: int, max_pages: int,
                    dtype: str) -> str:
    return f"{device_name()}|dattn|{g}x{hd}|{psz}x{max_pages}|{dtype}"


def _parse(key: str, ent):
    """(which dict, tuple key, value) of a port entry of this device, or
    None for anything else (another device, a JAX entry, junk)."""
    prefix = device_name() + "|"
    if not key.startswith(prefix) or not isinstance(ent, dict):
        return None
    parts = key[len(prefix):].split("|")
    try:
        if parts[0] == "dattn" and len(parts) == 4:
            g, hd = (int(x) for x in parts[1].split("x"))
            psz, pages = (int(x) for x in parts[2].split("x"))
            n = int(ent["n_split"])
            if not 1 <= n <= _decode.MAX_CLUSTER:
                return None
            return _MEM_DATTN, (g, hd, psz, pages, parts[3]), n
        if len(parts) == 3:
            m, n, k = (int(x) for x in parts[0].split("x"))
            tile = ent["tile"]
            if tile not in MMA_CANDIDATES:
                return None
            return _MEM, (m, n, k, parts[1], parts[2]), tile
    except (KeyError, TypeError, ValueError):
        return None
    return None


def _read_disk() -> dict:
    """The file's entries; a corrupt or missing file is empty."""
    try:
        with open(cache_path()) as f:
            data = json.load(f)
        entries = data.get("entries", {})
        if data.get("version") != _VERSION or not isinstance(entries, dict):
            return {}
        return entries
    except (OSError, ValueError, AttributeError):
        return {}


def _load_disk_once():
    global _DISK_LOADED
    if _DISK_LOADED:
        return
    _DISK_LOADED = True
    for key, ent in _read_disk().items():
        got = _parse(key, ent)
        if got is not None:
            got[0].setdefault(got[1], got[2])


@contextlib.contextmanager
def _file_lock(path: str):
    """flock-serialized read-merge-write, so concurrent tuners keep each
    other's entries (a no-op where flock is missing)."""
    if fcntl is None:
        yield
        return
    with open(f"{path}.lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def _write_disk(key: str, entry: dict):
    """Merge one entry into the JSON file (flock, then a tmp-rename)."""
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with _file_lock(path):
            entries = _read_disk()
            entries[key] = entry
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"version": _VERSION, "entries": entries}, f,
                          indent=1)
            os.replace(tmp, path)
    except OSError:
        pass  # a read-only file system: the in-process dict still works


def reset():
    """Forget the in-process entries and counters (a fresh process)."""
    global _DISK_LOADED, _DEVICE, MISSES
    _MEM.clear()
    _MEM_DATTN.clear()
    SWEPT.clear()
    _DISK_LOADED = False
    _DEVICE = None
    MISSES = 0


def _sweep_wanted(sweep: bool | None) -> bool:
    if sweep is None:
        sweep = os.environ.get("REPRO_AUTOTUNE", "0") not in ("0", "false",
                                                              "off")
    return bool(sweep) and not (torch.cuda.is_available()
                                and torch.cuda.is_current_stream_capturing())


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _uncounted():
    """Take a sweep's launches back out of the kernels' counters."""
    saved = [(m, name, dict(v) if isinstance(v, dict) else v)
             for m in (_mm, _decode)
             for name, v in vars(m).items()
             if name.isupper() and (name.endswith(("LAUNCHES", "CALLS"))
                                    or name == "OPERAND_COPIES")]
    try:
        yield
    finally:
        for m, name, v in saved:
            if isinstance(v, dict):
                getattr(m, name).update(v)
            else:
                setattr(m, name, v)


def cuda_time_us(fn, reps: int = 5) -> float:
    """Median microseconds of `fn()` on the card: a warm-up call, then
    `reps` calls, each after a 256 MB write that evicts L2, between CUDA
    events."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(max(1, reps)):
        flush.bitwise_not_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    times = sorted(e0.elapsed_time(e1) * 1e3 for e0, e1 in events)
    mid = len(times) // 2
    return times[mid] if len(times) % 2 else (times[mid - 1] + times[mid]) / 2


def _need_card(what: str):
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"autotune.{what} times the kernel on a CUDA device and none is "
            f"available; on the CPU the port runs the plain versions, which "
            f"have nothing to tune (pass timer= to drive the sweep)")


def _gemm_timer(m, n, k, dtype, epilogue, reps):
    _need_card("tune")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    a = torch.randn((m, k), generator=g, device="cuda").to(dt)
    w = (torch.randn((k, n), generator=g, device="cuda") * k ** -0.5).to(dt)
    bias = (torch.zeros((n,), device="cuda") if epilogue != "none"
            else None)

    def time_tile(tile):
        with _uncounted():
            return cuda_time_us(lambda: _mm._launch(
                a, w, bias, None, epilogue, "exact", False, tile=tile), reps)
    return time_tile


# ---------------------------------------------------------------------------
# the SA GEMM's tile
# ---------------------------------------------------------------------------

def default_tile(m: int, n: int, sms: int = 132) -> str:
    """The heuristic: `mma_plan`'s own tile for an (m, n) bf16 output."""
    return _mm.mma_plan(m, n, "mma", sms)["tile"]


def candidates_for(m: int, n: int, k: int, sms: int = 132) -> list[str]:
    """The `mma` tiles swept for (m, n, k): the heuristic's first (a tie
    keeps it), then `decode` where m <= DECODE_SWEEP_MAX_M, `small` and
    `large`. Each is a tile `mma_plan(tile=)` takes."""
    out = [default_tile(m, n, sms)]
    for tile in MMA_CANDIDATES:
        if tile == "decode" and m > DECODE_SWEEP_MAX_M:
            continue
        if tile not in out:
            out.append(tile)
    return out


def tune(m: int, n: int, k: int, *, dtype: str = "bfloat16",
         epilogue: str = "none", reps: int = 5, timer=None
         ) -> tuple[str, list[dict]]:
    """Time every candidate tile; remember, write and return the winner.

    Returns (tile, table), the table's rows {"tile": ..., "us": ...}
    fastest first. `timer(tile) -> µs` replaces the card's timing (tests);
    without it this runs on the card or raises."""
    _load_disk_once()
    time_tile = timer or _gemm_timer(m, n, k, dtype, epilogue, reps)
    table = [{"tile": c, "us": float(time_tile(c))}
             for c in candidates_for(m, n, k)]
    table.sort(key=lambda r: r["us"])
    best = table[0]["tile"]
    key = (m, n, k, dtype, epilogue)
    _MEM[key] = best
    _write_disk(gemm_key(*key), {"tile": best, "us": round(table[0]["us"], 2)})
    SWEPT.append({"kind": "gemm", "key": key,
                  "heuristic": default_tile(m, n), "winner": best,
                  "us": {r["tile"]: r["us"] for r in table}})
    return best, table


def tune_decode(n: int, k: int, ms: tuple[int, ...] = (1, 4, 8), *,
                dtype: str = "bfloat16", reps: int = 5, timer=None
                ) -> dict[int, str]:
    """Seed the cache with the decode GEMMs' tiles: M in `ms` against one
    (K, N) weight. A serving engine calls this once before its first
    decode chunk. A shape already in the cache keeps its entry (no
    sweep)."""
    _load_disk_once()
    return {m: _MEM.get((m, n, k, dtype, "none"))
            or tune(m, n, k, dtype=dtype, reps=reps, timer=timer)[0]
            for m in ms}


def tune_spec_verify(n: int, k: int, batch: int, spec_k: int, *,
                     dtype: str = "bfloat16", reps: int = 5, timer=None
                     ) -> dict[int, str]:
    """Seed the speculative decode's GEMM shapes (DESIGN.md §9): the draft
    and plain decode rows at M = batch, and the verify, which folds each
    slot's k + 1 rows into the batch, at M = batch·(spec_k + 1)."""
    return tune_decode(n, k, ms=(batch, batch * (spec_k + 1)), dtype=dtype,
                       reps=reps, timer=timer)


def lookup(m: int, n: int, k: int, *, dtype: str = "bfloat16",
           epilogue: str = "none", sweep: bool | None = None,
           sms: int = 132) -> str:
    """The tile for an (m, n, k) `mma` GEMM: memory (the file read once
    a process) → the bare GEMM's entry for an epilogue key (the epilogue
    is O(M·N) against the GEMM's O(M·N·K), so its tile transfers) → a
    sweep, if asked and no graph is being captured → the heuristic,
    counted in MISSES and not remembered."""
    global MISSES
    if not _DISK_LOADED:
        _load_disk_once()
    hit = _MEM.get((m, n, k, dtype, epilogue))
    if hit is None and epilogue != "none":
        hit = _MEM.get((m, n, k, dtype, "none"))
    if hit is not None:
        return hit
    if _sweep_wanted(sweep):
        return tune(m, n, k, dtype=dtype, epilogue=epilogue)[0]
    MISSES += 1
    return default_tile(m, n, sms)


# ---------------------------------------------------------------------------
# the paged decode's cluster size
# ---------------------------------------------------------------------------

def default_decode_attn_blocks(g: int, hd: int, psz: int,
                               max_pages: int) -> int:
    """The heuristic: `split_plan`'s own n_split for the slot."""
    return _decode.split_plan(g, hd, psz, max_pages).n_split


def decode_attn_candidates(g: int, hd: int, psz: int,
                           max_pages: int) -> list[int]:
    """Every cluster size `split_plan(n_split=)` admits for the slot, the
    heuristic's first, each given once by the n_split it launches (a
    requested size the rounded run length shrinks is the smaller one)."""
    seen = [default_decode_attn_blocks(g, hd, psz, max_pages)]
    for n in range(1, _decode.MAX_CLUSTER + 1):
        try:
            got = _decode.split_plan(g, hd, psz, max_pages, n_split=n).n_split
        except ValueError:
            continue
        if got not in seen:
            seen.append(got)
    return seen


def _decode_attn_timer(batch, kvh, g, hd, psz, max_pages, dtype, mapped,
                       reps):
    _need_card("tune_decode_attn")
    from repro_torch.core.precision import PrecisionPolicy, current_policy

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    n_pages = batch * max_pages + 1
    dt = getattr(torch, dtype)
    k_pool = torch.randn((n_pages, psz, kvh, hd), generator=gen,
                         device=dev).to(dt)
    v_pool = torch.randn((n_pages, psz, kvh, hd), generator=gen,
                         device=dev).to(dt)
    bt = torch.full((batch, max_pages), -1, dtype=torch.int32, device=dev)
    pp = torch.full((n_pages, psz), -1, dtype=torch.int32, device=dev)
    for b in range(batch):
        ids = 1 + b * max_pages + torch.arange(mapped, device=dev)
        bt[b, :mapped] = ids.to(torch.int32)
        pp[ids] = torch.arange(mapped * psz, dtype=torch.int32,
                               device=dev).reshape(mapped, psz)
    pos = torch.full((batch,), mapped * psz - 1, dtype=torch.int32,
                     device=dev)
    q = torch.randn((batch, 1, kvh * g, hd), generator=gen, device=dev)
    pol = current_policy()
    if not _decode.fused_decode_supported(pol):
        pol = PrecisionPolicy()

    def time_split(n):
        with _uncounted():
            return cuda_time_us(lambda: _decode.paged_decode_cuda(
                q, k_pool, v_pool, pp, bt, pos, policy=pol, n_split=n), reps)
    return time_split


def tune_decode_attn(batch: int, kvh: int, g: int, hd: int, psz: int,
                     max_pages: int, *, dtype: str | None = None,
                     mapped_pages: int | None = None, reps: int = 5,
                     timer=None) -> tuple[int, list[dict]]:
    """Time every cluster size for one paged decode workload; remember,
    write and return the winner, `tune`-style: (n_split, table of
    {"n_split": ..., "us": ...} fastest first). Timed on a synthetic pool
    of `batch` slots with `mapped_pages` pages mapped a slot (default half
    the block table, the JAX package's setup); `dtype` is the pool's
    (default fp32, the engine's). The entry's key has no batch. An entry
    already in the cache is returned as it is, with an empty table.
    `timer(n_split) -> µs` replaces the card's timing (tests)."""
    _load_disk_once()
    dtype = dtype or "float32"
    key = (g, hd, psz, max_pages, dtype)
    if key in _MEM_DATTN:
        return _MEM_DATTN[key], []
    mapped = min(mapped_pages or max(1, max_pages // 2), max_pages)
    time_split = timer or _decode_attn_timer(batch, kvh, g, hd, psz,
                                             max_pages, dtype, mapped, reps)
    table = [{"n_split": n, "us": float(time_split(n))}
             for n in decode_attn_candidates(g, hd, psz, max_pages)]
    table.sort(key=lambda r: r["us"])
    best = table[0]["n_split"]
    _MEM_DATTN[key] = best
    _write_disk(decode_attn_key(*key),
                {"n_split": best, "us": round(table[0]["us"], 2)})
    SWEPT.append({"kind": "decode_attn", "key": key,
                  "heuristic": default_decode_attn_blocks(g, hd, psz,
                                                          max_pages),
                  "winner": best,
                  "us": {r["n_split"]: r["us"] for r in table}})
    return best, table


def lookup_decode_attn(g: int, hd: int, psz: int, max_pages: int, *,
                       dtype=torch.float32, sweep: bool | None = None,
                       batch: int = 1, kvh: int = 1) -> int:
    """The cluster size for a slot of `max_pages` pages: memory → a sweep
    (on `batch` slots of `kvh` KV heads), if asked and no graph is being
    captured → the heuristic, counted in MISSES. `dtype` is the pool's
    (a torch dtype or its name)."""
    global MISSES
    if not _DISK_LOADED:
        _load_disk_once()
    name = _POOL_DTYPE_NAMES.get(dtype, dtype)
    hit = _MEM_DATTN.get((g, hd, psz, max_pages, name))
    if hit is not None:
        return hit
    if _sweep_wanted(sweep):
        return tune_decode_attn(batch, kvh, g, hd, psz, max_pages,
                                dtype=name)[0]
    MISSES += 1
    return default_decode_attn_blocks(g, hd, psz, max_pages)

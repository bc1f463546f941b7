"""Request-stream serving driver for the PyTorch port: Poisson arrivals
through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --batch 4 --requests 8 --prompt-lens 32,64,128 --max-new 16 --rate 0

`--arch` takes the dense decoders qwen2.5-14b, phi3-medium-14b, gemma2-9b
and gemma3-12b, the MoE decoders granite-moe-3b-a800m and
llama4-maverick-400b-a17b (whose 800 GB do not fit one card: at full width
it is served cut in depth through the engine, as chip_smoke does), the
SSM mamba2-2.7b and the hybrid hymba-1.5b, at full size or `--reduced`.
A MoE layer serves through the dropless dispatch. mamba2 has no KV, so the
engine serves it on per-slot rows (its ring layout) whatever `--kv` asks;
for both SSM families the prefix cache, `--disagg`, `--bucket-prompts` and
`--spec-k` are off (a recurrent state can neither be shared by prefix nor
roll back), as in the JAX engine: the `[engine]` line and the summary's
`kv_layout` say which layout and gates the engine took. Runs on CUDA
unless `--device cpu` is given (with `--reduced` that is the CPU smoke
run). The GEMM backend is REPRO_GEMM_BACKEND (`torch`, the
plain version, `cuda`, the hand-written SA GEMM kernel, or `emulate`, the
paper's bit-exact skewed datapath through the fp_emu kernel). The summary
line `[continuous] k=v ...` and its `stream_digest` are the JAX driver's.

The frontend archs, whisper-tiny (encoder-decoder) and pixtral-12b (VLM),
take the JAX driver's static-wave path (`serve_static`): `--requests`
prompts in waves of `--batch` through `ServeEngine.generate`, each wave's
prompts and frontend (frame or patch embeddings) drawn from a seeded
`torch.Generator`; the summary line is `[static] ...`.

`--kv ring` serves on per-slot dense rings instead of the paged pool.
`--tier-mix p` marks each request `bulk` with probability p (drawn after
its prompt, so the prompts do not depend on p): a decode chunk whose
slots are all bulk runs the approximate datapath. With a mix the driver
also runs the engine's divergence probe on one prompt (the `[divergence]`
line) and adds the per-tier energy model's `energy_*` and the probe's
`divergence_*` keys to the summary, as the JAX driver does.

`--spec-k k` serves with self-speculative decoding (k drafts a slot from
an early exit after `--spec-draft-layers` superblocks, default half the
stack, then one folded verify); the summary gains `spec_*` and a `[spec]`
line gives the draft/verify split (the engine's `spec_timing_probe`,
scaled by the iterations run). Greedy streams equal `REPRO_SPEC_DECODE=0`'s.
`--spec-warmup n` first trains the fp32 weights n AdamW steps on a seeded
Markov corpus, so a shallow draft has something to agree with.
`--bucket-prompts` pads each prefill to a bucket length (summary:
`prefill_compiles`), with the same stream digest.

`--autotune-decode` sweeps the decode step's SA GEMM tiles at M = batch
(and the verify's M = batch·(k + 1) with `--spec-k`) and, on the paged
layout, the paged decode's cluster size before the first decode chunk
(`preseed_decode_blocks`, the JAX driver's shapes). Winners persist in the
autotuner's JSON cache (`kernels/autotune.py`: ``REPRO_AUTOTUNE_CACHE``,
default ``~/.cache/repro_torch/autotune.json``); a shape already there is
not swept again. It times the kernels, so it needs the card: with
`--device cpu` it is refused. `[autotune]` lines give each sweep's
candidates and times, and the summary gains `autotune_sweeps`, the chosen
`autotune_tiles` (MxNxK:tile) and `autotune_n_split`
(g x hd x page x pages:n_split), and `autotune_decode_misses`, the decode
chunks' lookups that found no entry.

`--disagg` serves with two pools (DESIGN.md §10): `--prefill-workers`
prefills a chunk stage their pages in the shared pool and a ready queue
feeds decode admissions; the summary gains `ready_depth_p50`, and the
digest is the unified run's. `--decode-replicas N` routes the stream up
front to N engine replicas (`serve_replicas`), which serve one after
another on the same weights; the `[replicas xN]` line aggregates them.

Under torchrun (or any launcher that sets the torch.distributed
environment) the world becomes a ("data", "model") mesh with
`--model-parallel` ranks innermost (`parallel.mesh.make_host_mesh`, as
the train driver builds it). Every family serves tensor-parallel on the
`model` axis (a MoE layer's experts split over the ranks where the axis
divides them, else each expert's columns, the dropless dispatch on the
rank's experts; a Mamba2 mixer's projections on the rank's pieces, its
conv and SSD whole on every rank; the frontend archs' static waves on the
same seeded frames or patches on every rank; the logits gathered whole)
and data-parallel on the `data` axis (`serve/engine.py`: where the axis
divides `--batch` each data rank serves its own slots from its own range
of the pool's pages, one page allocator a data shard; where it does not,
every slot's ring rows split over `data`, which needs `--kv ring`):

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen2.5-14b --reduced --device cpu --model-parallel 2 \
        --batch 2 --requests 4 --max-new 8 --prompt-lens 6,10 --rate 0
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen2.5-14b --reduced --device cpu --model-parallel 1 \
        --batch 1 --requests 2 --max-new 8 --prompt-lens 40 --kv ring \
        --cache-len 64 --rate 0

Every rank draws its shards of the `--seed` weights (`init_params(...,
mesh=)`: the one-process model), its caches hold its KV heads (padded
to a multiple of the axis where it does not divide them) and its data
shard, and every rank runs the same host loop on rank 0's clock. Rank 0
prints the `[mesh] backend=... world=... data=... model=... device=...`
line first and the summary lines; every rank ends with one line `[rank
r] data=... slots=... pages=... stream_digest=... peak_mem_gib=...
sa_matmul_launches=... decode_attn_launches=... prefill_attn_launches=...
plain_calls=...` (its data coordinate, the slots it decodes, and the
global ids of its pages with the most it leased at once). Refused under a
mesh: a paged pool where the data axis does not divide `--batch`
(`model.check_parallel`), `--model-parallel` N > 1 without a launcher,
`--decode-replicas`, `--autotune-decode` and `--spec-warmup`. `--layers
N` cuts the config's depth (a full-width model cut in depth).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import types

import numpy as np
import torch

from repro_torch.configs import cut_depth, get_config, reduced_config
from repro_torch.core import optflags
from repro_torch.core.device import resolve_device
from repro_torch.core.energy import tier_energy_summary
from repro_torch.kernels import autotune
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import SlotScheduler


def build_requests(sched: SlotScheduler, cfg, n: int, rate: float,
                   prompt_lens: list[int], max_new: int, seed: int,
                   tier_mix: float = 0.0, prefix_mix: float = 0.0,
                   prefix_len: int = 32):
    """Queue `n` synthetic requests, a pure function of `seed` (the JAX
    driver's stream: the same seed gives the same prompts)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, prefix_len)
    t = 0.0
    for i in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        plen = prompt_lens[i % len(prompt_lens)]
        prompt = rng.integers(0, cfg.vocab_size, plen)
        if rng.random() < prefix_mix:
            prompt = np.concatenate([system, prompt])
        tier = "bulk" if rng.random() < tier_mix else "premium"
        sched.submit(prompt, max_new_tokens=max_new, arrival_time=t,
                     tier=tier)


def spec_warmup_train(cfg, params, steps: int, seed: int):
    """Seed-pure warm-up training for the speculative-decoding demo (the
    JAX driver's): `steps` AdamW steps (constant lr 3e-3, no weight decay)
    on an order-1 Markov corpus whose dominant successors are drawn once
    from `seed` and taken with p = 0.9, learnable by the early layers
    alone. `params` are fp32 masters, trained in place and returned with
    gradients off. A pure function of (cfg, params, seed)."""
    from repro_torch.models import model as M_
    from repro_torch.train.optimizer import AdamW, constant_lr
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import TrainState

    rng = np.random.default_rng(seed + 11)
    succ = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size)
    dev = params["embed"].device

    def markov_batch(bsz=8, T=32):
        toks = np.empty((bsz, T + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=bsz)
        for t in range(T):
            toks[:, t + 1] = np.where(
                rng.random(bsz) < 0.9, succ[toks[:, t]],
                rng.integers(0, cfg.vocab_size, size=bsz))
        return {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                "labels": torch.from_numpy(toks[:, 1:]).to(dev)}

    opt = AdamW(constant_lr(3e-3), weight_decay=0.0)
    step = make_train_step(dataclasses.replace(cfg, remat=False), opt)
    for p in M_.tree_leaves(params):
        p.requires_grad_(True)
    state = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params=params, opt_state=opt.init(params))
    metrics = {}
    for _ in range(steps):
        state, metrics = step(state, markov_batch())
    print(f"[spec-warmup] steps={steps} "
          f"final_loss={float(metrics.get('loss', float('nan'))):.3f}")
    for p in M_.tree_leaves(state.params):
        p.requires_grad_(False)
    return state.params


def preseed_decode_blocks(cfg, batch: int, page_size: int | None = None,
                          max_pages: int | None = None, spec_k: int = 0
                          ) -> dict:
    """Tune the decode step's kernels before serving starts (the JAX
    driver's `preseed_decode_blocks`): the SA GEMM tile of each (N, K) the
    decode step's projections run — QKV, out-proj, FFN up and down, the
    lm_head — at M = batch (a decode step's GEMMs flatten (B, 1, D) to
    (B, D)); epilogue keys (the silu'd gate) fall back to these bare-GEMM
    entries. With `spec_k` > 0 also the verify forward's M = batch·(spec_k
    + 1) (`tune_spec_verify`). With `page_size` and `max_pages` (the paged
    layout) also the paged decode's cluster size for slots of `max_pages`
    pages of the engine's fp32 pool. A shape already cached is not
    swept.
    Returns the choices: {"gemm": {(m, n, k): tile}, "decode_attn": {(g,
    hd, page_size, max_pages): n_split}}."""
    dtype = autotune.production_dtype()
    d, hd = cfg.d_model, cfg.hd
    shapes = {(cfg.num_heads * hd, d), (cfg.num_kv_heads * hd, d),
              (d, cfg.num_heads * hd), (cfg.padded_vocab, d)}
    ff = cfg.d_ff_dense or cfg.d_ff
    if ff:
        shapes |= {(ff, d), (d, ff)}
    choices = {"gemm": {}, "decode_attn": {}}
    for n, k in sorted(shapes):
        if spec_k:
            got = autotune.tune_spec_verify(n, k, batch, spec_k, dtype=dtype)
        else:
            got = autotune.tune_decode(n, k, ms=(batch,), dtype=dtype)
        choices["gemm"] |= {(m, n, k): tile for m, tile in got.items()}
    if page_size and max_pages:
        kvh = cfg.num_kv_heads
        g = cfg.num_heads // kvh
        n_split, _ = autotune.tune_decode_attn(batch, kvh, g, hd, page_size,
                                               max_pages)
        choices["decode_attn"][(g, hd, page_size, max_pages)] = n_split
    return choices


def _print_sweeps(sweeps) -> None:
    for r in sweeps:
        times = " ".join(f"{c}={us:.2f}" for c, us in r["us"].items())
        if r["kind"] == "gemm":
            m, n, k, dtype, epi = r["key"]
            what = f"gemm M={m} N={n} K={k} {dtype} {epi}: tile us"
        else:
            g, hd, psz, pages, dtype = r["key"]
            what = (f"decode_attn g={g} hd={hd} page={psz} pages={pages} "
                    f"{dtype}: n_split us")
        print(f"[autotune] {what} {times} -> {r['winner']} (heuristic "
              f"{r['heuristic']})")


def itl_p50_ms(finished) -> float | None:
    itls = [(r.t_done - r.t_first_token) / (r.n_generated - 1)
            for r in finished
            if r.t_first_token is not None and r.t_done is not None
            and r.n_generated >= 2]
    if not itls:
        return None
    return round(float(np.percentile(itls, 50)) * 1000, 3)


def stream_digest(finished) -> str:
    """sha1 of the rid-ordered token streams (the JAX driver's digest)."""
    streams = ",".join(
        f"{r.rid}:{'-'.join(map(str, r.tokens))}"
        for r in sorted(finished, key=lambda r: r.rid))
    return hashlib.sha1(streams.encode()).hexdigest()[:16]


def _print_phases(summary) -> None:
    print(f"[phases] disagg={summary.get('disagg')} "
          f"prefill_busy={summary.get('prefill_busy_s')}s "
          f"decode_busy={summary.get('decode_busy_s')}s "
          f"handoff={summary.get('handoff_s')}s "
          f"decode_stall={summary.get('decode_stall_s')}s "
          f"itl_p50={summary.get('decode_itl_p50_ms')}ms "
          f"ready_p50={summary.get('ready_depth_p50')} "
          f"prefill_compiles={summary.get('prefill_compiles')}")


def _make_engine(args, cfg, params, device) -> ServeEngine:
    return ServeEngine(cfg, params, args.batch, args.cache_len,
                       eos_id=args.eos_id, sync_every=args.sync_every,
                       kv_layout=args.kv, page_size=args.page_size,
                       pool_pages=args.pool_pages,
                       max_seq_len=args.max_seq_len, spec_k=args.spec_k,
                       spec_draft_layers=args.spec_draft_layers or None,
                       disagg=args.disagg or None,
                       prefill_workers=args.prefill_workers,
                       bucket_prompts=args.bucket_prompts or None,
                       device=device)


def serve_continuous(args, cfg, params, plens, device):
    """Serve the stream; returns (summary, scheduler, engine)."""
    tuned = None
    if args.autotune_decode:
        paged = (args.kv or optflags.kv_layout()) == "paged"
        seq = args.max_seq_len or args.cache_len
        n_swept = len(autotune.SWEPT)
        tuned = preseed_decode_blocks(
            cfg, args.batch, page_size=args.page_size if paged else None,
            max_pages=-(-seq // args.page_size) if paged else None,
            spec_k=args.spec_k)
        tuned["sweeps"] = autotune.SWEPT[n_swept:]
        _print_sweeps(tuned["sweeps"])
    engine = _make_engine(args, cfg, params, device)
    sched = SlotScheduler(args.batch, eos_id=args.eos_id)
    build_requests(sched, cfg, args.requests, args.rate, plens,
                   args.max_new, args.seed, tier_mix=args.tier_mix,
                   prefix_mix=args.prefix_mix, prefix_len=args.prefix_len)
    print(f"[engine] kv_layout={engine.kv_layout} "
          f"prefix_cache={engine.prefix_caching_on()} "
          f"disagg={engine.disagg_on()} bucketing={engine.bucketing_on()} "
          f"spec={engine.spec_decoding_on()}")
    summary = engine.serve(sched, greedy=True)
    summary["kv_layout"] = engine.kv_layout
    summary["stream_digest"] = stream_digest(sched.finished)
    if tuned is not None:
        summary["autotune_sweeps"] = len(tuned["sweeps"])
        summary["autotune_tiles"] = ",".join(
            f"{m}x{n}x{k}:{t}" for (m, n, k), t in sorted(
                tuned["gemm"].items()))
        summary["autotune_n_split"] = ",".join(
            "x".join(map(str, key)) + f":{v}"
            for key, v in sorted(tuned["decode_attn"].items())) or None
        summary["autotune_decode_misses"] = engine.decode_misses
    itl = itl_p50_ms(sched.finished)
    if itl is not None:
        summary["decode_itl_p50_ms"] = itl
    _print_phases(summary)
    if engine.spec_decoding_on() and summary.get("spec_iters"):
        # the draft/verify split, timed apart at the serving shapes and
        # scaled by the iterations the serve ran (serve() runs both in one
        # chunk without a sync between them)
        split = engine.spec_timing_probe()
        iters = summary["spec_iters"]
        summary["spec_draft_s"] = round(split["draft_s"] * iters, 4)
        summary["spec_verify_s"] = round(split["verify_s"] * iters, 4)
        print(f"[spec] k={engine.spec_k} "
              f"draft_layers={engine.spec_draft_layers}/"
              f"{cfg.num_layers // cfg.stack_period} "
              f"accept_rate={summary.get('spec_accept_rate', 0.0)} "
              f"accepted={summary.get('spec_accepted', 0)}/"
              f"drafted={summary.get('spec_drafted', 0)} "
              f"draft_s~{summary['spec_draft_s']} "
              f"verify_s~{summary['spec_verify_s']}")
    for r in sorted(sched.finished, key=lambda r: r.rid):
        ttft = float("nan") if r.ttft is None else r.ttft
        print(f"req {r.rid:3d} slot {r.slot} {r.tier:7s} "
              f"prompt {r.prompt_len:4d} "
              f"gen {r.n_generated:4d} ({r.finish_reason or 'n/a':8s}) "
              f"ttft {ttft:.3f}s "
              f"decode {r.decode_tok_s or float('nan'):.1f} tok/s")
    if args.tier_mix > 0:
        energy = tier_energy_summary(sched.tier_mode_tokens,
                                     engine.macs_per_token())
        summary |= {f"energy_{k}": v for k, v in energy.items()}
        rng = np.random.default_rng(args.seed + 7)
        probe = engine.divergence_probe(
            rng.integers(0, cfg.vocab_size, plens[0]),
            steps=min(16, args.max_new))
        print(f"[divergence] steps={probe['steps']} "
              f"max_ulp={probe['max_ulp']} kl_mean={probe['kl_mean']:.3e} "
              f"max_abs_diff={probe['max_abs_diff']:.3e}")
        summary |= {f"divergence_{k}": v for k, v in probe.items()}
    return summary, sched, engine


def serve_replicas(args, cfg, params, plens, device):
    """`--decode-replicas N`: N engine replicas behind one arrival stream
    (DESIGN.md §10, the JAX driver's `serve_replicas`). The stream is built
    once and each request is routed up front, in arrival order, to the
    least-loaded replica (`ReplicaRouter`: a pure function of the stream,
    ties to the lowest index). The replicas serve one after another on
    this device over the same `params`, so each replica's wall and ITL are
    measured; the aggregate gives the serial wall paid and the parallel
    wall of a deployment (the slowest replica). Requests keep their global
    rids, so the aggregate `stream_digest` compares with a one-replica run
    of the stream. Returns (aggregate summary, the replicas' schedulers)."""
    from repro_torch.serve.scheduler import ReplicaRouter

    n = args.decode_replicas
    master = SlotScheduler(args.batch, eos_id=args.eos_id)
    build_requests(master, cfg, args.requests, args.rate, plens,
                   args.max_new, args.seed, tier_mix=args.tier_mix,
                   prefix_mix=args.prefix_mix, prefix_len=args.prefix_len)
    router = ReplicaRouter(n)
    scheds = [SlotScheduler(args.batch, eos_id=args.eos_id)
              for _ in range(n)]
    for req in master.pending:     # already in arrival order
        i = router.route(req.prompt_len, req.max_new_tokens)
        r2 = scheds[i].submit(req.prompt, req.max_new_tokens,
                              arrival_time=req.arrival_time, tier=req.tier)
        r2.rid = req.rid           # the global rid keys the digest

    summaries, finished = [], []
    for i, sched in enumerate(scheds):
        s = _make_engine(args, cfg, params, device).serve(sched, greedy=True)
        s["decode_itl_p50_ms"] = itl_p50_ms(sched.finished)
        summaries.append(s)
        finished.extend(sched.finished)
        print(f"[replica {i}] requests={s['requests']} "
              f"wall_s={s['wall_s']} decode_tok_s={s.get('decode_tok_s')} "
              f"itl_p50={s['decode_itl_p50_ms']}ms "
              f"pages_leaked={s.get('pages_leaked')} "
              f"decode_stall={s.get('decode_stall_s')}s")

    def total(key):
        return round(sum(s.get(key) or 0 for s in summaries), 4)

    summary = {
        "replicas": n,
        "requests": sum(s["requests"] for s in summaries),
        "generated_tokens": sum(s["generated_tokens"] for s in summaries),
        "rejected": sum(s.get("rejected", 0) for s in summaries),
        "pages_leaked": total("pages_leaked"),
        "prefill_busy_s": total("prefill_busy_s"),
        "decode_busy_s": total("decode_busy_s"),
        "handoff_s": total("handoff_s"),
        "decode_stall_s": total("decode_stall_s"),
        "prefill_compiles": sum(s.get("prefill_compiles", 0)
                                for s in summaries),
        "nonfinite_logits": sum(s["nonfinite_logits"] for s in summaries),
        # serial: what serving the replicas one after another paid;
        # parallel: a deployment's wall, the slowest replica
        "wall_s_serial": total("wall_s"),
        "wall_s_parallel": round(max(s["wall_s"] for s in summaries), 4),
        "disagg": summaries[0].get("disagg"),
        "ready_depth_p50": summaries[0].get("ready_depth_p50"),
        "stream_digest": stream_digest(finished),
    }
    itl = itl_p50_ms(finished)
    if itl is not None:
        summary["decode_itl_p50_ms"] = itl
    _print_phases(summary)
    return summary, scheds


def static_wave(cfg, batch: int, plen: int, seed: int, w: int):
    """Wave w's prompts (batch, plen) int32 and frontend embeddings
    (batch, frontend_tokens, d_model) for `serve_static`, drawn on the host
    from a `torch.Generator` seeded seed + 1 + w."""
    g = torch.Generator().manual_seed(seed + 1 + w)
    prompts = torch.randint(0, cfg.vocab_size, (batch, plen), generator=g,
                            dtype=torch.int32)
    return prompts, torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                                generator=g)


def serve_static(args, cfg, params, plens, device):
    """Static-batch waves for the frontend archs (the JAX driver's
    `serve_static`): `--requests` prompts served in waves of `--batch`
    through `generate()` (arrivals and `--rate` do not apply: a wave
    waits on its slowest member). Prompt lengths cycle a wave (a wave's
    batch prefill is rectangular); wave w's prompts and frontend
    embeddings (B, frontend_tokens, d_model) come from
    `static_wave` (on the host: under a mesh every rank draws the same
    ones). Counts the real generated tokens
    (through the first EOS a row; the last wave's padding rows do not
    count); `stream_digest` is `stream_digest`'s over those tokens, wave
    w's row i request w·batch + i; `decode_itl_p50_ms` is the median over
    the waves of a wave's decode wall time over its lock-step decode
    steps (every row gets one token a step). Returns (summary, the waves'
    token arrays, engine)."""
    engine = ServeEngine(cfg, params, args.batch, args.cache_len,
                         eos_id=args.eos_id, sync_every=args.sync_every,
                         kv_layout="ring", page_size=args.page_size,
                         device=device)
    served = n_real = nonfinite = 0
    prefill_s = decode_s = 0.0
    outs, streams, itls = [], [], []
    waves = max(1, -(-args.requests // args.batch))
    for w in range(waves):
        prompts, frontend = static_wave(cfg, args.batch,
                                        plens[w % len(plens)], args.seed, w)
        out = engine.generate(prompts, args.max_new,
                              frontend=frontend).numpy()
        outs.append(out)
        n_rows = min(args.batch, args.requests - served)
        for i, row in enumerate(out[:n_rows]):
            eos = np.nonzero(row == args.eos_id)[0]
            n = int(eos[0]) + 1 if eos.size else row.shape[0]
            n_real += n
            streams.append(types.SimpleNamespace(
                rid=w * args.batch + i, tokens=row[:n].tolist()))
        served += n_rows
        prefill_s += engine.last_stats["prefill_s"]
        decode_s += engine.last_stats["decode_s"]
        steps = engine.last_stats["decode_tokens"] // args.batch
        if steps:
            itls.append(engine.last_stats["decode_s"] / steps)
        nonfinite += engine.last_stats["nonfinite_logits"]
    summary = {"requests": served, "generated_tokens": n_real,
               "waves": waves, "prefill_s": round(prefill_s, 4),
               "decode_s": round(decode_s, 4),
               "decode_tok_s": round(max(n_real - served, 0) / decode_s, 2)
               if decode_s > 0 else 0.0,
               "decode_itl_p50_ms": round(float(np.percentile(itls, 50))
                                          * 1000, 3) if itls else None,
               "nonfinite_logits": nonfinite,
               "stream_digest": stream_digest(streams)}
    return summary, outs, engine


def config_of(args):
    """The config that `--arch`, `--reduced` (with `--layers-per-period`
    and `--width`) and `--layers` name."""
    cfg = (reduced_config(args.arch,
                          layers_per_period=args.layers_per_period,
                          width=args.width)
           if args.reduced else get_config(args.arch))
    return cut_depth(cfg, args.layers) if args.layers else cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no card and no --device "
                         "cpu is an error")
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, req/s (0 = all at t=0)")
    ap.add_argument("--prompt-lens", default="8,16,32",
                    help="comma-set of prompt lengths, cycled per request")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--kv", default=None, choices=(None, "ring", "paged"),
                    help="KV layout (default: $REPRO_KV or 'paged'): "
                         "'paged' pools pages across slots; 'ring' gives "
                         "each slot a dense ring of --cache-len rows")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="total pages in the pool (default: batch*cache_len "
                         "tokens + the trash page)")
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="per-request token cap = block-table width "
                         "(default: cache-len)")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode steps per host sync / scheduler tick")
    ap.add_argument("--prefix-mix", type=float, default=0.0,
                    help="fraction of requests sharing one fixed system "
                         "prompt (the prefix-cache workload)")
    ap.add_argument("--prefix-len", type=int, default=32,
                    help="shared system-prompt length for --prefix-mix")
    ap.add_argument("--tier-mix", type=float, default=0.0,
                    help="fraction of requests submitted as the 'bulk' "
                         "quality tier (approximate decode when a whole "
                         "chunk is bulk); 0 = all premium")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative draft length (0 = off); greedy "
                         "output equals --spec-k 0's, REPRO_SPEC_DECODE=0 "
                         "switches it off")
    ap.add_argument("--spec-draft-layers", type=int, default=0,
                    help="superblocks the draft runs (0 = half the stack)")
    ap.add_argument("--spec-warmup", type=int, default=0,
                    help="seed-pure AdamW warm-up steps on a Markov corpus "
                         "before serving (fp32 weights)")
    ap.add_argument("--disagg", action="store_true",
                    help="two-pool disaggregated serving (DESIGN.md §10): "
                         "prefill workers stage finished prompts' KV pages "
                         "and a ready queue feeds decode admissions, so "
                         "decode chunks never wait on a prefill. Paged "
                         "layout only; the tokens are the unified run's "
                         "(REPRO_DISAGG=1 is the env equivalent)")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="prefills the prefill pool runs a chunk under "
                         "--disagg")
    ap.add_argument("--decode-replicas", type=int, default=1,
                    help="N engine replicas behind the one arrival stream, "
                         "routed least-loaded (ReplicaRouter); served one "
                         "after another on this device, the parallel wall "
                         "modelled as the slowest replica's")
    ap.add_argument("--bucket-prompts", action="store_true",
                    help="pad each prefill to a bucket length (fewer "
                         "prefill shapes, the same tokens; "
                         "REPRO_PREFILL_BUCKET=1 is the env equivalent)")
    ap.add_argument("--layers-per-period", type=int, default=1,
                    help="depth multiplier for --reduced configs")
    ap.add_argument("--width", type=int, default=1,
                    help="width multiplier for --reduced configs")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id (-1: never fires on synthetic vocab)")
    ap.add_argument("--autotune-decode", action="store_true",
                    help="tune the decode step's GEMM tiles and the paged "
                         "decode's cluster size before the first chunk "
                         "(kernels/autotune.py; the card only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of the mesh's model axis (tensor "
                         "parallelism; launch with torchrun)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    return ap.parse_args(argv)


def _serve_mesh(args, cfg, device):
    """The ("data", "model") mesh of the launched world (None for one
    process that no launcher started), after the refusals of serving
    under it. Returns (mesh, this rank's device)."""
    from repro_torch.parallel import mesh as PM

    mesh = PM.make_host_mesh(args.model_parallel, device)
    if mesh is None:
        return None, device
    dp, mp = mesh.shape
    static = cfg.family == "vlm" or cfg.is_encdec    # `generate()`'s rings
    M.check_parallel(cfg, mp, dp, serving=True, batch=args.batch,
                     kv_layout="ring" if static
                     else args.kv or optflags.kv_layout())
    for flag, on in (("--decode-replicas", args.decode_replicas > 1),
                     ("--autotune-decode", args.autotune_decode),
                     ("--spec-warmup", args.spec_warmup > 0)):
        if on:
            raise ValueError(f"{flag} is not ported under a mesh")
    return mesh, PM.rank_device(device)


def rank_line(summary, device, engine=None) -> str:
    """This rank's closing line: its data coordinate, the slots it decodes
    and its pages (the global ids of its shard of the pool, and the most
    of them leased at once; n/a on rings), its digest, peak memory and
    each served kernel's launches (`ops.counts()`, this process's)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops

    c = ops.counts()
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f}"
            if device.type == "cuda" else "n/a")
    where = ""
    if engine is not None:
        pages = "n/a"
        by_shard = summary.get("pages_peak_by_shard")
        if engine.kv_layout == "paged" and "pages_total" in summary:
            n = engine.pool_pages // engine.dp
            peak_p = (by_shard[engine.dp_rank] if by_shard
                      else summary.get("pages_peak_in_use"))
            pages = (f"{engine.page_base}-{engine.page_base + n - 1}"
                     f":peak{peak_p}")
        where = (f"data={engine.dp_rank} slots={engine.slot0}-"
                 f"{engine.slot0 + engine.rows - 1} pages={pages} ")
    return (f"[rank {dist.get_rank()}] {where}stream_digest="
            f"{summary.get('stream_digest')} peak_mem_gib={peak} "
            f"sa_matmul_launches={c['sa_matmul']['launches']} "
            f"decode_attn_launches={c['paged_decode']['launches']} "
            f"prefill_attn_launches={c['prefill_attention']['launches']} "
            f"plain_calls={sum(v['plain_calls'] for v in c.values())}")


def main(argv=None, *, return_state: bool = False, params=None):
    """Serve the synthetic stream and print the summary line. Returns the
    summary, or (summary, scheduler, engine) with `return_state`; with
    `--decode-replicas` N > 1, (aggregate summary, the N schedulers); for
    a frontend arch (static waves), (summary, the waves' tokens, engine).
    `params` serves given weights (on the run's device) instead of
    drawing them from `--seed`; under a mesh they are this rank's shards
    (`parallel.sharding.shard_tree` by `param_specs`)."""
    from repro_torch.launch.train import say, _mesh_line
    from repro_torch.parallel import sharding as S

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.autotune_decode and device.type != "cuda":
        raise ValueError("--autotune-decode times the kernels on the card; "
                         "on the CPU the port runs their plain versions, "
                         "which have nothing to tune")
    cfg = config_of(args)
    mesh, device = _serve_mesh(args, cfg, device)
    if mesh is None:
        return _serve(args, cfg, device, params, return_state)
    import torch.distributed as dist

    lead = dist.get_rank() == 0
    if lead:
        say(_mesh_line(mesh, device))
    if params is None:
        params = M.init_params(cfg, seed=args.seed, device=device, mesh=mesh)
    # the lead rank prints the run's lines; every rank its closing line
    out = contextlib.nullcontext() if lead else contextlib.redirect_stdout(
        io.StringIO())
    with S.using_mesh(mesh), out:
        state = _serve(args, cfg, device, params, True)
    say(rank_line(state[0], device, state[2]))
    return state if return_state else state[0]


def _serve(args, cfg, device, params, return_state: bool):
    if params is None and args.spec_warmup > 0:
        params = spec_warmup_train(
            cfg, M.init_params(cfg, seed=args.seed, device=device,
                               dtype=torch.float32),
            args.spec_warmup, args.seed)
    elif params is None:
        params = M.init_params(cfg, seed=args.seed, device=device)
    plens = [int(x) for x in args.prompt_lens.split(",")]
    extra = args.prefix_len if args.prefix_mix > 0 else 0
    args.cache_len = args.cache_len or (max(plens) + extra + args.max_new)
    if cfg.family == "vlm" or cfg.is_encdec:
        summary, outs, engine = serve_static(args, cfg, params, plens,
                                             device)
        state = (summary, outs, engine)
        mode = "static"
    elif args.decode_replicas > 1:
        summary, scheds = serve_replicas(args, cfg, params, plens, device)
        state = (summary, scheds)
        mode = f"replicas x{args.decode_replicas}"
    else:
        summary, sched, engine = serve_continuous(args, cfg, params, plens,
                                                  device)
        state = (summary, sched, engine)
        mode = "continuous"
    print(f"[{mode}] " + " ".join(f"{k}={v}" for k, v in summary.items()))
    return state if return_state else summary


if __name__ == "__main__":
    main()

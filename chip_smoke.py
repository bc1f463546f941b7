#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as the checks run it
    python3 chip_smoke.py --skip-serve    # device, build and kernel phases

Phases, in order; any failure exits nonzero:

1. device  — the card's name and power limit (nvidia-smi), torch, CUDA and
             nvcc versions.
2. build   — every kernel of the main path built from `src/repro_torch/
             kernels/csrc` for sm_90a, one nvcc per source, all at once;
             registers, shared memory and spills from `-Xptxas -v`.
3. kernels — each kernel against its plain PyTorch version on the same
             inputs at the main path's shapes, every output within the
             kernel's stated bound (`error_bound` of its module); CUDA-event
             times of the kernel, the plain version and one PyTorch call
             that computes the same function (a yardstick the port never
             calls), beside the least time the card could take.
4. serve   — full-width, full-depth qwen2.5-14b (random weights from a
             seed) served through `repro_torch.launch.serve.main` with the
             `cuda` GEMM backend; every request must generate `max_new`
             tokens with finite logits, no page may leak, every kernel of the
             path must have launched and no plain version may have run.
             Then one prompt's prefill logits under the `cuda` and `torch`
             GEMM backends, within the stated bound.
5. profile — four more requests served under torch.profiler: the device's
             busy and idle share of the wall and the kernels that take the
             device time.

The last lines are the kernels JSON line, the nvidia-smi line and
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s (data sheet)
PEAK_BF16 = 989e12        # dense bf16 tensor-core flop/s (data sheet)
PEAK_FP32 = 67e12         # fp32 flop/s outside the tensor cores (data sheet)

ARCH = "qwen2.5-14b"
SERVE_ARGS = ["--arch", ARCH, "--batch", "4", "--requests", "8",
              "--prompt-lens", "32,64,128", "--max-new", "16", "--rate", "0",
              "--seed", "0"]
BATCH, MAX_NEW, PROMPT_LENS = 4, 16, (32, 64, 128)
PAGE = 16
# the served stream's per-request capacity: longest prompt + max_new
CACHE_LEN = max(PROMPT_LENS) + MAX_NEW


def log(msg=""):
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound_ms(nbytes: float, flops: float, peak: float):
    t_b, t_o = nbytes / PEAK_BYTES, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def peak_flops(policy) -> float:
    """The card's peak rate for the type a policy feeds the products: bf16
    or fp16 operands with fp32 accumulation run on the tensor cores."""
    return PEAK_FP32 if policy.input_format == "fp32" else PEAK_BF16


def device_kernels(torch, prof):
    """{kernel name: (total ms, launches)} of the CUDA kernels a profile
    recorded; empty if the profiler saw no device activity."""
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


class Timer:
    """Two times of one call, each taken with a cold L2.

    Before every call a 256 MB read-modify-write (`bitwise_not_`, a kernel
    no timed call launches) evicts the 50 MB L2: the serving path streams
    28 GB of weights per step, so it finds the cache cold.
    `wall`: CUDA events around each of `reps` calls, averaged. The host
    enqueues a call while the flush runs, so its launch overhead shows only
    where it exceeds the flush (~0.16 ms at the byte rate).
    `device`: the summed durations of the CUDA kernels one call launched,
    from torch.profiler, the flush's excluded (None when the profiler
    records no device time)."""

    FLUSH_KERNEL = "bitwise_not"

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32,
                                 device="cuda")

    def wall(self, fn, reps=20):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            self.flush.bitwise_not_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in events) / reps

    def device(self, fn, reps=5):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        ks = device_kernels(torch, prof)
        if not ks:
            return None
        return sum(ms for name, (ms, _) in ks.items()
                   if self.FLUSH_KERNEL not in name) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_gemm(torch, timer):
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_matmul as mm

    d, hd, H, KVH, ff = 5120, 128, 40, 8, 13824
    vocab = 153600
    # (name, K, N, bias, act) of every GEMM on the path
    shapes = [("wq", d, H * hd, True, "none"), ("wk", d, KVH * hd, True,
                                                 "none"),
              ("wv", d, KVH * hd, True, "none"),
              ("wo", H * hd, d, False, "none"),
              ("wg", d, ff, False, "silu"), ("wu", d, ff, False, "none"),
              ("wd", ff, d, False, "none"),
              ("lm_head", d, vocab, False, "none")]
    extra = [("wk+gelu+approx+scale", d, KVH * hd, True, "gelu", "approx",
              0.5),
             ("wg+silu+approx", d, ff, True, "silu", "approx", None),
             ("wq+relu", d, H * hd, True, "relu", "exact", None),
             ("ragged", 1000, 999, True, "silu", "approx", None)]
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    max_err = 0.0
    step = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    log(f"{'gemm':24s} {'M':>4s} {'K':>6s} {'N':>7s} {'max_err':>10s} "
        f"{'err/bound':>9s} {'ms':>8s} {'plain_ms':>9s} {'lib_ms':>8s} "
        f"{'bound_ms':>8s}")
    cases = [(n, k, nn, b, act, "exact", None) for n, k, nn, b, act in shapes]
    cases += extra
    for m in (BATCH, 128):
        for name, k, n, has_bias, act, mode, scale in cases:
            a = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=g, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            bias = (torch.randn((n,), generator=g, device="cuda") * 0.1
                    if has_bias else None)
            y = ops.sa_matmul(a, w, bias=bias, act=act, scale=scale,
                              mode=mode)
            ref = mm.sa_matmul_ref(a, w, bias, scale, act=act, mode=mode)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            bnd = mm.error_bound(a, w, scale, mode, y=ref)
            ratio = float((err / bnd).max())
            if not torch.isfinite(y).all() or ratio > 1.0:
                raise AssertionError(
                    f"sa_matmul {name} M={m}: max err {float(err.max()):.3e}"
                    f" exceeds its bound (ratio {ratio:.3f})")
            worst = max(worst, ratio)
            max_err = max(max_err, float(err.max()))
            timed = m == BATCH and name in [s[0] for s in shapes]
            line = (f"{name:24s} {m:4d} {k:6d} {n:7d} "
                    f"{float(err.max()):10.3e} {ratio:9.4f}")
            if timed:
                a32, w32 = a.float(), w.float()
                t_k = timer.wall(lambda: ops.sa_matmul(a, w, bias=bias,
                                                       act=act))
                d_k = timer.device(lambda: ops.sa_matmul(a, w, bias=bias,
                                                         act=act))
                t_p = timer.wall(lambda: mm.sa_matmul_ref(a, w, bias,
                                                          act=act))
                t_l = timer.wall(lambda: torch.matmul(a32, w32))
                nbytes = 2 * (m * k + k * n) + 4 * m * n + (
                    4 * n if has_bias else 0)
                flops = 2.0 * m * n * k
                b_ms, _ = bound_ms(nbytes, flops, PEAK_BF16)
                line += (f" {t_k:8.4f} {t_p:9.4f} {t_l:8.4f} {b_ms:8.4f}"
                         f" device_ms={d_k}")
                if m == BATCH and name != "lm_head":
                    step["ms"] += t_k
                    step["device_ms"] = (None if d_k is None
                                         or step["device_ms"] is None
                                         else step["device_ms"] + d_k)
                    step["plain_ms"] += t_p
                    step["library_ms"] += t_l
                    step["bytes"] += nbytes
                    step["flops"] += flops
            log(line)
    b_ms, by = bound_ms(step["bytes"], step["flops"], PEAK_BF16)
    log(f"gemm max err/bound over all cases: {worst:.4f}")
    return {"name": "sa_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sa_matmul.cu",
            "replaces": "src/repro/kernels/sa_matmul.py:101",
            "max_abs_err": max_err, "err_over_bound": worst,
            "ms": step["ms"], "device_ms": step["device_ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": step["library_ms"],
            "timed": "one decoder layer's 7 decode GEMMs at M=4 "
                     "(wq,wk,wv,wo,wg,wu,wd), summed"}


def _paged_workload(torch, g, B, KVH, grp, hd, psz, P, n_pages, lens):
    """A pool with slot b owning ceil(lens[b] / psz) pages (0 = an empty
    slot with an unmapped row), one explicit trash-page (0) entry, and
    recycled pages carrying stale positions."""
    H = KVH * grp
    q = torch.randn((B, 1, H, hd), generator=g, device="cuda")
    k = torch.randn((n_pages, psz, KVH, hd), generator=g, device="cuda")
    v = torch.randn((n_pages, psz, KVH, hd), generator=g, device="cuda")
    pp = torch.randint(0, 4 * psz, (n_pages, psz), generator=g,
                       device="cuda", dtype=torch.int32)
    bt = torch.full((B, P), -1, dtype=torch.int32, device="cuda")
    pos = torch.zeros((B,), dtype=torch.int32, device="cuda")
    nxt = 1
    for b, n in enumerate(lens):
        npg = -(-n // psz)
        for j in range(npg):
            bt[b, j] = nxt
            pp[nxt] = torch.arange(j * psz, (j + 1) * psz, device="cuda")
            nxt += 1
        pos[b] = max(n - 1, 0)
    if lens[0] > psz:
        bt[0, 1] = 0          # an explicit trash-page entry: masked
    return q, k, v, pp, bt, pos


def check_decode(torch, timer):
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_decode_attention as da

    KVH, grp, hd, psz = 8, 5, 128, PAGE
    P = -(-CACHE_LEN // psz)
    n_pages = -(-BATCH * CACHE_LEN // psz) + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    lens = [CACHE_LEN, 100, 40, 0]            # slot 3: all masked
    cases = [("default", {}, PrecisionPolicy()),
             ("softcap+window", {"cap": 50.0, "window": 64},
              PrecisionPolicy()),
             ("approx", {}, PrecisionPolicy(mode="approx")),
             ("fp32", {}, PrecisionPolicy(input_format="fp32"))]
    worst = max_err = 0.0
    out = {}
    for name, kw, pol in cases:
        q, k, v, pp, bt, pos = _paged_workload(torch, g, BATCH, KVH, grp, hd,
                                               psz, P, n_pages, lens)
        y = ops.paged_decode_attention(q, k, v, pp, bt, pos, policy=pol, **kw)
        ref = da.paged_decode_ref(q, k, v, pp, bt, pos, policy=pol, **kw)
        torch.cuda.synchronize()
        err = (y - ref).abs()
        bnd = da.error_bound(q, k, v, pp, bt, pos, policy=pol, **kw)
        ratio = float((err / bnd).max())
        if not torch.isfinite(y).all() or ratio > 1.0:
            raise AssertionError(f"paged decode {name}: max err "
                                 f"{float(err.max()):.3e} exceeds its bound")
        if float(y[3].abs().max()) != 0.0:
            raise AssertionError("paged decode: an all-masked slot must "
                                 "give zeros")
        worst, max_err = max(worst, ratio), max(max_err, float(err.max()))
        log(f"paged decode {name:16s} B={BATCH} H={KVH * grp} KVH={KVH} "
            f"hd={hd} P={P} psz={psz} max_err={float(err.max()):.3e} "
            f"err/bound={ratio:.4f} median bound {float(bnd.median()):.3e}")
        # planted faults, each in the plain version: the kernel's output
        # must land outside the bound of each
        faults = {"mask_off_by_one": dict(pos=pos - 1),
                  "last_page_dropped": dict(bt=_drop_last_page(torch, bt))}
        for fault, change in faults.items():
            args = dict(q=q, k_pool=k, v_pool=v, page_positions=pp,
                        block_table=change.get("bt", bt),
                        pos=change.get("pos", pos))
            bad = da.paged_decode_ref(**args, policy=pol, **kw)
            r = float(((y - bad).abs() / bnd).max())
            log(f"  planted fault {fault}: kernel vs faulty plain, "
                f"err/bound {r:.1f}")
            if not r > 1.0:
                raise AssertionError(f"paged decode bound does not reject "
                                     f"the planted fault {fault}")
        if name == "default":
            mapped = int((bt > 0).sum())
            t_k = timer.wall(lambda: ops.paged_decode_attention(
                q, k, v, pp, bt, pos))
            d_k = timer.device(lambda: ops.paged_decode_attention(
                q, k, v, pp, bt, pos))
            t_p = timer.wall(lambda: da.paged_decode_ref(q, k, v, pp, bt,
                                                         pos))
            kg, vg, pg = _gathered(torch, k, v, pp, bt)
            mask = ((pg >= 0) & (pg <= pos[:, None]))[:, None, None, :]
            qs = q.transpose(1, 2)                     # (B, H, 1, hd)
            kh = kg.transpose(1, 2).repeat_interleave(grp, 1)
            vh = vg.transpose(1, 2).repeat_interleave(grp, 1)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_l = timer.wall(lambda: sdpa(qs, kh, vh, attn_mask=mask))
            H = KVH * grp
            nbytes = (4 * BATCH * H * hd * 2 + mapped * psz * KVH * hd * 4 * 2
                      + mapped * psz * 4 + 4 * BATCH * P + 4 * BATCH)
            flops = 4.0 * H * mapped * psz * hd     # q.k and p.v
            b_ms, by = bound_ms(nbytes, flops, peak_flops(pol))
            log(f"paged decode times: kernel {t_k:.4f} ms (device {d_k}), "
                f"plain {t_p:.4f} ms, SDPA on the gathered view {t_l:.4f} "
                f"ms, bound {b_ms:.5f} ms ({by})")
            out = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p,
                   "library_ms": t_l,
                   "bound_ms": b_ms, "bound_by": by}
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sa_decode_attention.cu",
            "replaces": "src/repro/kernels/sa_decode_attention.py:94",
            "max_abs_err": max_err, "err_over_bound": worst, **out,
            "timed": f"one layer's decode step, B={BATCH}, "
                     f"{CACHE_LEN}-token slots, pool fp32"}


def _drop_last_page(torch, bt):
    """Each slot's last mapped page unmapped."""
    bt = bt.clone()
    for b in range(bt.shape[0]):
        live = (bt[b] > 0).nonzero()
        if len(live):
            bt[b, live[-1]] = -1
    return bt


def _gathered(torch, k, v, pp, bt):
    from repro_torch.models.layers import PagedKVCache, gather_pages
    return gather_pages(PagedKVCache(k, v, pp, bt))


def check_prefill(torch, timer):
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels import sa_attention as fa

    H, KVH, hd = 40, 8, 128
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(t, t, {}) for t in PROMPT_LENS]
    cases += [(64, 128, {"q_offset": 64, "window": 48, "cap": 50.0})]
    worst = max_err = 0.0
    out = {}
    for T, S, kw in cases:
        q = torch.randn((1, T, H, hd), generator=g, device="cuda")
        k = torch.randn((1, S, KVH, hd), generator=g, device="cuda")
        v = torch.randn((1, S, KVH, hd), generator=g, device="cuda")
        for pol in (PrecisionPolicy(), PrecisionPolicy(input_format="fp32")):
            y = ops.sa_attention(q, k, v, policy=pol, **kw)
            ref = fa.flash_attention_ref(q, k, v, policy=pol, **kw)
            torch.cuda.synchronize()
            err = (y - ref).abs()
            bnd = fa.error_bound(q, k, v, policy=pol, **kw)
            ratio = float((err / bnd).max())
            if not torch.isfinite(y).all() or ratio > 1.0:
                raise AssertionError(f"prefill attention T={T} {kw}: max err "
                                     f"{float(err.max()):.3e} exceeds bound")
            # planted fault in the plain version: a causal mask one key too
            # wide must land outside the bound
            bad = fa.flash_attention_ref(
                q, k, v, policy=pol,
                **{**kw, "q_offset": kw.get("q_offset", 0) + 1})
            r_bad = float(((y - bad).abs() / bnd).max())
            if not r_bad > 1.0:
                raise AssertionError("prefill bound does not reject a causal "
                                     "mask one key too wide")
            worst, max_err = max(worst, ratio), max(max_err,
                                                    float(err.max()))
            log(f"prefill attention T={T:4d} S={S:4d} {pol.input_format} "
                f"{kw} max_err={float(err.max()):.3e} err/bound={ratio:.4f}"
                f" median bound {float(bnd.median()):.3e}; planted fault "
                f"(mask one key too wide) err/bound {r_bad:.1f}")
        if T == max(PROMPT_LENS) and not kw:
            t_k = timer.wall(lambda: ops.sa_attention(q, k, v))
            d_k = timer.device(lambda: ops.sa_attention(q, k, v))
            t_p = timer.wall(lambda: fa.flash_attention_ref(q, k, v))
            qh = q.transpose(1, 2)
            kh = k.transpose(1, 2).repeat_interleave(H // KVH, 1)
            vh = v.transpose(1, 2).repeat_interleave(H // KVH, 1)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_l = timer.wall(lambda: sdpa(qh, kh, vh, is_causal=True))
            pairs = T * (T + 1) / 2
            nbytes = 4 * (T * H * hd * 2 + 2 * S * KVH * hd)
            flops = 4.0 * H * pairs * hd
            b_ms, by = bound_ms(nbytes, flops, peak_flops(PrecisionPolicy()))
            log(f"prefill attention times (T={T}): kernel {t_k:.4f} ms "
                f"(device {d_k}), plain {t_p:.4f} ms, SDPA {t_l:.4f} ms, "
                f"bound {b_ms:.5f} ms ({by})")
            out = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p,
                   "library_ms": t_l,
                   "bound_ms": b_ms, "bound_by": by}
    return {"name": "prefill_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sa_attention.cu",
            "replaces": "src/repro/kernels/sa_attention.py:27",
            "max_abs_err": max_err, "err_over_bound": worst, **out,
            "timed": f"one layer's prefill of a {max(PROMPT_LENS)}-token "
                     f"prompt, fp32 q/k/v"}


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def serve(torch):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as drv

    os.environ["REPRO_GEMM_BACKEND"] = "cuda"
    ops.reset_counts()
    t0 = time.monotonic()
    summary, sched, engine = drv.main(SERVE_ARGS, return_state=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.counts()
    log(f"[serve] wall {wall:.2f} s (init + serve); counts {counts}")
    done = sched.finished
    problems = []
    if len(done) != 8 or any(r.n_generated != MAX_NEW for r in done):
        problems.append(f"requests incomplete: "
                        f"{[(r.rid, r.n_generated) for r in done]}")
    if summary.get("pages_leaked") != 0:
        problems.append(f"pages_leaked={summary.get('pages_leaked')}")
    if summary.get("nonfinite_logits") != 0:
        problems.append(f"nonfinite logits: {summary.get('nonfinite_logits')}")
    for name, c in counts.items():
        if c["launches"] <= 0:
            problems.append(f"kernel {name} never launched on the path")
        if c["plain_calls"] != 0:
            problems.append(f"plain version of {name} ran on the path "
                            f"({c['plain_calls']} calls)")
    if problems:
        raise AssertionError("serve phase failed: " + "; ".join(problems))
    launches = {name: c["launches"] for name, c in counts.items()}
    return summary, launches, engine, sched


def profile_serve(torch, engine):
    """Where the time goes: four requests (the three prompt lengths and
    one more of the longest, 16 new tokens each) served again under
    torch.profiler (CUDA activity only); device-busy share of the wall and
    the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.precision import PrecisionPolicy, use_policy
    from repro_torch.launch.serve import itl_p50_ms
    from repro_torch.serve.scheduler import SlotScheduler

    g = torch.Generator().manual_seed(5)
    sched = SlotScheduler(BATCH, eos_id=-1)
    for n in PROMPT_LENS + (max(PROMPT_LENS),):
        sched.submit(torch.randint(0, engine.cfg.vocab_size, (n,),
                                   generator=g).tolist(), MAX_NEW)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with use_policy(PrecisionPolicy(backend="cuda")):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            summary = engine.serve(sched)
            torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ks = device_kernels(torch, prof)
    busy = sum(ms for ms, _ in ks.values()) / 1e3
    if not ks:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}; prefill_s {summary['prefill_s']} decode_s "
        f"{summary['decode_s']} itl_p50 {itl_p50_ms(sched.finished)} ms")
    for name, (ms, n) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile]   {ms / 1e3:8.4f} s {100 * ms / 1e3 / busy:5.1f}% "
            f"{n:7d} launches  {name[:90]}")


def backend_logits(torch, engine, prompt):
    """One prompt's prefill logits under the cuda and torch GEMM backends
    (same weights, same policy otherwise)."""
    from repro_torch.core.precision import PrecisionPolicy, use_policy
    from repro_torch.train.step import make_prefill_step

    tokens = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
    step = make_prefill_step(engine.cfg)
    out = {}
    for backend in ("cuda", "torch"):
        with use_policy(PrecisionPolicy(backend=backend)):
            frag = engine.new_frag(len(prompt))
            logits, _ = step(engine.params, tokens, frag)
        out[backend] = logits[0, -1, :engine.cfg.vocab_size].float()
    torch.cuda.synchronize()
    a, b = out["cuda"], out["torch"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite prefill logits")
    diff = float((a - b).abs().max())
    scale = float(b.abs().max())
    # stated bound: 48 layers of a bf16 residual stream; a one-ulp flip of
    # a bf16 rounding (2^-8 relative) may propagate, so the logits agree to
    # 2^-3 of their largest magnitude, and the argmax agrees wherever the
    # top-2 gap exceeds twice the observed difference
    bound = 2.0 ** -3 * scale
    top2 = torch.topk(b, 2).values
    gap = float(top2[0] - top2[1])
    log(f"[backends] prefill logits cuda vs torch: max|diff| {diff:.4e}, "
        f"max|logit| {scale:.4e}, bound {bound:.4e}, top-2 gap {gap:.4e}, "
        f"argmax {int(a.argmax())} vs {int(b.argmax())}")
    if diff > bound:
        raise AssertionError("prefill logits differ beyond the bound")
    if gap > 2 * diff and int(a.argmax()) != int(b.argmax()):
        raise AssertionError("argmax differs with a top-2 gap above 2x diff")
    return diff, bound


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the kernel phase")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import build

    phases = {}
    t = time.monotonic()
    card = smi("name,power.limit")
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(subprocess.run([build.nvcc(), "--version"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[-1])
    phases["device"] = time.monotonic() - t

    t = time.monotonic()
    reports = build.build_all()
    for name, rep in reports.items():
        for line in rep.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"[build {name}] {line.strip()}")
    phases["build"] = time.monotonic() - t
    log(f"[build] {len(reports)} kernels for sm_90a in {phases['build']:.1f} s")

    t = time.monotonic()
    timer = Timer(torch)
    kernels = [check_gemm(torch, timer), check_decode(torch, timer),
               check_prefill(torch, timer)]
    del timer
    phases["kernels"] = time.monotonic() - t
    log("kernels " + " ".join(
        f"{k['name']}: max_err={k['max_abs_err']:.3e} "
        f"err/bound={k['err_over_bound']:.4f} ms={k['ms']:.4f} "
        f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f}"
        for k in kernels))

    launches = {k["name"]: 0 for k in kernels}
    if not args.skip_serve:
        t = time.monotonic()
        summary, got, engine, sched = serve(torch)
        launches = {"sa_matmul": got["sa_matmul"],
                    "paged_decode_attention": got["paged_decode"],
                    "prefill_attention": got["prefill_attention"]}
        phases["serve"] = time.monotonic() - t
        t = time.monotonic()
        prompt = min(sched.finished, key=lambda r: r.rid).prompt
        backend_logits(torch, engine, prompt)
        phases["backends"] = time.monotonic() - t
        t = time.monotonic()
        profile_serve(torch, engine)
        phases["profile"] = time.monotonic() - t
        del engine
    log("[phases] " + " ".join(f"{k}={v:.1f}s" for k, v in phases.items()))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "err_over_bound", "timed")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

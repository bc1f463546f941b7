"""The bound column of PERF.md's kernel table, from the dry run's counter.

Each case calls a kernel's wrapper on meta tensors of a table row's
shapes inside `repro_torch.launch.cost.CostCounter`, and turns the
counter's flops and kernel bytes into the row's bound: the larger of the
bytes over the H100's 3.35 TB/s and the flops over its peak for their
type (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32; the
backward's `split3` runs three bf16 products a product). It prints each
row's value in the table, the counter's, and their ratio; a row off by
more than 1 % is marked. Runs on any host (no card, no JAX):

    PYTHONPATH=src python tools/dryrun_bounds.py
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import PrecisionPolicy, use_policy
from repro_torch.kernels import ops
from repro_torch.launch.cost import CostCounter

PEAK_BYTES, PEAK_BF16, PEAK_FP32 = 3.35e12, 989e12, 67e12
BF16, F32 = torch.bfloat16, torch.float32


def meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def gemms(m, shapes, a_dtype=BF16, w_dtype=BF16):
    """`ops.sa_matmul` on each (K, N, bias?) of `shapes` at M = m."""
    def run():
        for k, n, bias in shapes:
            ops.sa_matmul(meta(m, k, dtype=a_dtype), meta(k, n, dtype=w_dtype),
                          bias=meta(n, dtype=F32) if bias else None)
    return run


def backward(m, shapes):
    """The SA GEMM's backward GEMMs (dA, dW, the cotangent split once) of
    each (K, N) at M = m: bf16 operands, an fp32 cotangent."""
    from repro_torch.kernels.sa_matmul import backward_gemms

    def run():
        for k, n, _ in shapes:
            backward_gemms(meta(m, k), meta(k, n), meta(m, n, dtype=F32))
    return run


def decode(B, H, KVH, hd, psz, P, pool=F32, lse=False):
    def run():
        ops.paged_decode_attention(
            meta(B, 1, H, hd, dtype=F32), meta(B * P + 1, psz, KVH, hd,
                                              dtype=pool),
            meta(B * P + 1, psz, KVH, hd, dtype=pool),
            meta(B * P + 1, psz, dtype=torch.int32),
            meta(B, P, dtype=torch.int32), meta(B, dtype=torch.int32),
            lse=lse)
    return run


def prefill(T, H, KVH, hd, kv=F32, window=0, S=None):
    S = S or T

    def run():
        ops.sa_attention(meta(1, T, H, hd, dtype=F32),
                         meta(1, S, KVH, hd, dtype=kv),
                         meta(1, S, KVH, hd, dtype=kv), window=window,
                         q_offset=S - T)
    return run


def layer(cfg, bias=True):
    d, hd, ff = cfg.d_model, cfg.hd, cfg.d_ff
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return [(d, q, bias), (d, kv, bias), (d, kv, bias), (q, d, False),
            (d, ff, False), (d, ff, False), (ff, d, False)]


QWEN, GRANITE = get_config("qwen2.5-14b"), get_config("granite-moe-3b-a800m")
L = layer(QWEN)
EXPERT_G = [(1536, 40, False)] + 40 * [(1536, 512, False), (1536, 512, False),
                                       (512, 1536, False)]

# (row, the table's bound ms, run, flop peak, live decode keys)
CASES = [
    ("1 a layer's 7 decode GEMMs, M=4", 0.1647, gemms(4, L), PEAK_BF16),
    ("1 a layer's 7 forward GEMMs, M=1024", 0.570, gemms(1024, L),
     PEAK_BF16),
    ("1 the verify's layer, M=20", 0.1659, gemms(20, L), PEAK_BF16),
    ("1 lm_head M=4", 0.4703, gemms(4, [(5120, QWEN.padded_vocab, False)]),
     PEAK_BF16),
    ("1 lm_head M=1024", 1.6285,
     gemms(1024, [(5120, QWEN.padded_vocab, False)]), PEAK_BF16),
    ("1 tied lm_head gemma2 M=4", 0.5490, gemms(4, [(3584, 256000, False)]),
     PEAK_BF16),
    ("1 tied lm_head gemma3 M=4", 0.6022, gemms(4, [(3840, 262144, False)]),
     PEAK_BF16),
    ("1 tied lm_head gemma2 M=1024", 1.8999,
     gemms(1024, [(3584, 256000, False)]), PEAK_BF16),
    ("1 tied lm_head gemma3 M=1024", 2.0845,
     gemms(1024, [(3840, 262144, False)]), PEAK_BF16),
    ("1 granite router M=4", 0.0000405, gemms(4, [(1536, 40, False)]),
     PEAK_BF16),
    ("1 llama4 router M=4", 0.000404, gemms(4, [(5120, 128, False)]),
     PEAK_BF16),
    ("1 granite MoE layer M=4", 0.05721, gemms(4, EXPERT_G), PEAK_BF16),
    ("1 llama4 expert M=4", 0.07512,
     gemms(4, [(5120, 8192, False), (5120, 8192, False),
               (8192, 5120, False)]), PEAK_BF16),
    ("1 granite expert piece wg at model 16, M=4", 0.0000332,
     gemms(4, [(1536, 32, False)]), PEAK_BF16),
    ("1 mamba2 in_proj piece at model 2, M=4", 0.0081,
     gemms(4, [(2560, 5288, False)]), PEAK_BF16),
    ("1 mamba2 out_proj chain at model 2, M=4", 0.0039,
     gemms(4, [(2560, 2560, False)]), PEAK_BF16),
    ("1 hymba out_proj chain at model 4, M=4", 0.000774,
     gemms(4, [(800, 1600, False)]), PEAK_BF16),
    ("1 whisper w1 piece at model 4, M=6000", 0.0042,
     gemms(6000, [(384, 384, False)]), PEAK_BF16),
    ("1 whisper cross wk piece at model 4, M=6000", 0.0021,
     gemms(6000, [(384, 96, False)]), PEAK_BF16),
    ("1 mamba2 in_proj M=4", 0.01622, gemms(4, [(2560, 10576, False)]),
     PEAK_BF16),
    ("1 mamba2 out_proj M=4", 0.00785, gemms(4, [(5120, 2560, False)]),
     PEAK_BF16),
    ("1 hymba in_proj M=4", 0.00623, gemms(4, [(1600, 6482, False)]),
     PEAK_BF16),
    ("1 hymba out_proj M=4", 0.00307, gemms(4, [(3200, 1600, False)]),
     PEAK_BF16),
    ("1 fp32 x fp32 layer, partial, M=4", 0.3291,
     gemms(4, L, F32, F32), PEAK_FP32),
    ("1 fp32 x fp32 layer, simt, M=1024", 8.4136,
     gemms(1024, L, F32, F32), PEAK_FP32),
    ("1b a layer's 7 dA + dW pairs, M=1024", 3.420,
     backward(1024, L), PEAK_BF16 / 3),
    ("1 whisper (384, 384) M=6000", 0.00421,
     gemms(6000, [(384, 384, False)]), PEAK_BF16),
    ("1 whisper w1 (384, 1536) M=6000", 0.01273,
     gemms(6000, [(384, 1536, False)]), PEAK_BF16),
    ("1 whisper w2 (1536, 384) M=6000", 0.00861,
     gemms(6000, [(1536, 384, False)]), PEAK_BF16),
    ("1 whisper (384, 384) M=4", 0.00009, gemms(4, [(384, 384, False)]),
     PEAK_BF16),
    ("1 whisper lm_head M=4", 0.01246, gemms(4, [(384, 53248, False)]),
     PEAK_BF16),
    # the serve shape's slots of 144, 100, 40 and 0 tokens, slot 0 with a
    # trash-page entry: 8, 7, 3 and 0 pages read, a launch a slot summed
    ("2 B=4, slots of 144, 100, 40, 0 tokens", 0.00075,
     [(decode(1, 40, 8, 128, 16, 9), rows) for rows in (128, 112, 48, 0)],
     PEAK_BF16),
    ("2 B=4, 2048-token slots", 0.02005, decode(4, 40, 8, 128, 16, 128),
     PEAK_BF16, 2048),
    ("2 B=4, 2048-token slots, bf16 pool", 0.01006,
     decode(4, 40, 8, 128, 16, 128, BF16), PEAK_BF16, 2048),
    ("2 B=20, 144-token slots", 0.00725, decode(20, 40, 8, 128, 16, 9),
     PEAK_BF16, 144),
    ("2 B=64, 144-token slots", 0.02329, decode(64, 40, 8, 128, 16, 9),
     PEAK_BF16, 144),
    ("2 g=5, hd 64, 2048-row rings", 0.00629,
     decode(4, 25, 5, 64, 16, 128), PEAK_BF16, 2048),
    ("2 g=1, hd 64, 2048-row rings", 0.00753,
     decode(4, 6, 6, 64, 16, 128), PEAK_BF16, 2048),
    ("2 lse: B=1, 2048 rows, g=5, 4 KV heads", 0.00251,
     decode(1, 20, 4, 128, 16, 128, lse=True), PEAK_BF16, 2048),
    ("3 T=128", 0.00188, prefill(128, 40, 8, 128), PEAK_BF16),
    ("3 T=128, bf16 K/V", 0.00172, prefill(128, 40, 8, 128, BF16),
     PEAK_BF16),
    ("3 T=1024", 0.01502, prefill(1024, 40, 8, 128), PEAK_BF16),
    ("3 gemma3 hd 256, T=1024", 0.01502, prefill(1024, 16, 8, 256),
     PEAK_BF16),
    ("3 gemma3 hd 256, T=1500, window 1024", 0.02201,
     prefill(1500, 16, 8, 256, window=1024), PEAK_BF16),
    ("3 gemma2 hd 256, T=4200, window 4096", 0.14606,
     prefill(4200, 16, 8, 256, window=4096), PEAK_BF16),
    ("3 hymba hd 64, T=2600, window 2048", 0.02089,
     prefill(2600, 25, 5, 64, window=2048), PEAK_BF16),
    ("3 whisper g=1, hd 64, T=64", 0.000117, prefill(64, 6, 6, 64),
     PEAK_BF16),
    ("3 pixtral T=384", 0.00470, prefill(384, 32, 8, 128), PEAK_BF16),
    ("4 quantize 2^24 fp32", 0.0401,
     lambda: ops.quantize_fp8(meta(1 << 24, dtype=F32), 1.0), PEAK_BF16),
]


def bound(run, peak, keys=None) -> tuple[float, str]:
    """`run` (or a list of (run, keys) parts, summed) → (bound ms, by)."""
    nbytes = flops = 0
    for part, k in (run if isinstance(run, list) else [(run, keys)]):
        with use_policy(PrecisionPolicy(backend="cuda")), \
                CostCounter(decode_keys=k) as c:
            part()
        s = c.summary()
        nbytes, flops = nbytes + s["kernel_bytes"], flops + s["flops"]
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def main():
    off = 0
    for row, table, run, peak, *keys in CASES:
        ms, by = bound(run, peak, *keys)
        ratio = ms / table
        mark = "" if abs(ratio - 1) <= 0.01 else "  <-- off by more than 1 %"
        off += bool(mark)
        print(f"{row:44s} table {table:<9.6g} counter {ms:.6g} ({by}) "
              f"ratio {ratio:.4f}{mark}")
    print(f"{len(CASES)} rows, {off} off by more than 1 %")


if __name__ == "__main__":
    main()

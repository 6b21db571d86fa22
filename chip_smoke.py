#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one Hopper card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing JSON lines (any failure exits non-zero):

1. device: the card (nvidia-smi name and power limit), versions, and the
   build of every kernel under paddle_tpu_torch/ops/hopper/csrc with nvcc
   (one process per source, all started together), with ptxas's report
   (registers, spills) and the shared memory of each bf16 backward build.
2. kernels: each kernel against its plain PyTorch version on the card,
   case by case with the tolerance stated (and, for the backward and AdamW
   kernels, two launches bit for bit), the flash kernels also under
   additive masks and the block-sparse kernel over random, BigBird, empty
   and full tile rows, then timed at the serving and training paths'
   shapes (and the masked flash kernels at the packed-document training
   shape) beside its plain version, one PyTorch library call, and the
   card's bound for the same work; the whole flash backward (delta, dQ,
   dK/dV) is timed beside SDPA's backward, causal and masked.
3. width: Llama-2-7B width (bf16, 2 layers, random weights from --seed),
   one 128-token prompt, prefill on the card (kernels) against the same
   weights in float32 on the CPU (plain versions).
3b. train_width: the same width, loss and every parameter's grad of one
   1 x 128-token batch, on the card (bf16 O2, kernels) against the CPU
   (float32, plain versions).
3c. train_width_masked: the same check with a packed-document mask (the
   masked flash kernels).
4. serve: Llama-2-7B (bf16, all 32 layers) serves 4
   requests of 512 prompt tokens and 32 greedy new tokens through
   LlamaForCausalLM.generate; the launch counts prove the path ran the
   kernels. Prefill time, decode tokens/s and peak memory are reported,
   and a short profile of one prefill and one decode step is printed.
5. train: Llama-2-7B width at 8 of its 32 layers trains 5 steps of
   4 x 2048 tokens (AdamW, amp.decorate O2 bf16, recompute, TrainStep);
   the launch counts of one step prove the path ran every kernel, and its
   profile that the backward ran the bf16 tensor-core builds only. Step
   time, tokens/s, MFU, peak memory, the device's idle share, the top
   kernels of one profiled step and every loss are reported.
5b. train_packed: the same path trains 3 steps on packed documents under a
   float32 [4, 1, 2048, 2048] block-diagonal causal mask (document lengths
   drawn from --seed); the launch counts of one step prove the masked
   flash kernels ran. The same reports and checks as train.
6. sparse: F.sparse_attention at BERT-base width (12 heads x 64) and
   BigBird-base length (4096 tokens; 2 global, 3 window and 3 random
   128-token tiles) from an int32 CSR built from --seed: one block-sparse
   launch per call, the output and the q/k/v grads against the plain
   version, the call's host (CSR probe) and device time; then a pattern
   that is not tile-aligned takes the dense route with no launch.

The last two lines are the {"kernels": [...]} summary and the result
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def tolerance(ref, dtype):
    """bf16 results are compared in bf16: one bf16 ulp at the largest
    magnitude (2^-7 relative), since the kernel and the plain version
    round the same float32 math once and may land one ulp apart. float32:
    2e-5 relative to the largest magnitude, for summation order."""
    scale = max(1.0, float(ref.float().abs().max()))
    return scale * (2.0 ** -7 if dtype == torch.bfloat16 else 2e-5)


def time_ms(fn, iters=10):
    """Median device time of one call, with L2 (50 MB) flushed by a 256 MB
    write before each call, as the serving path finds it cold. A ~2 ms
    device-side wait after the flush lets the host queue the start event,
    the call and the end event before the card reaches them, so the
    host's launch latency stays outside the interval."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(4_000_000)     # clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def within_bf16_ulp(a, ref):
    """Elementwise: |a - ref| <= one bf16 ulp of ref."""
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
                     - 7)
    return bool(((a.float() - ref).abs() <= ulp).all())


def bwd_tolerance(ref, dtype):
    """Backward kernels: bf16 as `tolerance` (one ulp at the largest
    magnitude: both sides sum in float32 and round once). float32: 1e-4 of
    the largest magnitude: the sums run over up to 8192 terms of random
    sign whose magnitudes exceed the result's by about their square root,
    so a different summation order moves the result by ~1e-5 of itself."""
    scale = max(1.0, float(ref.float().abs().max()))
    return scale * (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def bigbird_tiles(nb, seed):
    """BigBird-base's pattern (google/bigbird-roberta-base: 2 global, 3
    window and 3 random blocks) at 128-token tiles: tile rows 0 and nb - 1
    attend everywhere, the others to tile columns 0 and nb - 1, their
    window of 3 and 3 random other tiles drawn from `seed`."""
    rng = np.random.RandomState(seed)
    bm = np.zeros((nb, nb), bool)
    bm[[0, -1], :] = True
    bm[:, [0, -1]] = True
    for r in range(1, nb - 1):
        bm[r, r - 1:r + 2] = True
        bm[r, rng.choice(np.flatnonzero(~bm[r]), 3, replace=False)] = True
    return bm


def packed_doc_mask(batch, seq, lo, hi, seed, device="cuda"):
    """Packed documents: each row is filled with documents whose lengths are
    uniform in [lo, hi] (the last one cut to fit), and the float32 additive
    mask [batch, 1, seq, seq] is 0 where a token may attend (same document,
    not later) and -1e9 elsewhere. Returns (mask, lengths per row)."""
    rng = np.random.RandomState(seed)
    doc = np.zeros((batch, seq), np.int64)
    lengths = []
    for r in range(batch):
        row, start = [], 0
        while start < seq:
            n = min(int(rng.randint(lo, hi + 1)), seq - start)
            doc[r, start:start + n] = len(row)
            row.append(n)
            start += n
        lengths.append(row)
    ids = torch.from_numpy(doc).to(device)
    keep = (ids[:, :, None] == ids[:, None, :]) & torch.ones(
        seq, seq, dtype=torch.bool, device=device).tril()
    mask = torch.zeros(batch, 1, seq, seq, device=device)
    return mask.masked_fill_(~keep[:, None], -1e9), lengths


# -- phase 1 -----------------------------------------------------------------

def phase_device():
    from paddle_tpu_torch import on_hopper
    from paddle_tpu_torch.ops.hopper import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if not on_hopper():
        fail(f"{torch.cuda.get_device_name(0)} is not a Hopper card "
             "(compute capability 9.0)")
    nvcc_version = subprocess.run(
        [_build.nvcc(), "--version"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[-1]
    build_s = _build.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.build_logs.items()}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version,
          "kernel_build_s": build_s, "ptxas": ptxas,
          "ptxas_bwd_wgmma": wgmma_bwd_report(
              _build.build_logs.get("flash_attention_bwd", ""))})


def wgmma_bwd_report(log):
    """Per build of the bf16 backward kernels (flash_bwd_dq_wgmma and
    flash_bwd_dkv_wgmma, template <D, mask code, mask as TMA windows>):
    ptxas's registers and spill lines and any note that it serialised the
    wgmma products, and the dynamic shared memory the launch asks for
    (ptxas reports static shared memory only)."""
    from paddle_tpu_torch.ops.hopper import _build
    from paddle_tpu_torch.ops.hopper.flash_attention import _BWD_SIGNATURES
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    smem_of = lib.flash_attention_bwd_wgmma_smem
    smem_of.argtypes = [ctypes.c_int] * 4
    smem_of.restype = ctypes.c_int
    report, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(flash_bwd_\w+_wgmma)"
                      r"ILi(\d+)ELi(\d+)ELb([01])E", ln)
        serial = re.search(r"\((C75\d\d)\).*?serialized.*?"
                           r"(flash_bwd_\w+_wgmma)ILi(\d+)ELi(\d+)ELb([01])E",
                           ln)
        if m:
            name = f"{m[1]}<{m[2]}, {m[3]}, {m[4]}>"
            smem = smem_of(int("dkv" in m[1]), int(m[2]), int(m[3]),
                           int(m[4]))
            report.setdefault(name, []).append(
                f"{smem} bytes dynamic shared memory")
        elif serial:
            report.setdefault(f"{serial[2]}<{serial[3]}, {serial[4]}, "
                              f"{serial[5]}>", []).append(
                f"{serial[1]}: wgmma serialized")
        elif "Compiling entry function" in ln:
            name = None
        elif name and ("spill" in ln or "registers" in ln):
            report[name].append(ln.split("info    :")[-1].strip())
    return report


# -- phase 2 -----------------------------------------------------------------

def flash_case(gen, dtype, causal, hq, hkv, s, d, b=2):
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_plain)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rec = {"kernel": "flash_attention", "dtype": str(dtype)[6:],
           "causal": causal, "heads": [hq, hkv], "s": s, "d": d,
           "max_abs_err": max_err(out, ref), "tol": tolerance(ref, dtype),
           "lse_max_abs_err": max_err(lse, ref_lse),
           "lse_tol": tolerance(ref_lse, torch.float32)}
    emit(rec)
    if not (rec["max_abs_err"] <= rec["tol"]
            and rec["lse_max_abs_err"] <= rec["lse_tol"]):
        fail(f"flash_attention disagrees with its plain version: {rec}")
    return (q, k, v), rec


def rms_case(gen, dtype, shape):
    from paddle_tpu_torch.ops.hopper import rms_norm, rms_norm_plain
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
         ).to(dtype)
    y, rstd = rms_norm(x, w, 1e-5)
    ref, ref_rstd = rms_norm_plain(x, w, 1e-5)
    torch.cuda.synchronize()
    rec = {"kernel": "rms_norm", "dtype": str(dtype)[6:],
           "shape": list(shape), "max_abs_err": max_err(y, ref),
           "tol": tolerance(ref, dtype),
           "rstd_max_abs_err": max_err(rstd, ref_rstd),
           "rstd_tol": tolerance(ref_rstd, torch.float32)}
    emit(rec)
    if not (rec["max_abs_err"] <= rec["tol"]
            and rec["rstd_max_abs_err"] <= rec["rstd_tol"]):
        fail(f"rms_norm disagrees with its plain version: {rec}")
    return (x, w), rec


def flash_bwd_case(gen, dtype, causal, hq, hkv, s, d, b=2, qkv=None):
    """The backward kernels against the plain backward on the forward
    kernel's out and lse; `qkv` reuses inputs whose forward was already
    checked at that shape."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_bwd,
                                             flash_attention_bwd_plain)
    if qkv is None:
        qkv = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
               for h in (hq, hkv, hkv))
    q, k, v = qkv
    dout = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal)
    again = flash_attention_bwd(q, k, v, out, dout, lse, causal)
    ref = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal)
    torch.cuda.synchronize()
    rec = {"kernel": "flash_attention_bwd", "dtype": str(dtype)[6:],
           "causal": causal, "heads": [hq, hkv], "s": s, "d": d,
           "bit_identical": all(torch.equal(a, c)
                                for a, c in zip(got, again))}
    ok = rec["bit_identical"]
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        rec[f"{name}_max_abs_err"] = max_err(a, r)
        rec[f"{name}_tol"] = bwd_tolerance(r, dtype)
        ok = ok and rec[f"{name}_max_abs_err"] <= rec[f"{name}_tol"]
    emit(rec)
    if not ok:
        fail(f"flash_attention_bwd disagrees with its plain version: {rec}")
    return (q, k, v, out, dout, lse), rec


def rms_bwd_case(gen, dtype, shape):
    from paddle_tpu_torch.ops.hopper import (rms_norm, rms_norm_bwd,
                                             rms_norm_bwd_plain)
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
         ).to(dtype)
    g = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    _, rstd = rms_norm(x, w, 1e-5)
    got = rms_norm_bwd(x, w, g, rstd)
    again = rms_norm_bwd(x, w, g, rstd)
    ref = rms_norm_bwd_plain(x, w, g, rstd)
    torch.cuda.synchronize()
    rec = {"kernel": "rms_norm_bwd", "dtype": str(dtype)[6:],
           "shape": list(shape),
           "bit_identical": all(torch.equal(a, c)
                                for a, c in zip(got, again))}
    ok = rec["bit_identical"]
    for name, a, r in zip(("dx", "dw"), got, ref):
        rec[f"{name}_max_abs_err"] = max_err(a, r)
        rec[f"{name}_tol"] = bwd_tolerance(r, dtype)
        ok = ok and rec[f"{name}_max_abs_err"] <= rec[f"{name}_tol"]
    emit(rec)
    if not ok:
        fail(f"rms_norm_bwd disagrees with its plain version: {rec}")
    return (x, w, g, rstd), rec


def adamw_case(gen, n, step, wd, lowp):
    """AdamW at step `step` from random moments; float32 master, bf16 grad
    and (with `lowp`) a bf16 parameter copy. Tolerance: float32 results
    within 2e-6 of each array's largest magnitude (a few ulps: nvcc
    contracts the multiply-adds into FMAs, the plain version does not);
    the bf16 copy within one bf16 ulp of the plain version's rounding."""
    from paddle_tpu_torch.ops.hopper import adamw_, adamw_plain
    b1, b2 = 0.9, 0.999
    hyper = dict(lr=1e-4, beta1=b1, beta2=b2, eps=1e-8, weight_decay=wd,
                 bc1=1 - b1 ** step, bc2=1 - b2 ** step)
    p = torch.randn(n, generator=gen, device="cuda")
    g = (1e-2 * torch.randn(n, generator=gen, device="cuda")
         ).to(torch.bfloat16)
    fresh = step == 1
    m = torch.zeros(n, device="cuda") if fresh else \
        1e-3 * torch.randn(n, generator=gen, device="cuda")
    v = torch.zeros(n, device="cuda") if fresh else \
        1e-5 * torch.rand(n, generator=gen, device="cuda")
    ref = adamw_plain(p, m, v, g, **hyper)
    outs = []
    for _ in range(2):
        state = [t.clone() for t in (p, m, v)]
        copy = torch.empty(n, dtype=torch.bfloat16, device="cuda") \
            if lowp else None
        adamw_(*state, g, p_lowp=copy, **hyper)
        outs.append(state + ([copy] if lowp else []))
    torch.cuda.synchronize()
    rec = {"kernel": "adamw", "n": n, "step": step, "weight_decay": wd,
           "bf16_copy": lowp,
           "bit_identical": all(torch.equal(a, c)
                                for a, c in zip(*outs)),
           "tol_rel": 2e-6}
    ok = rec["bit_identical"]
    for name, a, r in zip(("p", "m", "v"), outs[0], ref):
        rec[f"{name}_max_abs_err"] = max_err(a, r)
        ok = ok and rec[f"{name}_max_abs_err"] <= \
            2e-6 * float(r.abs().max())
    if lowp:
        rec["copy_within_one_ulp"] = within_bf16_ulp(outs[0][3], ref[0])
        ok = ok and rec["copy_within_one_ulp"]
    emit(rec)
    if not ok:
        fail(f"adamw disagrees with its plain version: {rec}")
    return rec


def phase_kernels(seed):
    """Every case, then timings at the serving and training paths' shapes.
    Returns the per-kernel records of the summary line (launches are filled
    in by the serve and train phases)."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_plain, rms_norm,
                                             rms_norm_plain)
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16

    for dtype in (bf16, torch.float32):
        for causal in (True, False):
            for hq, hkv in ((32, 32), (32, 8)):
                for s in (2048, 512, 300):
                    for d in (128, 64):
                        flash_case(gen, dtype, causal, hq, hkv, s, d,
                                   b=1 if s == 2048 else 2)
    for dtype, shape in ((bf16, (4 * 2048, 4096)), (bf16, (4 * 512, 4096)),
                         (bf16, (4, 1, 4096)),
                         (bf16, (37, 4096)), (torch.float32, (37, 4096)),
                         (torch.float32, (3, 5, 1000)),
                         (torch.float32, (4, 1, 4096))):
        rms_case(gen, dtype, shape)

    # the serving path's shapes: prefill attention (4 x 512, 32 heads,
    # d 128, causal, bf16) and the prefill/decode norms
    (q, k, v), frec = flash_case(gen, bf16, True, 32, 32, 512, 128, b=4)
    b, s, hq, d = q.shape
    pairs = s * (s + 1) // 2
    f_bound, f_by = bound(4 * q.numel() * q.element_size() + b * hq * s * 4,
                          4 * b * hq * d * pairs, H100_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/hopper/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:124",
        "shape": "q,k,v [4, 512, 32, 128] bf16 causal",
        "max_abs_err": frec["max_abs_err"], "tol": frec["tol"],
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, True)),
        "bound_ms": f_bound, "bound_by": f_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
    }
    del q, k, v, qt, kt, vt

    rms = None
    for shape in ((4 * 512, 4096), (4, 1, 4096)):
        (x, w), rrec = rms_case(gen, bf16, shape)
        n = x.numel()
        rows = n // x.shape[-1]
        r_bound, r_by = bound(2 * n * 2 + w.numel() * 2 + rows * 4, 4 * n,
                              H100_FP32_FLOPS)
        rec = {
            "name": "rms_norm", "route": "cuda",
            "source": "paddle_tpu_torch/ops/hopper/csrc/rms_norm.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_ops.py:36",
            "shape": f"x {list(shape)} bf16",
            "max_abs_err": rrec["max_abs_err"], "tol": rrec["tol"],
            "ms": time_ms(lambda: rms_norm(x, w, 1e-5)),
            "plain_ms": time_ms(lambda: rms_norm_plain(x, w, 1e-5)),
            "bound_ms": r_bound, "bound_by": r_by,
            "library_ms": time_ms(lambda: F.rms_norm(
                x, (x.shape[-1],), w, 1e-5)),
        }
        if rms is None:
            rms = rec                      # the summary line's shape
        else:
            emit({"phase": "kernels", "timing_at_decode_shape": rec})
        del x, w
    records = [flash, rms] + train_kernels(gen)
    for rec in records:
        emit({"phase": "kernels", "timing": rec})
    masked = masked_flash_kernels(gen, seed)
    for rec in records:
        if rec["name"] in masked:
            rec["masked"] = masked[rec["name"]]
    return records + [block_sparse_kernels(gen, seed)]


def train_kernels(gen):
    """The backward and AdamW kernels: every case, then timings at the
    train phase's shapes."""
    from paddle_tpu_torch.ops.hopper import (adamw_, adamw_plain,
                                             flash_attention_bwd,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_bwd_plain,
                                             rms_norm_bwd,
                                             rms_norm_bwd_plain)
    from paddle_tpu_torch.ops.hopper.flash_attention import _delta
    F = torch.nn.functional
    bf16 = torch.bfloat16
    for dtype in (bf16, torch.float32):
        for causal in (True, False):
            for hq, hkv in ((32, 32), (32, 8)):
                for s in (2048, 300):
                    for d in (128, 64):
                        flash_bwd_case(gen, dtype, causal, hq, hkv, s, d,
                                       b=1 if s == 2048 else 2)
    # s = 1000 is a multiple of neither the 64- nor the 128-row tiles
    for causal in (True, False):
        for d in (128, 64):
            flash_bwd_case(gen, bf16, causal, 32, 4, 1000, d)
    for dtype, shape in ((bf16, (8192, 4096)), (bf16, (300, 1000)),
                         (torch.float32, (8192, 4096)),
                         (torch.float32, (300, 1000))):
        rms_bwd_case(gen, dtype, shape)
    for n, lowp in ((11008 * 4096, True), (1000, True), (1003, False)):
        for step in (1, 10):
            for wd in (0.01, 0.0):
                adamw_case(gen, n, step, wd, lowp)

    # the train phase's shapes: attention q, k, v [4, 2048, 32, 128] bf16
    # causal (its forward checked first, then the backward on the same
    # inputs); norms x [8192, 4096] bf16; AdamW on one [11008, 4096] weight
    qkv, _ = flash_case(gen, bf16, True, 32, 32, 2048, 128, b=4)
    (q, k, v, out, dout, lse), frec = flash_bwd_case(gen, bf16, True, 32, 32,
                                                     2048, 128, b=4, qkv=qkv)
    del qkv
    b, s, hq, d = q.shape
    pairs = s * (s + 1) // 2
    gemm = 2 * b * hq * d * pairs          # one causal product
    io = q.numel() * q.element_size()      # one [b, s, h, d] bf16 tensor
    rows = 2 * b * hq * s * 4              # lse and delta
    delta = _delta(out, dout)
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, out, dout,
                                                         lse, True), 5)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = dout.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    del lib_out, qt, kt, vt, dot
    shape = "q,k,v [4, 2048, 32, 128] bf16 causal"
    src = "paddle_tpu_torch/ops/hopper/csrc/flash_attention_bwd.cu"
    records = []
    for name, line, fn, nbytes, flops, err in (
            ("flash_attention_bwd_dq", 180,
             lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, True),
             5 * io + rows, 3 * gemm, frec["dq_max_abs_err"]),
            ("flash_attention_bwd_dkv", 231,
             lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                             True),
             6 * io + rows, 4 * gemm,
             max(frec["dk_max_abs_err"], frec["dv_max_abs_err"]))):
        b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
        records.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "shape": shape, "max_abs_err": err,
            "ms": time_ms(fn), "plain_ms": plain_ms,
            "plain_note": "the whole plain backward (dq, dk, dv)",
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library_note": "backward of F.scaled_dot_product_attention "
                            "(dq, dk, dv together)"})
    emit({"phase": "kernels", "timing_whole_bwd": {
        "shape": shape, "what": "flash_attention_bwd: delta, dQ, dK/dV",
        "ms": time_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse,
                                                  True)),
        "library_ms": library_ms,
        "library_note": "backward of F.scaled_dot_product_attention"}})
    del q, k, v, out, dout, lse, delta

    (x, w, g, rstd), rrec = rms_bwd_case(gen, bf16, (8192, 4096))
    n = x.numel()
    r_bound, r_by = bound(3 * n * 2 + 2 * w.numel() * 2 + rstd.numel() * 4,
                          8 * n, H100_FP32_FLOPS)
    xl = x.detach().requires_grad_()
    wl = w.detach().requires_grad_()
    lib_y = F.rms_norm(xl, (x.shape[-1],), wl, 1e-5)
    records.append({
        "name": "rms_norm_bwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/hopper/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_ops.py:45",
        "shape": "x, g [8192, 4096] bf16",
        "max_abs_err": max(rrec["dx_max_abs_err"], rrec["dw_max_abs_err"]),
        "ms": time_ms(lambda: rms_norm_bwd(x, w, g, rstd)),
        "plain_ms": time_ms(lambda: rms_norm_bwd_plain(x, w, g, rstd)),
        "bound_ms": r_bound, "bound_by": r_by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            lib_y, (xl, wl), g, retain_graph=True)),
        "library_note": "backward of F.rms_norm"})
    del x, w, g, rstd, xl, wl, lib_y

    arec = adamw_case(gen, 11008 * 4096, 10, 0.01, True)
    n = 11008 * 4096
    p = torch.randn(n, generator=gen, device="cuda")
    m = 1e-3 * torch.randn(n, generator=gen, device="cuda")
    v = 1e-5 * torch.rand(n, generator=gen, device="cuda")
    gr = (1e-2 * torch.randn(n, generator=gen, device="cuda")).to(bf16)
    copy = torch.empty(n, dtype=bf16, device="cuda")
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, bc1=0.5, bc2=0.01)
    a_bound, a_by = bound(28 * n, 15 * n, H100_FP32_FLOPS)
    kernel_ms = time_ms(lambda: adamw_(p, m, v, gr, p_lowp=copy, **hyper))
    plain_ms = time_ms(lambda: adamw_plain(p, m, v, gr, **hyper))
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = gr.float()
    lib_opt = torch.optim.AdamW([lib_p], lr=1e-4, weight_decay=0.01,
                                fused=True)
    library_ms = time_ms(lib_opt.step)
    records.append({
        "name": "adamw", "route": "cuda",
        "source": "paddle_tpu_torch/ops/hopper/csrc/adamw.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_ops.py:165",
        "shape": "[11008, 4096] float32 master, bf16 grad and copy",
        "max_abs_err": max(arec["p_max_abs_err"], arec["m_max_abs_err"],
                           arec["v_max_abs_err"]),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": a_bound,
        "bound_by": a_by, "library_ms": library_ms,
        "library_note": "torch.optim.AdamW(fused=True).step, float32 "
                        "param and grad"})
    del p, m, v, gr, copy, lib_p, lib_opt
    torch.cuda.empty_cache()
    return records


def masked_flash_case(gen, dtype, mask_dtype, causal, hq, hkv, s, d,
                      mask_heads, b=2):
    """The forward and both backward kernels under an additive mask
    [b, mask_heads, s, s] (30% of it -1e9, the rest unit normal, and one
    row hidden entirely, which comes out uniform) against the plain
    versions; the backward twice, bit for bit."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_bwd,
                                             flash_attention_bwd_plain,
                                             flash_attention_plain)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    dout = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    shape = (b, mask_heads, s, s)
    mask = torch.where(
        torch.rand(*shape, generator=gen, device="cuda") < 0.3, -1e9,
        torch.randn(*shape, generator=gen, device="cuda")).to(mask_dtype)
    mask[0, :, s // 3, :] = -1e9
    out, lse = flash_attention(q, k, v, causal, mask)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, mask)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal, mask)
    again = flash_attention_bwd(q, k, v, out, dout, lse, causal, mask)
    ref_g = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, mask)
    torch.cuda.synchronize()
    rec = {"kernel": "flash_attention_masked", "dtype": str(dtype)[6:],
           "mask": [list(shape), str(mask_dtype)[6:]], "causal": causal,
           "heads": [hq, hkv], "s": s, "d": d,
           "max_abs_err": max_err(out, ref), "tol": tolerance(ref, dtype),
           "lse_max_abs_err": max_err(lse, ref_lse),
           "lse_tol": tolerance(ref_lse, torch.float32),
           "bit_identical": all(torch.equal(a, c)
                                for a, c in zip(got, again))}
    ok = rec["bit_identical"] and rec["max_abs_err"] <= rec["tol"] and \
        rec["lse_max_abs_err"] <= rec["lse_tol"]
    for name, a, r in zip(("dq", "dk", "dv"), got, ref_g):
        rec[f"{name}_max_abs_err"] = max_err(a, r)
        rec[f"{name}_tol"] = bwd_tolerance(r, dtype)
        ok = ok and rec[f"{name}_max_abs_err"] <= rec[f"{name}_tol"]
    emit(rec)
    if not ok:
        fail(f"masked flash attention disagrees with its plain version: "
             f"{rec}")


def masked_flash_kernels(gen, seed):
    """The flash kernels with the additive mask: every case, then the three
    kernels timed at the training shape under the packed-document mask.
    Returns {kernel name: timing record}."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_bwd,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_bwd_plain,
                                             flash_attention_plain)
    from paddle_tpu_torch.ops.hopper.flash_attention import _delta
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        for causal in (False, True):
            for hq, hkv in ((32, 32), (32, 8)):
                for s, d in ((2048, 128), (300, 64)):
                    for mask_heads in (1, hq):
                        masked_flash_case(gen, dtype, f32, causal, hq, hkv, s,
                                          d, mask_heads,
                                          b=1 if s == 2048 else 2)
    for s, d in ((2048, 128), (300, 64)):       # a mask of q's type
        masked_flash_case(gen, bf16, bf16, False, 32, 8, s, d, 1,
                          b=1 if s == 2048 else 2)
    # s = 1000: ragged tiles; the bf16 mask's rows (2000 bytes) reach the
    # kernels by TMA, where s = 300's (600 bytes) are read from memory
    for causal in (False, True):
        for d in (128, 64):
            masked_flash_case(gen, bf16, bf16, causal, 32, 4, 1000, d, 1)

    # the packed-document training shape: q, k, v [4, 2048, 32, 128] bf16,
    # non-causal under a float32 [4, 1, 2048, 2048] mask
    b, s, h, d = 4, 2048, 32, 128
    mask, _ = packed_doc_mask(b, s, 256, 1024, seed + 4)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=gen,
                                 device="cuda").to(bf16) for _ in range(4))
    out, lse = flash_attention(q, k, v, False, mask)
    ref, _ = flash_attention_plain(q, k, v, False, mask)
    got = flash_attention_bwd(q, k, v, out, dout, lse, False, mask)
    ref_g = flash_attention_bwd_plain(q, k, v, out, dout, lse, False, mask)
    torch.cuda.synchronize()
    errs = {"flash_attention": max_err(out, ref),
            "flash_attention_bwd_dq": max_err(got[0], ref_g[0]),
            "flash_attention_bwd_dkv": max(max_err(got[1], ref_g[1]),
                                           max_err(got[2], ref_g[2]))}
    tols = {"flash_attention": tolerance(ref, bf16),
            "flash_attention_bwd_dq": bwd_tolerance(ref_g[0], bf16),
            "flash_attention_bwd_dkv": max(bwd_tolerance(ref_g[1], bf16),
                                           bwd_tolerance(ref_g[2], bf16))}
    if any(errs[n] > tols[n] for n in errs):
        fail(f"masked flash at the training shape: {errs} against {tols}")
    del ref, got, ref_g
    delta = _delta(out, dout)
    gemm = 2 * b * h * d * s * s            # one non-causal product
    io = q.numel() * q.element_size()
    rows = 2 * b * h * s * 4                # lse and delta
    mask_bytes = mask.numel() * mask.element_size()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_mask = mask.to(bf16)                # SDPA takes a mask of q's type
    fwd_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=lib_mask))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask)
    dot = dout.transpose(1, 2)
    bwd_lib = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    del lib_out, qt, kt, vt, dot, lib_mask
    bwd_plain = time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, out, dout, lse, False, mask), 5)
    shape = ("q,k,v [4, 2048, 32, 128] bf16, non-causal, float32 "
             "packed-document mask [4, 1, 2048, 2048]")
    records = {}
    # each kernel with the mask, then without it at the same shape (the
    # mask's own cost; the unmasked lse is as good as any for timing)
    for name, fn, nbytes, flops, plain_ms, lib_ms in (
            ("flash_attention",
             lambda m: flash_attention(q, k, v, False, m),
             4 * io + b * h * s * 4 + mask_bytes, 2 * gemm,
             time_ms(lambda: flash_attention_plain(q, k, v, False, mask), 5),
             fwd_lib),
            ("flash_attention_bwd_dq",
             lambda m: flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                              False, m),
             5 * io + rows + mask_bytes, 3 * gemm, bwd_plain, bwd_lib),
            ("flash_attention_bwd_dkv",
             lambda m: flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                               False, m),
             6 * io + rows + mask_bytes, 4 * gemm, bwd_plain, bwd_lib)):
        b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
        records[name] = {"shape": shape, "max_abs_err": errs[name],
                         "tol": tols[name], "ms": time_ms(lambda: fn(mask)),
                         "unmasked_noncausal_ms": time_ms(lambda: fn(None)),
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms}
        emit({"phase": "kernels", "timing_masked": dict(name=name,
                                                        **records[name])})
    emit({"phase": "kernels", "timing_whole_bwd_masked": {
        "shape": shape, "what": "flash_attention_bwd: delta, dQ, dK/dV",
        "ms": time_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse,
                                                  False, mask)),
        "library_ms": bwd_lib,
        "library_note": "backward of F.scaled_dot_product_attention, bf16 "
                        "mask"}})
    del q, k, v, dout, out, lse, delta, mask
    torch.cuda.empty_cache()
    return records


def block_sparse_case(gen, dtype, s, d, bm, b=2, h=3):
    """The block-sparse kernel against its plain version on q, k, v
    [b, s, h, d] and on transposed [b, h, s, d] tensors read in place."""
    from paddle_tpu_torch.ops.hopper import (block_sparse_attention_fwd,
                                             block_sparse_attention_plain)
    errs, tols, rows_zero = [], [], True
    for layout in ("bshd", "bhsd"):
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        if layout == "bhsd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out = block_sparse_attention_fwd(q, k, v, bm)
        ref = block_sparse_attention_plain(q, k, v, bm)
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        tols.append(tolerance(ref, dtype))
        empty = torch.from_numpy(np.repeat(~bm.any(axis=1), 128)).cuda()
        rows_zero = rows_zero and bool((out[:, empty] == 0).all())
    rec = {"kernel": "block_sparse_attention", "dtype": str(dtype)[6:],
           "s": s, "d": d, "active_tiles": int(bm.sum()),
           "empty_rows": int((~bm.any(axis=1)).sum()),
           "full_rows": int(bm.all(axis=1).sum()), "max_abs_err": errs,
           "tol": tols, "empty_rows_exactly_zero": rows_zero}
    emit(rec)
    if not rows_zero or any(e > t for e, t in zip(errs, tols)):
        fail(f"block_sparse_attention disagrees with its plain version: "
             f"{rec}")
    return max(errs)


def block_sparse_kernels(gen, seed):
    """The block-sparse kernel: every case, then its timing record at
    q, k, v [4, 4096, 12, 64] bf16 under the BigBird pattern."""
    from paddle_tpu_torch.ops.hopper import (block_sparse_attention_fwd,
                                             block_sparse_attention_plain)
    F = torch.nn.functional
    rng = np.random.RandomState(seed + 5)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (128, 64, 32):
            for s in (4096, 512, 256):
                nb = s // 128
                bm = rng.rand(nb, nb) < 0.4
                bm[0] = False                      # an empty tile row
                bm[-1] = True                      # a row with every tile
                block_sparse_case(gen, dtype, s, d, bm, b=1 if s == 4096
                                  else 2)
            block_sparse_case(gen, dtype, 4096, d, bigbird_tiles(32, seed),
                              b=1)

    b, s, h, d = 4, 4096, 12, 64
    bm = bigbird_tiles(s // 128, seed)
    q, k, v = (torch.randn(b, s, h, d, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = block_sparse_attention_fwd(q, k, v, bm)
    ref = block_sparse_attention_plain(q, k, v, bm)
    torch.cuda.synchronize()
    err, tol = max_err(out, ref), tolerance(ref, torch.bfloat16)
    if err > tol:
        fail(f"block_sparse_attention at the timing shape: {err} > {tol}")
    del out, ref
    io = q.numel() * q.element_size()
    active = int(bm.sum())
    b_ms, b_by = bound(4 * io + bm.size * 4,
                       4 * 128 * 128 * d * active * b * h, H100_BF16_FLOPS)
    elem = torch.from_numpy(np.repeat(np.repeat(bm, 128, 0), 128, 1)).cuda()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec = {"name": "block_sparse_attention", "route": "cuda",
           "source": "paddle_tpu_torch/ops/hopper/csrc/"
                     "block_sparse_attention.cu",
           "replaces": "paddle_tpu/ops/pallas/block_sparse_attention.py:31",
           "shape": f"q,k,v [4, 4096, 12, 64] bf16, BigBird pattern, "
                    f"{active} of {bm.size} tiles",
           "max_abs_err": err, "tol": tol,
           "ms": time_ms(lambda: block_sparse_attention_fwd(q, k, v, bm)),
           "plain_ms": time_ms(lambda: block_sparse_attention_plain(
               q, k, v, bm), 5),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=elem)),
           "library_note": "F.scaled_dot_product_attention with the expanded "
                           "bool mask [4096, 4096]"}
    emit({"phase": "kernels", "timing": rec})
    del q, k, v, qt, kt, vt, elem
    torch.cuda.empty_cache()
    return rec


# -- phase 3 -----------------------------------------------------------------

def phase_width(seed):
    """Two layers at full width: card (bf16, kernels) against CPU (float32,
    plain versions) with the same weights. Tolerance: 3% of the largest
    reference magnitude. bf16 keeps 8 bits, so each rounding errs by up to
    2^-9 relative, and about ten roundings lie on each path through two
    layers; an H100 run put the logits 1.5% and the caches at most 1.3%
    apart. A wrong kernel (mask, head mapping, rounding) errs by the signal
    itself, since with these weights attention dominates the residual
    stream."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    cfg = llama2_7b_config(dtype="bfloat16", num_hidden_layers=2)
    card = LlamaForCausalLM(cfg, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(seed))
    ids = torch.randint(0, cfg.vocab_size, (1, 128),
                        generator=torch.Generator().manual_seed(seed))
    logits, caches, _ = card.prefill(ids.cuda(), 128)
    torch.cuda.synchronize()
    ref_model = LlamaForCausalLM(llama2_7b_config(num_hidden_layers=2),
                                 device="cpu")
    ref_model.load_state_dict(card.state_dict())   # copies to CPU float32
    del card
    torch.cuda.empty_cache()
    ref_logits, ref_caches, _ = ref_model.prefill(ids, 128)
    del ref_model

    def rel(a, b):
        return max_err(a.cpu(), b) / float(b.abs().max())

    rec = {"phase": "width", "layers": 2, "prompt": 128, "tol_rel": 0.03,
           "logits_rel_err": rel(logits, ref_logits),
           "caches_rel_err": [[rel(caches[i, j], ref_caches[i, j])
                               for j in range(2)] for i in range(2)],
           "logits_finite": bool(torch.isfinite(logits).all()),
           "argmax_equal": int(logits.argmax()) == int(ref_logits.argmax())}
    emit(rec)
    worst = max([rec["logits_rel_err"]] + sum(rec["caches_rel_err"], []))
    if not rec["logits_finite"] or worst > rec["tol_rel"]:
        fail(f"card and CPU disagree at full width: {rec}")


# -- phase 3b ----------------------------------------------------------------

def phase_train_width(seed, masked=False):
    """Loss and every parameter's grad of two layers at full width: card
    (bf16 O2, kernels) against CPU (float32, plain versions) from the same
    float32 weights, on one 1 x 128-token batch; with `masked`, under a
    float32 packed-document mask (documents of 16-64 tokens) instead of
    the causal one. Tolerance: loss within
    1e-3 relative; each grad within 6% in norm, ||g_card - g_cpu|| /
    ||g_cpu||. A bf16 backward rounds every activation and grad to 8 bits
    (2^-9 relative each) on its way through two layers; a CPU run at half
    this width put the bf16 grads at most 2.3% (q/k projections) and the
    loss 8e-5 from float32. A missing grad (an op without a backward on the
    card) or a wrong kernel errs by the whole grad."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    cfg = llama2_7b_config(num_hidden_layers=2)
    card = LlamaForCausalLM(cfg, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(seed))
    ref = LlamaForCausalLM(cfg, device="cpu")
    ref.load_state_dict(card.state_dict())      # float32 copies
    amp.decorate(card, level="O2", dtype="bfloat16")
    gen = torch.Generator().manual_seed(seed + 2)
    ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    mask, docs = (packed_doc_mask(1, 128, 16, 64, seed + 6) if masked
                  else (None, None))
    _, loss = card(ids.cuda(), labels=labels.cuda(), attn_mask=mask)
    loss.backward()
    torch.cuda.synchronize()
    _, ref_loss = ref(ids, labels=labels,
                      attn_mask=None if mask is None else mask.cpu())
    ref_loss.backward()
    rel, bad = {}, []
    for (name, p), (_, r) in zip(card.named_parameters(),
                                 ref.named_parameters()):
        if p.grad is None or not bool(p.grad.abs().sum() > 0):
            bad.append(name)
            continue
        rel[name] = float((p.grad.float().cpu() - r.grad).norm()
                          / r.grad.norm())
    rec = {"phase": "train_width_masked" if masked else "train_width",
           "layers": 2, "tokens": 128, "documents": docs,
           "loss": float(loss), "ref_loss": float(ref_loss),
           "loss_rel_err": abs(float(loss) - float(ref_loss))
           / abs(float(ref_loss)), "loss_tol_rel": 1e-3,
           "grad_tol_rel": 0.06, "params": len(rel) + len(bad),
           "missing_or_zero_grads": bad,
           "worst_grad_rel_err": sorted(rel.items(), key=lambda t: -t[1])[:5]}
    emit(rec)
    if bad or rec["loss_rel_err"] > 1e-3 or max(rel.values()) > 0.06:
        fail(f"train width: card and CPU disagree: {rec}")


# -- phase 4 -----------------------------------------------------------------

def phase_serve(seed):
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    from paddle_tpu_torch.ops.hopper import (KERNELS, launch_counts,
                                             reset_launch_counts)
    batch, prompt, new = 4, 512, 32
    cfg = llama2_7b_config(dtype="bfloat16")
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt),
                        generator=torch.Generator().manual_seed(seed + 1)
                        ).cuda()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(ids, new)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    expect = dict.fromkeys(KERNELS, 0)
    expect.update({"flash_attention": layers,
                   "rms_norm": (2 * layers + 1) * new})
    if launches != expect:
        fail(f"launch counts {launches}, expected {expect}")
    if tuple(out.shape) != (batch, prompt + new) or out.dtype != torch.int64:
        fail(f"generate returned {tuple(out.shape)} {out.dtype}")
    if not torch.equal(out[:, :prompt], ids):
        fail("generate did not keep the prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail("generated ids outside the vocabulary")

    # timings outside the counted run: prefill alone, then the decode steps
    with torch.no_grad():
        s_max = prompt + new
        prefill_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches, t = model.prefill(ids, s_max)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(new - 1):
            logits, caches, t = model.decode_step(tok, caches, t)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        profile = profile_steps(model, ids, s_max)
    step_ms = {"prefill": sorted(prefill_ms)[1],
               "decode_step": decode_s * 1e3 / (new - 1)}
    # share of the step's wall time with no kernel running: device time
    # from the profiled step over the unprofiled step's wall time
    idle = {k: 1 - profile[k]["device_ms"] / step_ms[k]
            for k in step_ms if profile[k]["device_ms"] != "not measured"}
    emit({"phase": "serve", "layers": layers, "batch": batch,
          "prompt": prompt, "new_tokens": new, "init_s": init_s,
          "generate_s": generate_s, "launches": launches,
          "prefill_ms": step_ms["prefill"],
          "decode_ms_per_step": step_ms["decode_step"],
          "decode_tokens_per_s": batch * (new - 1) / decode_s,
          "device_idle_share": idle,
          "peak_memory_gib": peak_gib, "profile": profile})
    return launches


def profile_one(fn):
    """Device time by kernel over one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows) or "not measured",
            "top": [[k[:60], round(ms, 4), n] for k, ms, n in rows[:10]],
            "flash_bwd_kernels": sorted({m for k, _, _ in rows
                                         for m in re.findall(
                                             r"flash_bwd_\w+", k)})}


# -- phase 5 -----------------------------------------------------------------

def phase_train(seed, packed=False):
    """bench.py's training path at Llama-2-7B width, 8 of 32 layers (AdamW
    O2 keeps 16 bytes a parameter: 32 layers would need ~108 GB): 5 steps;
    with `packed`, 3 steps on packed documents under a float32
    [4, 1, 2048, 2048] block-diagonal causal mask, documents of 256-1024
    tokens drawn from the seed."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    from paddle_tpu_torch.ops.hopper import launch_counts, \
        reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    layers, batch, seq, steps = 8, 4, 2048, 3 if packed else 5
    cfg = llama2_7b_config(num_hidden_layers=layers, use_recompute=True)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(seed))
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    n_params = sum(p.numel() for p in model.parameters())

    def loss_fn(ids, labels, mask):
        _, loss = model(ids, labels=labels, attn_mask=mask)
        return loss

    step = TrainStep(loss_fn, opt)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    mask, docs = (packed_doc_mask(batch, seq, 256, 1024, seed + 7) if packed
                  else (None, None))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = [], [], None
    for i in range(steps):
        if i == 1:
            reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(ids, labels, mask))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    profile = profile_one(lambda: step(ids, labels, mask))

    expect = {"flash_attention": 2 * layers,
              "flash_attention_bwd_dq": layers,
              "flash_attention_bwd_dkv": layers,
              "rms_norm": 4 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
              "adamw": 9 * layers + 3, "block_sparse_attention": 0}
    median_ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens_per_s = batch * seq / (median_ms / 1e3)
    # bench.py's model FLOPs: 6 P per token plus the attention terms
    flops_per_token = 6 * n_params + 12 * layers * cfg.hidden_size * seq
    idle = ("not measured" if profile["device_ms"] == "not measured"
            else 1 - profile["device_ms"] / median_ms)
    emit({"phase": "train_packed" if packed else "train", "layers": layers,
          "batch": batch, "seq": seq, "documents": docs,
          "params": n_params, "init_s": init_s, "step_ms": step_ms,
          "median_step_ms": median_ms, "tokens_per_s": tokens_per_s,
          "mfu": tokens_per_s * flops_per_token / H100_BF16_FLOPS,
          "peak_memory_gib": peak_gib, "device_idle_share": idle,
          "losses": losses, "launches_per_step": launches,
          "profile_step": profile})
    if launches != expect:
        fail(f"train launch counts {launches}, expected {expect}")
    # bf16 gradients go through the tensor-core builds, never the float32
    # FMA kernels (flash_bwd_dq_kernel, flash_bwd_dkv_kernel)
    if profile["flash_bwd_kernels"] != ["flash_bwd_dkv_wgmma",
                                        "flash_bwd_dq_wgmma"]:
        fail(f"train backward kernels {profile['flash_bwd_kernels']}, "
             "expected the wgmma builds only")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    return launches


# -- phase 6 -----------------------------------------------------------------

def csr_from_tiles(bm, heads, block=128):
    """The int32 CSR (offsets [1, heads, s + 1], columns [1, heads, nnz]) of
    a tile pattern, one pattern for every head, columns ascending."""
    row_cols = [np.concatenate([np.arange(c * block, (c + 1) * block)
                                for c in np.flatnonzero(r)]) for r in bm]
    cols = np.concatenate([np.tile(rc, block) for rc in row_cols])
    counts = np.repeat([len(rc) for rc in row_cols], block)
    offs = np.concatenate([[0], np.cumsum(counts)])
    return tuple(np.ascontiguousarray(np.broadcast_to(
        a.astype(np.int32), (1, heads, a.size))) for a in (offs, cols))


def csr_window(s, heads, width):
    """The int32 CSR of an element-level window: row r attends to columns
    [r - width / 2, r + width / 2), cut at 0 and s."""
    r = np.arange(s)
    lo, hi = np.maximum(r - width // 2, 0), np.minimum(r + width // 2, s)
    counts = hi - lo
    first = np.cumsum(counts) - counts
    cols = np.repeat(lo - first, counts) + np.arange(counts.sum())
    offs = np.concatenate([[0], np.cumsum(counts)])
    return tuple(np.ascontiguousarray(np.broadcast_to(
        a.astype(np.int32), (1, heads, a.size))) for a in (offs, cols))


def phase_sparse(seed):
    """F.sparse_attention at BERT-base width (bert_base_config: 12 heads x
    64) and BigBird-base length (4096 tokens) in bf16, from an int32 CSR of
    the BigBird tile pattern, one pattern for every head. Tolerances: the
    output as the kernel cases (one bf16 ulp at the largest magnitude of
    the float32 plain version); the q/k/v grads of one backward (the dense
    masked recompute) as the backward kernels' against autograd through the
    plain version."""
    from paddle_tpu_torch.nn import functional_extras as FE
    from paddle_tpu_torch.ops.hopper import (block_sparse_attention_fwd,
                                             block_sparse_attention_plain,
                                             launch_counts,
                                             reset_launch_counts)
    b, h, s, d = 1, 12, 4096, 64
    bm = bigbird_tiles(s // 128, seed)
    t0 = time.perf_counter()
    offs, cols = csr_from_tiles(bm, h)
    csr_build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    q, k, v, g = (torch.randn(b, h, s, d, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = FE.sparse_attention(*leaves, offs, cols)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    launches = launch_counts()
    out.backward(g)
    torch.cuda.synchronize()
    expect = {name: 0 for name in launches}
    expect["block_sparse_attention"] = 1
    if launches != expect:
        fail(f"sparse launch counts {launches}, expected {expect}")

    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = block_sparse_attention_plain(
        *(t.transpose(1, 2) for t in ref_leaves), bm).transpose(1, 2)
    ref.backward(g.float())
    rec = {"phase": "sparse", "shape": [b, h, s, d], "dtype": "bfloat16",
           "active_tiles": int(bm.sum()), "tiles": int(bm.size),
           "csr_bytes": offs.nbytes + cols.nbytes, "csr_build_s": csr_build_s,
           "launches": launches, "first_call_s": first_call_s,
           "out_finite": bool(torch.isfinite(out).all()),
           "max_abs_err": max_err(out, ref),
           "tol": tolerance(ref, torch.bfloat16)}
    ok = rec["out_finite"] and rec["max_abs_err"] <= rec["tol"]
    for name, a, r in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        rec[f"{name}_max_abs_err"] = max_err(a.grad, r.grad)
        rec[f"{name}_tol"] = bwd_tolerance(r.grad, torch.bfloat16)
        ok = ok and rec[f"{name}_max_abs_err"] <= rec[f"{name}_tol"]
    del ref, ref_leaves, leaves, out

    # one call split: host (the CSR probe on the warm cache, its sha1
    # digests) and device (the kernel); medians of 5
    walls, hosts, digests = [], [], []
    reset_launch_counts()
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            FE.sparse_attention(q, k, v, offs, cols)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            FE._csr_masks(offs, cols, s, FE.BLOCK, dense=False)
            hosts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            hashlib.sha1(offs.tobytes()).hexdigest()
            hashlib.sha1(cols.tobytes()).hexdigest()
            digests.append(time.perf_counter() - t0)
    if launch_counts()["block_sparse_attention"] != 5:
        fail(f"sparse: {launch_counts()} launches over 5 calls")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec.update({
        "call_ms": sorted(walls)[2] * 1e3,
        "host_probe_ms": sorted(hosts)[2] * 1e3,
        "host_sha1_ms": sorted(digests)[2] * 1e3,
        "device_ms": time_ms(lambda: block_sparse_attention_fwd(qt, kt, vt,
                                                                bm))})

    # an element-level window of 200 is not tile-aligned: the dense route,
    # no launch; checked against float32 dense attention under the same
    # mask (bf16 scores and probabilities: 5% of the largest magnitude)
    w_offs, w_cols = csr_window(s, h, 200)
    reset_launch_counts()
    with torch.no_grad():
        dense = FE.sparse_attention(q, k, v, w_offs, w_cols)
    torch.cuda.synchronize()
    dense_launches = launch_counts()["block_sparse_attention"]
    r = torch.arange(s, device="cuda")
    window = (r[None, :] >= r[:, None] - 100) & (r[None, :] < r[:, None] + 100)
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    dense_ref = torch.softmax(scores.masked_fill(~window, -1e9), -1) @ \
        v.float()
    rec.update({"dense_route_launches": dense_launches,
                "dense_route_rel_err": max_err(dense, dense_ref)
                / float(dense_ref.abs().max())})
    ok = ok and dense_launches == 0 and rec["dense_route_rel_err"] <= 0.05
    emit(rec)
    if not ok:
        fail(f"sparse attention: {rec}")
    del q, k, v, g, qt, kt, vt, dense, dense_ref, scores
    torch.cuda.empty_cache()
    return launches


def profile_steps(model, ids, s_max):
    """Device time by kernel over one prefill and one decode step."""
    logits, caches, t = model.prefill(ids, s_max)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    return {"prefill": profile_one(lambda: model.prefill(ids, s_max)),
            "decode_step": profile_one(
                lambda: model.decode_step(tok, caches, t))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device()
    kernels = phase_kernels(args.seed)
    phase_width(args.seed)
    phase_train_width(args.seed)
    phase_train_width(args.seed, masked=True)
    serve = phase_serve(args.seed)
    train = phase_train(args.seed)
    packed = phase_train(args.seed, packed=True)
    sparse = phase_sparse(args.seed)
    for k in kernels:
        # the forward kernels per generate (and per train step, beside);
        # the backward and AdamW kernels per train step; block-sparse per
        # sparse_attention call
        name = k["name"]
        if sparse[name]:
            k["launches"] = sparse[name]
        elif serve[name]:
            k["launches"] = serve[name]
            k["launches_per_train_step"] = train[name]
        else:
            k["launches"] = train[name]
        if packed[name]:
            k["launches_per_packed_train_step"] = packed[name]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one Hopper card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing JSON lines (any failure exits non-zero):

1. device: the card (nvidia-smi name and power limit), versions, and the
   build of every kernel under paddle_tpu_torch/ops/hopper/csrc with nvcc
   (one process per source, all started together).
2. kernels: each kernel against its plain PyTorch version on the card,
   case by case with the tolerance stated (and, for the backward and AdamW
   kernels, two launches bit for bit), then timed at the serving and
   training paths' shapes beside its plain version, one PyTorch library
   call, and the card's bound for the same work.
3. width: Llama-2-7B width (bf16, 2 layers, random weights from --seed),
   one 128-token prompt, prefill on the card (kernels) against the same
   weights in float32 on the CPU (plain versions).
3b. train_width: the same width, loss and every parameter's grad of one
   1 x 128-token batch, on the card (bf16 O2, kernels) against the CPU
   (float32, plain versions).
4. serve: Llama-2-7B (bf16, all 32 layers) serves 4
   requests of 512 prompt tokens and 32 greedy new tokens through
   LlamaForCausalLM.generate; the launch counts prove the path ran the
   kernels. Prefill time, decode tokens/s and peak memory are reported,
   and a short profile of one prefill and one decode step is printed.
5. train: Llama-2-7B width at 8 of its 32 layers trains 5 steps of
   4 x 2048 tokens (AdamW, amp.decorate O2 bf16, recompute, TrainStep);
   the launch counts of one step prove the path ran every kernel. Step
   time, tokens/s, MFU, peak memory, the device's idle share, the top
   kernels of one profiled step and every loss are reported.

The last two lines are the {"kernels": [...]} summary and the result
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

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
          "kernel_build_s": build_s, "ptxas": ptxas})


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
    return records


def train_kernels(gen):
    """The backward and AdamW kernels: every case, then timings at the
    train phase's shapes."""
    from paddle_tpu_torch.ops.hopper import (adamw_, adamw_plain,
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

def phase_train_width(seed):
    """Loss and every parameter's grad of two layers at full width: card
    (bf16 O2, kernels) against CPU (float32, plain versions) from the same
    float32 weights, on one 1 x 128-token batch. Tolerance: loss within
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
    _, loss = card(ids.cuda(), labels=labels.cuda())
    loss.backward()
    torch.cuda.synchronize()
    _, ref_loss = ref(ids, labels=labels)
    ref_loss.backward()
    rel, bad = {}, []
    for (name, p), (_, r) in zip(card.named_parameters(),
                                 ref.named_parameters()):
        if p.grad is None or not bool(p.grad.abs().sum() > 0):
            bad.append(name)
            continue
        rel[name] = float((p.grad.float().cpu() - r.grad).norm()
                          / r.grad.norm())
    rec = {"phase": "train_width", "layers": 2, "tokens": 128,
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
            "top": [[k[:60], round(ms, 4), n] for k, ms, n in rows[:10]]}


# -- phase 5 -----------------------------------------------------------------

def phase_train(seed):
    """bench.py's training path at Llama-2-7B width, 8 of 32 layers (AdamW
    O2 keeps 16 bytes a parameter: 32 layers would need ~108 GB)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    from paddle_tpu_torch.ops.hopper import launch_counts, \
        reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    layers, batch, seq, steps = 8, 4, 2048, 5
    cfg = llama2_7b_config(num_hidden_layers=layers, use_recompute=True)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(seed))
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    n_params = sum(p.numel() for p in model.parameters())

    def loss_fn(ids, labels):
        _, loss = model(ids, labels=labels)
        return loss

    step = TrainStep(loss_fn, opt)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = [], [], None
    for i in range(steps):
        if i == 1:
            reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(ids, labels))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    profile = profile_one(lambda: step(ids, labels))

    expect = {"flash_attention": 2 * layers,
              "flash_attention_bwd_dq": layers,
              "flash_attention_bwd_dkv": layers,
              "rms_norm": 4 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
              "adamw": 9 * layers + 3}
    median_ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens_per_s = batch * seq / (median_ms / 1e3)
    # bench.py's model FLOPs: 6 P per token plus the attention terms
    flops_per_token = 6 * n_params + 12 * layers * cfg.hidden_size * seq
    idle = ("not measured" if profile["device_ms"] == "not measured"
            else 1 - profile["device_ms"] / median_ms)
    emit({"phase": "train", "layers": layers, "batch": batch, "seq": seq,
          "params": n_params, "init_s": init_s, "step_ms": step_ms,
          "median_step_ms": median_ms, "tokens_per_s": tokens_per_s,
          "mfu": tokens_per_s * flops_per_token / H100_BF16_FLOPS,
          "peak_memory_gib": peak_gib, "device_idle_share": idle,
          "losses": losses, "launches_per_step": launches,
          "profile_step": profile})
    if launches != expect:
        fail(f"train launch counts {launches}, expected {expect}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"train losses not finite and falling: {losses}")
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
    serve = phase_serve(args.seed)
    train = phase_train(args.seed)
    for k in kernels:
        # the forward kernels per generate (and per train step, beside);
        # the backward and AdamW kernels per train step
        if serve[k["name"]]:
            k["launches"] = serve[k["name"]]
            k["launches_per_train_step"] = train[k["name"]]
        else:
            k["launches"] = train[k["name"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one Hopper card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line (any failure exits non-zero):

1. device: the card (nvidia-smi name and power limit), versions, and the
   build of every kernel under paddle_tpu_torch/ops/hopper/csrc with nvcc.
2. kernels: each kernel against its plain PyTorch version on the card,
   case by case with the tolerance stated, then timed at the serving
   path's shapes beside its plain version, one PyTorch library call, and
   the card's bound for the same work.
3. width: Llama-2-7B width (bf16, 2 layers, random weights from --seed),
   one 128-token prompt, prefill on the card (kernels) against the same
   weights in float32 on the CPU (plain versions).
4. serve: Llama-2-7B (bf16, all 32 layers) serves 4
   requests of 512 prompt tokens and 32 greedy new tokens through
   LlamaForCausalLM.generate; the launch counts prove the path ran the
   kernels. Prefill time, decode tokens/s and peak memory are reported,
   and a short profile of one prefill and one decode step is printed.

The last two lines are the {"kernels": [...]} summary and the result
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
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
    write before each call, as the serving path finds it cold."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


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


def phase_kernels(seed):
    """Every case, then timings at the serving path's shapes. Returns the
    per-kernel records of the summary line (launches are filled in by the
    serve phase)."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_plain, rms_norm,
                                             rms_norm_plain)
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16

    for dtype in (bf16, torch.float32):
        for causal in (True, False):
            for hq, hkv in ((32, 32), (32, 8)):
                for s in (512, 300):
                    for d in (128, 64):
                        flash_case(gen, dtype, causal, hq, hkv, s, d)
    for dtype, shape in ((bf16, (4 * 512, 4096)), (bf16, (4, 1, 4096)),
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
    return [flash, rms]


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


# -- phase 4 -----------------------------------------------------------------

def phase_serve(seed):
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    from paddle_tpu_torch.ops.hopper import KERNELS, reset_launch_counts
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
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    expect = {"flash_attention": layers,
              "rms_norm": (2 * layers + 1) * new}
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


def profile_steps(model, ids, s_max):
    """Device time by kernel over one prefill and one decode step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for name in ("prefill", "decode_step"):
        logits, caches, t = model.prefill(ids, s_max)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            if name == "prefill":
                model.prefill(ids, s_max)
            else:
                model.decode_step(tok, caches, t)
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        out[name] = {"device_ms": sum(r[1] for r in rows) or
                     "not measured",
                     "top": [[k[:60], round(ms, 4), n]
                             for k, ms, n in rows[:8]]}
    return out


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
    launches = phase_serve(args.seed)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

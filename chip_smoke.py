#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one Hopper card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing JSON lines (any failure exits non-zero):

1. device: the card (nvidia-smi name and power limit), versions, and the
   build of every kernel under paddle_tpu_torch/ops/hopper/csrc with nvcc
   (one process per source, all started together), with ptxas's report
   (registers, spills, serialised wgmma) and the shared memory of each
   bf16 tensor-core build; a forward or block-sparse build that spills or
   serialises its products fails (the forward's builds that read a mask
   from global memory excepted), and so does any RMSNorm build that
   spills.
2. kernels: each kernel against its plain PyTorch version on the card,
   case by case with the tolerance stated (and, for the backward and AdamW
   kernels and one forward and one block-sparse case, two launches bit for
   bit), the flash kernels also under additive masks and the block-sparse
   kernel over random, BigBird, empty and full tile rows and tiles of 64
   to 192 rows, then timed at the serving and training paths' shapes (the
   forward at both, and the masked flash kernels at the packed-document
   training shape) beside its plain version, one PyTorch library call, and
   the card's bound for the same work; the whole flash backward (delta,
   dQ, dK/dV) is timed beside SDPA's backward, causal and masked. The
   RMSNorm kernels run every build their plans choose (vector builds at
   Llama widths 4096, 5120, 8192 and past them, bf16 and float32; the
   general builds at h 1001, 51,200 and two bytes into a buffer; one row;
   the decode shape), each build checked against the plan, two launches
   bit for bit; the forward is timed at [2048, 4096], [8192, 4096] and
   [4, 1, 4096], the backward at [8192, 4096] (its row pass and column sum
   apart from the train phase's profile, whose norms have that shape). The
   batcher's shapes: the forward at one prompt a call at every bucket of
   its traffic (64-1024), timed at [1, 512, 32, 128], and the RMSNorm
   forward timed at its decode rows [8, 1, 4096] and at the paged
   batcher's fused step's [72, 4096] (8 decode rows and a 64-token
   chunk). GPT-2 serving's shapes: the forward at [8, 256, 12, 64]
   (generate's prefill) and [1, 256 | 512, 12, 64] (the dense batcher's
   admissions), bf16 causal, checked and timed. The
   flash kernels' dropout builds: cases against the plain versions with
   the same seed (bf16 and float32, causal or not, 12:12 and 32:8 heads,
   s 512, 300 and 2048, d 64 and 128, with and without a float32 mask), a
   second launch bit for bit, the keep mask's share at GPT-2's shape and
   the kernels' own masks read back row by row, and timings at GPT-2's
   shape beside the same kernels without dropout and SDPA with dropout.
3. width: Llama-2-7B width (bf16, 2 layers, random weights from --seed),
   one 128-token prompt, prefill on the card (kernels) against the same
   weights in float32 on the CPU (plain versions).
3b. train_width: the same width, loss and every parameter's grad of one
   1 x 128-token batch, on the card (bf16 O2, kernels) against the CPU
   (float32, plain versions).
3c. train_width_masked: the same check with a packed-document mask (the
   masked flash kernels).
3d. routing: attention calls the flash kernels do not take (Llama's tiny
   config at head dim 16, float16) complete on the dense route with its
   warning, and strided q/k/v take the kernels as copies.
3e. gpt2_width: GPT-2 124M (12 layers), loss and every grad of one 4 x 512
   batch with attention dropout 0.1, card (bf16 O2, the dropout builds)
   against the CPU (float32, plain versions, the same hash mask).
4. serve: Llama-2-7B (bf16, all 32 layers) serves 4
   requests of 512 prompt tokens and 32 greedy new tokens through
   LlamaForCausalLM.generate; the launch counts prove the path ran the
   kernels, and the profile of one prefill that its attention ran the
   bf16 tensor-core forward only and of prefill and decode that the norms
   ran the RMSNorm vector build. Prefill time, decode tokens/s and peak
   memory are reported, and a short profile of one prefill and one decode
   step is printed.
4b. batcher: Llama-2-7B (bf16, all 32 layers) serves 24 requests (prompts
   of 64-768 tokens, 16-64 new tokens, drawn from --seed; 12 up front and
   12 after the 5th step) through paddle_tpu_torch.inference.
   ContinuousBatcher (8 slots, s_max 1024, the pow2 prompt ladder, greedy),
   once eagerly and once with the decode step replayed as a CUDA graph.
   Both must give the same tokens, every request its full length, the
   tokens agree with the model's full forward and the bucketed prefills
   with exact-length ones (6%: the 32-layer bf16 spread is ~4%); the
   launch counts prove the admissions ran the flash forward and the norms
   the RMSNorm kernel, and the profiles of 8 admissions and 8 steps (graph
   replays, in the graphed run) that they ran the tensor-core forward and
   the RMSNorm vector build only. Per mode: admissions, steps, tokens,
   wall time, decode ms a step, tokens/s, TTFT, the idle share of a step
   and peak memory.
4c. paged: the same model serves through paddle_tpu_torch.inference.
   PagedContinuousBatcher. Run A: benchmarks/bench_decode.py's
   configuration (block 64, 64-token prefill chunks, pages on demand; 8
   slots, s_max 1024) over the batcher phase's traffic, eagerly and with
   the decode step and the 64-token chunk replayed as CUDA graphs. Run B:
   bench_gateway.py's
   (pages on demand, the prefix cache, the pow2 ladder) at block 16 and
   228 pages over 24 requests sharing 4 system prompts of 512 tokens,
   graphed, and the same traffic eagerly with no prefix cache in the
   default pool ("B plain"). Then generate_paged at the serve phase's
   shape. Checks: every request completes at its full length; Run A's
   graphed tokens equal its eager ones with one capture of the decode
   step and one of the chunk, whose replays are as many as the eager
   run's chunks; Run B preempts and hits the prefix cache; no page leaks;
   the RMSNorm launch counts (65 a prefill call or chunk and a decode
   step; graphed, 65 for the warm-up and the capture, the replays counted
   by to_static), the
   profiles of 4 admissions and 8 steps (the RMSNorm vector build, no
   flash kernel) and the RMSNorm forward against its plain version at
   every prefill shape the runs gave it; where the paged tokens differ
   from the dense batcher's or generate's, or Run B's from B plain's, the
   two picks lie within the run's bf16 spread against a float32 copy, and
   Run B's tokens lie within it of their full forward's top for 4
   requests that missed the cache and 4 that hit it. Per run: admissions,
   prefill calls, steps, tokens, wall, tokens/s, decode ms a step, TTFT,
   idle share, peak memory, preemptions, prefix hit and miss tokens, and
   a step's device ms by part (gather and cast, attention, weight
   products, norms).
4d. fused: benchmarks/bench_decode.py:207-211's configuration, Run A's
   with fused admission (one 64-token chunk a step inside the decode
   step's call, Llama's paged_fused_step), over Run A's traffic, graphed:
   per step, then with decode_block=8 (K decode steps a call, the argmax
   on the card), then in a pool of 15 pages, which aborts an admission.
   Checks: every request completes at its full length; one capture of
   the fused step (and of the block) a run, every step a replay; blocks
   run and give the per-step run's tokens exactly; the abort; no page
   leaks; 65 RMSNorm launches a fused step, decode step and block
   sub-step and nothing else; the profile of 4 fused steps (7 decoders
   and a chunk) shows the RMSNorm vector build only; the RMSNorm forward
   against its plain version at [72, 4096]; where the fused tokens leave
   Run A graphed's, or the small pool's the fused run's, both picks lie
   within the paged phase's bf16 spread. Per run: steps, fused steps,
   blocks, tokens/s, step ms, TTFT, aborts, peak memory; the fused step's
   wall and device ms, idle share, and device ms by part.
4e. gpt2_serve: benchmarks/bench_decode.py's serving cell, GPT-2
   124M-class (vocab 32000, 12 x 768, 12 heads of 64; bf16, random
   weights from --seed, eval mode): generate (8 x 256 prompt tokens, s_max
   512, 32 new) and its decode step captured as a CUDA graph (4 warm and
   32 timed steps, kv_cache_compiled_tokens_per_s); then bench_decode's
   drive (a warm-up request, then 6 requests of 239-285 prompt tokens and
   32 new, all up front; 3 measured windows) through the dense
   ContinuousBatcher eager and graphed and the PagedContinuousBatcher
   (block 64, 64-token chunks, on demand) graphed, with fused admission,
   and with fused admission and decode_block=8, 8 slots and s_max 512
   each. Checks: 6 requests completed a window; one capture of each
   captured function a run; graphed dense tokens equal eager ones, block
   tokens the fused run's, and paged and fused picks that leave the dense
   run's lie within twice the run's bf16 spread against a float32 copy;
   no page leaks; the flash forward launched 12 times an admission and by
   generate, its profile the bf16 wgmma build at d 64 without dropout; no
   dense-route warning. Per run: tokens/s, slot utilization, steps, fused
   steps, blocks, TTFT, peak memory, captures and replays; a graphed paged
   step's and a fused step's device ms by part; all profiles after the
   timings, then the block run again.
4f. gateway: benchmarks/bench_gateway.py's TPU configuration, the same
   GPT-2 behind paddle_tpu_torch.inference.Gateway over 2 graphed dense
   ContinuousBatcher replicas (4 slots, s_max 512, each warmed alone so
   its decode graph is captured before the windows): a warm-up request,
   then 3 windows of 12 requests (240-271 prompt tokens, 32 new; every
   third tenant "batch" at low priority, sessions s0-s3) under each of
   least_loaded, affinity and weighted_rr; a lone graphed batcher on the
   same prompts; a failover run in which chaos gateway.step.r1 kills r1 at
   its 9th step with work in flight; then the shared-prefix workload (4
   system prompts of 128 tokens, 24 requests, tails of 16-48 tokens, 12
   new) over 2 graphed paged replicas under affinity, prefix cache on and
   off, and its no-shared-prefix control. Checks: every window completes
   its 12 requests with no failure, 12 flash forwards an admission and
   no other launch, no capture and a replay a replica step; each policy's
   and the failover run's tokens equal the lone batcher's or part within
   twice the run's bf16 spread against a float32 copy; in the failover
   run r1 is dead, requests were requeued and every request finished on
   r0; the shared-prefix runs hit the cache when on, launch no kernel and
   leak no page; the profiles of one window a policy show the bf16 wgmma
   forward at d 64 without dropout only. Per policy: routed tokens/s,
   TTFT and TPOT p50/p99 from the gateway's request records, completions,
   requeues, each replica's completions, the host ms of a tick outside
   the replicas' steps, a tick's device idle share and the flash
   forward's launches; the shared-prefix hit rate, TTFT p99 and tokens/s,
   cache on and off (the goodput ledger's figures printed as absent).
4g. quant: int8 serving. The GPT-2 of gpt2_serve: generate and the
   captured decode step in bf16 and with nn.quant.quantize_linear_layers'
   weight-only int8 linears (bench_decode's kv_cache_int8 arm); the paged
   batcher (block 64, 64-token chunks, graphed) on gpt2_serve's traffic in
   bf16 and with quantization.serving_quantize's int8 weights
   (bench_quant's weights arm: layers quantized and falling back, bytes
   saved, tokens/s, TPOT p50, token match); calibrate_cachekv_int8 on one
   [8, 256] batch, then the paged batcher with kv_quant="int8" and the
   fused one with decode_block=8; cache_quant="dynamic_int8" (tokens/s,
   cachekv_clip_rate). Then Llama-2-7B Run A with kv_quant="int8",
   graphed, after calibration on one 512-token prompt: wall, tokens/s,
   the pool's bytes, a step's gather and dequantization against bf16's
   gather and cast. Checks: int8 pools where asked; layer 0's codes of one
   prefill equal clip(round(x * q)) of its own rows, bit for bit; GPT-2's
   int8 pages' and weights' prefill logits within 5% of the largest bf16
   one, Llama's int8 pages' within 3x bf16's own distance from float32;
   each quantized batcher's tokens within twice the bf16 spread of the
   same quantized model's own route; the flash forward in GPT-2's
   calibration and generates, the RMSNorm kernel in Llama's run.
4h. tiers: the KV cache's host and disk tiers. A (after quant, on its
   uncalibrated Llama-2-7B): bench_prefix_churn.py's stream (32 prefixes
   of 48 tokens, a 22-page pool of block 16, 2 slots, s_max 96, a warm
   pass, then 96 Zipf(0.5) draws from --seed) through the graphed
   PagedContinuousBatcher, device only, with a 1 GiB host tier, and with
   tier_quant="int8" (bench_quant's tier arm). Checks: the tiered hit rate
   above the device-only one; demotions, promotions and decode steps with
   a promotion in flight; clean page and tier audits; pages promoted back
   equal their rows from before their demotion byte for byte; tier_quant's
   blobs at most 0.55 of the raw bytes, a page's codes and scales those of
   clip(rint(x / scale)) in numpy float32; 65 RMSNorm launches a prefill
   call and a decode step; the tiered tokens the device-only ones or
   within twice the paged phase's bf16 spread (tier_quant's within 3x
   that). Per run: hit rate, step p50 and p99, promotion latency p50 and
   p99, demoted and promoted bytes with their GB/s, peak device memory,
   the host tier's bytes, the idle share of a window. B (after gateway):
   bench_session.py's legs on gpt2_serve's GPT-2 (pipelined, serial, 2
   reps each after an untimed one, and the crash leg) with a host tier of
   4.37 pages over a disk tier of 273: time to resume and the promotion
   stream's ms; the pinned chain reached the disk, the resume promoted it,
   the turns equal the uninterrupted baseline's or lie within twice the
   bf16 spread. C: a session over the gateway's two graphed paged
   replicas with a manifest store: pause, churn, the holding replica
   killed by chaos, resume on the survivor from the manifest, release;
   its turns against a lone batcher's within twice the spread.
4i. spec: speculative decoding. A (after tiers, on its Llama-2-7B):
   generate_paged_speculative (a 512-token prompt, 128 new, draft_k 4,
   block 64, its steps CUDA graphs) with three drafts: LLaMA-68M's
   published shape (JackFram/llama-68m: 2 x 768, 12 heads, intermediate
   3072, vocab 32000; random weights), the target's first 2 layers with
   its embeddings, final norm and head, and the target itself; against
   generate_paged's greedy tokens; a round's device ms by part (catch-up,
   draft steps, verify). B: the batcher phase's 24 requests through the
   graphed paged batcher (8 slots, s_max 1024, block 64) without a draft,
   with the 68M draft and with the target as its own draft. C (after
   gateway): gpt2_serve's GPT-2 with a 6-layer draft at its width
   (distilgpt2's depth, vocab 32000): the standalone loop on gpt2_serve's
   6 prompts, its traffic through the graphed paged batcher with and
   without the draft, the gateway drill (two graphed paged replicas with
   the prefix cache and the draft, chaos serving.step killing one
   mid-decode, every request finished on the survivor) against a lone
   batcher, and a draft-carrying batcher with a 1 GiB host tier over
   tiers' churn whose promoted pages of both pools come back byte for
   byte. Per run: tokens/s (with and without the graphs' captures),
   spec_stats, acceptance, tokens per target dispatch, launches, a
   round's device ms by part (catch-up, draft steps, verify: CUDA events
   on the graphs) and the idle share (the batchers' from a profiled
   window of 2 requests, the standalone loop's from its rounds and the
   round's device ms). Checks:
   full lengths, no page leaks, no flash forward (the paged path's
   attention is plain, as in the JAX package), the RMSNorm wrapper's
   count against the eager and captured passes, RMSNorm at the verify's
   rows and the 68M draft's width against its plain version, tokens
   within twice the run's bf16 spread against a float32 copy.
5. train: Llama-2-7B width at 8 of its 32 layers trains 5 steps of
   4 x 2048 tokens (AdamW, amp.decorate O2 bf16, recompute, TrainStep);
   the launch counts of one step prove the path ran every kernel, and its
   profile that the forward and the backward ran the bf16 tensor-core
   builds only and the norms the RMSNorm vector builds. Step time,
   tokens/s, MFU, peak memory, the device's idle share, the top kernels
   of one profiled step and every loss are reported.
5b. train_packed: the same path trains 3 steps on packed documents under a
   float32 [4, 1, 2048, 2048] block-diagonal causal mask (document lengths
   drawn from --seed); the launch counts of one step prove the masked
   flash kernels ran. The same reports and checks as train.
5c. gpt2_train: benchmarks/bench_gpt2.py's path at GPT-2 124M (8 x 512
   tokens, dropout 0.1, AdamW with float32 masters, O2 bf16, TrainStep):
   2 warm steps and 10 timed; the launch counts of one step prove the
   flash kernels' dropout builds ran (12 each) and AdamW's 148, its
   profile that attention ran the bf16 tensor-core dropout builds only.
   The same reports as train.
6. sparse: F.sparse_attention at BERT-base width (12 heads x 64) and
   BigBird-base length (4096 tokens; 2 global, 3 window and 3 random
   128-token tiles) from an int32 CSR built from --seed: one block-sparse
   launch per call (the tensor-core build, by its profile), the output and
   the q/k/v grads against the plain version, the call's host (CSR probe)
   and device time; then a pattern that is not tile-aligned takes the
   dense route with no launch.

The last two lines are the {"kernels": [...]} summary and the result
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import hashlib
import importlib
import json
import math
import os
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
    report = wgmma_report(_build.build_logs)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version,
          "kernel_build_s": build_s, "ptxas": ptxas,
          "ptxas_wgmma": report})
    # the forward, block-sparse and dropout tensor-core builds must neither
    # spill nor serialise their products
    bad = {n: notes for n, notes in report.items()
           if held_to_no_spill(n) and any(faulty(x) for x in notes)}
    if bad:
        fail(f"wgmma builds spill or serialise: {bad}")
    rms = ptxas.get("rms_norm", [])
    if any(faulty(x) for x in rms) or (build_s and not rms):
        fail(f"RMSNorm builds spill (or went unreported): {rms}")


def faulty(note):
    """Whether a ptxas note reports a spill or serialised wgmma."""
    return "serialized" in note or any(
        int(n) for n in re.findall(r"(\d+) bytes spill", note))


def held_to_no_spill(build):
    """Whether a tensor-core build (``name<D, mask code, window, dropout>``,
    block-sparse ``name<D, warpgroups, tile rows>``) must neither spill nor
    serialise: every block-sparse and forward build and every dropout
    build, except the flash builds that read a mask from global memory
    (mask code 1 or 2, no window)."""
    if build.startswith("block_sparse"):
        return True
    if re.search(r", [12], 0, [01]>$", build):
        return False
    return build.startswith("flash_fwd") or build.endswith(", 1>")


# source -> the C entry of its wgmma builds' shared-memory query
WGMMA_SOURCES = {
    "flash_attention": "flash_attention_fwd_wgmma_smem",
    "flash_attention_bwd": "flash_attention_bwd_wgmma_smem",
    "block_sparse_attention": "block_sparse_attention_fwd_wgmma_smem",
}
WGMMA_KERNELS = ("flash_fwd_wgmma|flash_bwd_dq_wgmma|flash_bwd_dkv_wgmma|"
                 "block_sparse_fwd_wgmma")


def wgmma_report(logs):
    """Per build of the bf16 tensor-core kernels (flash_fwd_wgmma,
    flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma, template <D, mask code,
    mask as TMA windows, dropout>; block_sparse_fwd_wgmma, template <D,
    consumer warpgroups, K/V tile rows>): ptxas's registers and spill lines
    and any note that it serialised the wgmma products, and the dynamic
    shared memory the launch asks for (ptxas reports static shared memory
    only)."""
    from paddle_tpu_torch.ops.hopper import _build
    # the wrappers' signatures: the first load of a library sets them (the
    # package's names flash_attention and block_sparse_attention are the
    # functions, so the modules come by their full names)
    fa, bs = (importlib.import_module(f"paddle_tpu_torch.ops.hopper.{m}")
              for m in ("flash_attention", "block_sparse_attention"))
    signatures = {"flash_attention": fa._SIGNATURES,
                  "flash_attention_bwd": fa._BWD_SIGNATURES,
                  "block_sparse_attention": bs._SIGNATURES}
    mangled = re.compile(rf"({WGMMA_KERNELS})I((?:L[ib]\d+E)+)E")
    report = {}
    for source, query in WGMMA_SOURCES.items():
        lib = _build.load(source, signatures[source])
        smem_of = getattr(lib, query)  # int arguments, int result
        name = None
        for ln in logs.get(source, "").splitlines():
            m = mangled.search(ln)
            if m:
                args = [int(a) for a in re.findall(r"L[ib](\d+)E", m[2])]
                key = f"{m[1]}<{', '.join(map(str, args))}>"
            if m and "Compiling entry function" in ln:
                name = key
                which = [int("dkv" in m[1])] if "bwd" in m[1] else []
                report.setdefault(name, []).append(
                    f"{smem_of(*which, *args)} bytes dynamic shared memory")
            elif m and "serialized" in ln:
                code = re.search(r"\((C75\d\d)\)", ln)
                report.setdefault(key, []).append(
                    f"{code[1] if code else 'C75xx'}: wgmma serialized")
            elif "Compiling entry function" in ln:
                name = None
            elif name and ("spill" in ln or "registers" in ln):
                report[name].append(ln.split("info    :")[-1].strip())
    return report


# -- phase 2 -----------------------------------------------------------------

def flash_case(gen, dtype, causal, hq, hkv, s, d, b=2, twice=False):
    """The forward kernel against its plain version; with `twice`, a second
    launch must give the same bits."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_plain)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal) if twice else None
    torch.cuda.synchronize()
    rec = {"kernel": "flash_attention", "dtype": str(dtype)[6:],
           "causal": causal, "heads": [hq, hkv], "s": s, "d": d,
           "max_abs_err": max_err(out, ref), "tol": tolerance(ref, dtype),
           "lse_max_abs_err": max_err(lse, ref_lse),
           "lse_tol": tolerance(ref_lse, torch.float32)}
    ok = rec["max_abs_err"] <= rec["tol"] and \
        rec["lse_max_abs_err"] <= rec["lse_tol"]
    if twice:
        rec["bit_identical"] = torch.equal(out, again[0]) and \
            torch.equal(lse, again[1])
        ok = ok and rec["bit_identical"]
    emit(rec)
    if not ok:
        fail(f"flash_attention disagrees with its plain version: {rec}")
    return (q, k, v), rec


def rms_inputs(gen, dtype, shape, count, offset):
    """`count` random tensors of `shape`; with `offset`, views that start
    one element into their buffers (not 16-byte aligned)."""
    n = math.prod(shape)
    return [torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
            [int(offset):n + int(offset)].view(shape) for _ in range(count)]


def rms_build(plan):
    """A plan's build, as its test and the profiles name it."""
    return "general" if plan.vpt == 0 else f"vector, {plan.vpt} a thread"


def rms_case(gen, dtype, shape, vector=True, offset=False):
    """The forward against its plain version, and a second launch bit for
    bit; the wrapper's plan must pick the vector build (or the general
    one)."""
    from paddle_tpu_torch.ops.hopper import rms_norm, rms_norm_plain
    from paddle_tpu_torch.ops.hopper.fused_ops import (_aligned,
                                                       _sm_count,
                                                       rms_fwd_plan)
    (x,) = rms_inputs(gen, dtype, shape, 1, offset)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
         ).to(dtype)
    y, rstd = rms_norm(x, w, 1e-5)
    again = rms_norm(x, w, 1e-5)
    ref, ref_rstd = rms_norm_plain(x, w, 1e-5)
    torch.cuda.synchronize()
    plan = rms_fwd_plan(x.numel() // shape[-1], shape[-1], dtype,
                        _aligned(x, w, y), _sm_count(x.device.index))
    rec = {"kernel": "rms_norm", "dtype": str(dtype)[6:],
           "shape": list(shape), "offset_bytes": x.element_size() * offset,
           "build": rms_build(plan), "threads": plan.threads,
           "max_abs_err": max_err(y, ref),
           "tol": tolerance(ref, dtype),
           "rstd_max_abs_err": max_err(rstd, ref_rstd),
           "rstd_tol": tolerance(ref_rstd, torch.float32),
           "bit_identical": torch.equal(y, again[0]) and
           torch.equal(rstd, again[1])}
    emit(rec)
    if not (rec["max_abs_err"] <= rec["tol"]
            and rec["rstd_max_abs_err"] <= rec["rstd_tol"]
            and rec["bit_identical"] and (plan.vpt > 0) == vector):
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


def rms_bwd_case(gen, dtype, shape, vector=True, offset=False):
    """The backward against its plain version and a second launch bit for
    bit; the plan must pick the vector row pass (or the general one)."""
    from paddle_tpu_torch.ops.hopper import (rms_norm, rms_norm_bwd,
                                             rms_norm_bwd_plain)
    from paddle_tpu_torch.ops.hopper.fused_ops import (_aligned,
                                                       _sm_count,
                                                       rms_bwd_plan)
    x, g = rms_inputs(gen, dtype, shape, 2, offset)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
         ).to(dtype)
    _, rstd = rms_norm(x, w, 1e-5)
    got = rms_norm_bwd(x, w, g, rstd)
    again = rms_norm_bwd(x, w, g, rstd)
    ref = rms_norm_bwd_plain(x, w, g, rstd)
    torch.cuda.synchronize()
    plan = rms_bwd_plan(x.numel() // shape[-1], shape[-1], dtype,
                        _aligned(x, w, g), _sm_count(x.device.index))
    rec = {"kernel": "rms_norm_bwd", "dtype": str(dtype)[6:],
           "shape": list(shape), "offset_bytes": x.element_size() * offset,
           "build": rms_build(plan), "plan": plan._asdict(),
           "bit_identical": all(torch.equal(a, c)
                                for a, c in zip(got, again))}
    ok = rec["bit_identical"] and (plan.vpt > 0) == vector
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


def flash_timing(q, k, v, rec):
    """The causal bf16 forward at q's shape, timed beside its plain version
    and SDPA, with the card's bound; `rec` is the shape's checked case."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_plain)
    F = torch.nn.functional
    b, s, hq, d = q.shape
    pairs = s * (s + 1) // 2
    f_bound, f_by = bound(4 * q.numel() * q.element_size() + b * hq * s * 4,
                          4 * b * hq * d * pairs, H100_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {
        "shape": f"q,k,v {list(q.shape)} bf16 causal",
        "max_abs_err": rec["max_abs_err"], "tol": rec["tol"],
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, True)),
        "bound_ms": f_bound, "bound_by": f_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
    }


def phase_kernels(seed):
    """Every case, then timings at the serving and training paths' shapes.
    Returns the per-kernel records of the summary line (launches are filled
    in by the serve and train phases)."""
    from paddle_tpu_torch.ops.hopper import rms_norm, rms_norm_plain
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16

    for dtype in (bf16, torch.float32):
        for causal in (True, False):
            for hq, hkv in ((32, 32), (32, 8)):
                for s in (2048, 512, 300, 1000):
                    for d in (128, 64):
                        flash_case(gen, dtype, causal, hq, hkv, s, d,
                                   b=1 if s == 2048 else 2)
    flash_case(gen, bf16, True, 32, 8, 1000, 128, twice=True)
    for dtype, shape in ((bf16, (4 * 2048, 4096)), (bf16, (4 * 512, 4096)),
                         (torch.float32, (4 * 512, 4096))):
        rms_case(gen, dtype, shape)
    # every build: Llama widths, one row, the decode shape, h 1000 (125
    # bf16 vectors: a ragged last warp), past 2048 vectors a row (8 a
    # thread); general: h 1001, a view two bytes in, past the budget
    for dtype in (bf16, torch.float32):
        for shape in ((37, 4096), (37, 5120), (37, 8192), (1, 4096),
                      (4, 1, 4096), (3, 5, 1000), (8, 16384)):
            rms_case(gen, dtype, shape)
        rms_case(gen, dtype, (3, 5, 1001), vector=False)
        rms_case(gen, dtype, (37, 4096), vector=False, offset=True)
        rms_case(gen, dtype, (2, 51200), vector=False)
    rms_case(gen, bf16, (4, 32768))
    rms_case(gen, torch.float32, (4, 32768), vector=False)
    # the batchers' prefill widths: 64-token chunks and the pow2 rungs (the
    # paged phase also checks every shape its runs gave)
    for s in (64, 128, 256, 512, 1024):
        rms_case(gen, bf16, (1, s, 4096))

    # the serving path's shapes: prefill attention (4 x 512, 32 heads,
    # d 128, causal, bf16) and the prefill/decode norms
    (q, k, v), frec = flash_case(gen, bf16, True, 32, 32, 512, 128, b=4)
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/hopper/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:124",
        **flash_timing(q, k, v, frec),
    }
    del q, k, v
    # the batcher's admissions: one prompt at each pow2 bucket of its
    # traffic (64 and 128 are one ragged or partial tile row), and at 73
    # tokens, an exact-length prefill of the batcher phase's checks (a
    # ragged tile); timed at 512
    for s in (64, 73, 128, 256, 1024, 512):
        (q, k, v), frec = flash_case(gen, bf16, True, 32, 32, s, 128, b=1)
    flash["batcher_admission_shape"] = flash_timing(q, k, v, frec)
    del q, k, v
    # GPT-2 serving (bench_decode's cell): generate's prefill of 8 x 256
    # and the dense batcher's admissions at its 256 and 512 rungs, 12 heads
    # of 64
    flash["gpt2_serving_shapes"] = []
    for b, s in ((GPT2_BATCH, GPT2_CTX), (1, 256), (1, 512)):
        (q, k, v), frec = flash_case(gen, bf16, True, 12, 12, s, 64, b=b)
        flash["gpt2_serving_shapes"].append(flash_timing(q, k, v, frec))
        del q, k, v

    rms = None
    for shape, key in (((4 * 512, 4096), None),
                       ((4 * 2048, 4096), "train_shape"),
                       ((4, 1, 4096), "decode_shape"),
                       ((8, 1, 4096), "batcher_decode_shape"),
                       ((FUSED_ROWS, 4096), "fused_step_shape")):
        (x, w), rrec = rms_case(gen, bf16, shape)
        n = x.numel()
        rows = n // x.shape[-1]
        r_bound, r_by = bound(2 * n * 2 + w.numel() * 2 + rows * 4, 4 * n,
                              H100_FP32_FLOPS)
        rec = {
            "name": "rms_norm", "route": "cuda",
            "source": "paddle_tpu_torch/ops/hopper/csrc/rms_norm.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_ops.py:36",
            "shape": f"x {list(shape)} bf16", "build": rrec["build"],
            "threads": rrec["threads"],
            "max_abs_err": rrec["max_abs_err"], "tol": rrec["tol"],
            "ms": time_ms(lambda: rms_norm(x, w, 1e-5)),
            "plain_ms": time_ms(lambda: rms_norm_plain(x, w, 1e-5)),
            "bound_ms": r_bound, "bound_by": r_by,
            "library_ms": time_ms(lambda: F.rms_norm(
                x, (x.shape[-1],), w, 1e-5)),
        }
        if key is None:
            rms = rec                      # the summary line's shape
        else:
            # the train step's shape (33 launches a step), generate's
            # decode, the batchers' and the paged batcher's fused step
            rms[key] = {k: rec[k] for k in ("shape", "build", "threads",
                                            "max_abs_err", "tol", "ms",
                                            "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
        del x, w
    train_records, flash["train_causal"] = train_kernels(gen)
    records = [flash, rms] + train_records
    for rec in records:
        emit({"phase": "kernels", "timing": rec})
    masked = masked_flash_kernels(gen, seed)
    for rec in records:
        if rec["name"] in masked:
            rec["masked"] = masked[rec["name"]]
    return records + [block_sparse_kernels(gen, seed)] + \
        dropout_kernels(gen, seed)


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
    # every build: Llama widths, one row, the decode shape, up to 2048
    # vectors a row (4 a thread); general: h 1001, a view two bytes in, the
    # widest row (51,200) and past the vector budget
    for dtype in (bf16, torch.float32):
        for shape in ((300, 4096), (300, 5120), (300, 8192), (1, 4096),
                      (4, 1, 4096)):
            rms_bwd_case(gen, dtype, shape)
        rms_bwd_case(gen, dtype, (300, 1001), vector=False)
        rms_bwd_case(gen, dtype, (300, 4096), vector=False, offset=True)
        rms_bwd_case(gen, dtype, (64, 51200), vector=False)
    rms_bwd_case(gen, bf16, (37, 16384))
    rms_bwd_case(gen, torch.float32, (37, 8192))
    rms_bwd_case(gen, torch.float32, (37, 16384), vector=False)
    for n, lowp in ((11008 * 4096, True), (1000, True), (1003, False)):
        for step in (1, 10):
            for wd in (0.01, 0.0):
                adamw_case(gen, n, step, wd, lowp)

    # the train phase's shapes: attention q, k, v [4, 2048, 32, 128] bf16
    # causal (its forward checked first, then the backward on the same
    # inputs); norms x [8192, 4096] bf16; AdamW on one [11008, 4096] weight
    qkv, fwd_rec = flash_case(gen, bf16, True, 32, 32, 2048, 128, b=4)
    fwd_train = flash_train_timing(qkv, fwd_rec)
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
        "shape": "x, g [8192, 4096] bf16", "build": rrec["build"],
        "plan": rrec["plan"],
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
    return records, fwd_train


def flash_train_timing(qkv, rec):
    """The forward kernel's timing at the train phase's shape, q, k, v
    [4, 2048, 32, 128] bf16 causal (16 launches a train step)."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_plain)
    F = torch.nn.functional
    q, k, v = qkv
    b, s, hq, d = q.shape
    pairs = s * (s + 1) // 2
    f_bound, f_by = bound(4 * q.numel() * q.element_size() + b * hq * s * 4,
                          4 * b * hq * d * pairs, H100_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in qkv)
    timing = {
        "shape": "q,k,v [4, 2048, 32, 128] bf16 causal",
        "max_abs_err": rec["max_abs_err"], "tol": rec["tol"],
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, True), 5),
        "bound_ms": f_bound, "bound_by": f_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))}
    emit({"phase": "kernels",
          "timing_train_shape": dict(name="flash_attention", **timing)})
    return timing


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
    # the forward's other lengths: 512 (whole tiles) and 1000 (ragged)
    for dtype in (bf16, f32):
        for causal in (False, True):
            for s, d in ((512, 64), (1000, 128)):
                masked_flash_case(gen, dtype, f32, causal, 32, 8, s, d, 1)
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


def block_sparse_case(gen, dtype, s, d, bm, b=2, h=3, blocks=(128, 128),
                      twice=False):
    """The block-sparse kernel against its plain version on q, k, v
    [b, s, h, d] and on transposed [b, h, s, d] tensors read in place, with
    tiles of `blocks` (block_q, block_k); with `twice`, a second launch must
    give the same bits."""
    from paddle_tpu_torch.ops.hopper import (block_sparse_attention_fwd,
                                             block_sparse_attention_plain)
    errs, tols, rows_zero, same = [], [], True, True
    for layout in ("bshd", "bhsd"):
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        if layout == "bhsd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out = block_sparse_attention_fwd(q, k, v, bm, *blocks)
        ref = block_sparse_attention_plain(q, k, v, bm, *blocks)
        if twice:
            same = same and torch.equal(
                out, block_sparse_attention_fwd(q, k, v, bm, *blocks))
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        tols.append(tolerance(ref, dtype))
        empty = torch.from_numpy(np.repeat(~bm.any(axis=1),
                                           blocks[0])).cuda()
        rows_zero = rows_zero and bool((out[:, empty] == 0).all())
    rec = {"kernel": "block_sparse_attention", "dtype": str(dtype)[6:],
           "s": s, "d": d, "blocks": list(blocks),
           "active_tiles": int(bm.sum()),
           "empty_rows": int((~bm.any(axis=1)).sum()),
           "full_rows": int(bm.all(axis=1).sum()), "max_abs_err": errs,
           "tol": tols, "empty_rows_exactly_zero": rows_zero}
    if twice:
        rec["bit_identical"] = same
    emit(rec)
    if not rows_zero or not same or any(e > t for e, t in zip(errs, tols)):
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
                              b=1, twice=dtype == torch.bfloat16 and d == 64)
        # 64-row pattern tiles: a 128-row block would span two pattern rows
        # (the build of one consumer warpgroup); 64-row K tiles
        for blocks in ((64, 64), (64, 128), (128, 64), (192, 128)):
            for d in (128, 64, 40):
                s = 768
                bm = rng.rand(s // blocks[0], s // blocks[1]) < 0.4
                bm[1] = False
                bm[-1] = True
                block_sparse_case(gen, dtype, s, d, bm, blocks=blocks)

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


DROPOUT_P = 0.1          # GPT-2's (paddle_tpu/models/gpt.py GPT2Config)
# integer operations of the keep mask a score: row ^ column, three
# shift-xors (two each), two multiplies, the column's add, the compare and
# the select
DROPOUT_INT_OPS = 12


def dropout_case(gen, dtype, causal, hq, hkv, s, d, b, masked, p, seed):
    """The dropout builds of the forward and both backward kernels against
    the plain versions with the same rate and seed (under a float32
    additive mask with `masked`); a second launch of each, bit for bit;
    the dropout counters, not the others, count the launches."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_bwd,
                                             flash_attention_bwd_plain,
                                             flash_attention_plain,
                                             launch_counts)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    dout = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        shape = (b, 1, s, s)
        mask = torch.where(
            torch.rand(*shape, generator=gen, device="cuda") < 0.3, -1e9,
            torch.randn(*shape, generator=gen, device="cuda"))
    before = launch_counts()
    out, lse = flash_attention(q, k, v, causal, mask, p, seed)
    again = flash_attention(q, k, v, causal, mask, p, seed)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal, mask, p, seed)
    got2 = flash_attention_bwd(q, k, v, out, dout, lse, causal, mask, p,
                               seed)
    torch.cuda.synchronize()
    counted = {n: c - before[n] for n, c in launch_counts().items()
               if c != before[n]}
    ref, ref_lse = flash_attention_plain(q, k, v, causal, mask, p, seed)
    ref_g = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, mask,
                                      p, seed)
    rec = {"kernel": "flash_attention_dropout", "dtype": str(dtype)[6:],
           "causal": causal, "heads": [hq, hkv], "s": s, "d": d, "b": b,
           "mask": masked, "p": p, "seed": seed,
           "max_abs_err": max_err(out, ref), "tol": tolerance(ref, dtype),
           "lse_max_abs_err": max_err(lse, ref_lse),
           "lse_tol": tolerance(ref_lse, torch.float32),
           "bit_identical": torch.equal(out, again[0]) and
           torch.equal(lse, again[1]) and
           all(torch.equal(a, c) for a, c in zip(got, got2)),
           "launches": counted}
    ok = rec["bit_identical"] and rec["max_abs_err"] <= rec["tol"] and \
        rec["lse_max_abs_err"] <= rec["lse_tol"] and counted == {
            "flash_attention_dropout": 2,
            "flash_attention_bwd_dq_dropout": 2,
            "flash_attention_bwd_dkv_dropout": 2}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref_g):
        rec[f"{name}_max_abs_err"] = max_err(a, r)
        rec[f"{name}_tol"] = bwd_tolerance(r, dtype)
        ok = ok and rec[f"{name}_max_abs_err"] <= rec[f"{name}_tol"]
    emit(rec)
    if not ok:
        fail(f"flash attention with dropout disagrees with its plain "
             f"version: {rec}")
    return rec


def dropout_keep_share(seed):
    """The keep mask at GPT-2's attention shape, [8, 12, 512, 512]: its
    kept share within 0.2 points of 1 - p; and the kernels' own masks, read
    back through uniform attention (q = k = 0, v = 1, non-causal: a row's
    output is its kept count times the scale over s), equal to it row by
    row: exactly from the float32 build, within 1% from the bf16 one (its
    P and output round to bf16)."""
    from paddle_tpu_torch.ops.hopper import flash_attention, keep_mask
    from paddle_tpu_torch.ops.hopper.flash_attention import dropout_scale
    b, s, h, d, p = 8, 512, 12, 64, DROPOUT_P
    kept = keep_mask(b, h, s, seed, p, "cuda").sum(-1).float()  # [b, h, s]
    rec = {"what": "dropout keep mask", "shape": [b, s, h, s], "p": p,
           "kept_share": float(kept.sum()) / (b * h * s * s),
           "share_tol": 0.002}
    ok = abs(rec["kept_share"] - (1 - p)) <= rec["share_tol"]
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.zeros(b, s, h, d, dtype=dtype, device="cuda")
        out, _ = flash_attention(z, z, torch.ones_like(z), False, None, p,
                                 seed)
        counts = (out[..., 0].float() * s / dropout_scale(p)).transpose(1, 2)
        err = float(((counts - kept).abs() / kept).max())
        if dtype == torch.float32:
            rec["float32_rows_equal"] = torch.equal(counts.round(), kept)
            ok = ok and rec["float32_rows_equal"]
        else:
            rec["bfloat16_rows_max_rel_err"] = err
            ok = ok and err <= 0.01
        del z, out, counts
    emit({"phase": "kernels", "dropout_keep_share": rec})
    if not ok:
        fail(f"dropout keep mask: {rec}")


def dropout_kernels(gen, seed):
    """The flash kernels' dropout builds: every case, the keep mask's share,
    then the three kernels timed at GPT-2's training shape, q, k, v
    [8, 512, 12, 64] bf16 causal, p = 0.1, beside the same kernels at
    p = 0, their plain versions, SDPA with dropout_p = 0.1 (a yardstick of
    time: its mask is another) and the card's bound. Returns the summary
    line's three records."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_bwd,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_bwd_plain,
                                             flash_attention_plain)
    from paddle_tpu_torch.ops.hopper.flash_attention import _delta
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    i = 0
    for dtype in (bf16, f32):
        for causal in (True, False):
            for hq, hkv in ((12, 12), (32, 8)):
                for s, d in ((512, 64), (300, 128), (2048, 128),
                             (2048, 64)):
                    if s == 2048 and d == 64 and hq == 32:
                        continue
                    dropout_case(gen, dtype, causal, hq, hkv, s, d,
                                 1 if s == 2048 else 2, False, DROPOUT_P,
                                 seed + i if i % 3 else -(seed + i + 1))
                    i += 1
            for s, d in ((512, 128), (300, 64)):     # under a float32 mask
                dropout_case(gen, dtype, causal, 32, 8, s, d, 2, True, 0.3,
                             seed + i)
                i += 1
    dropout_keep_share(seed)

    b, s, h, d, p = 8, 512, 12, 64, DROPOUT_P
    dseed = seed + 100
    q, k, v, dout = (torch.randn(b, s, h, d, generator=gen,
                                 device="cuda").to(bf16) for _ in range(4))
    out, lse = flash_attention(q, k, v, True, None, p, dseed)
    ref, _ = flash_attention_plain(q, k, v, True, None, p, dseed)
    got = flash_attention_bwd(q, k, v, out, dout, lse, True, None, p, dseed)
    ref_g = flash_attention_bwd_plain(q, k, v, out, dout, lse, True, None, p,
                                      dseed)
    torch.cuda.synchronize()
    errs = {"flash_attention_dropout": (max_err(out, ref),
                                        tolerance(ref, bf16)),
            "flash_attention_bwd_dq_dropout": (
                max_err(got[0], ref_g[0]), bwd_tolerance(ref_g[0], bf16)),
            "flash_attention_bwd_dkv_dropout": (
                max(max_err(got[1], ref_g[1]), max_err(got[2], ref_g[2])),
                max(bwd_tolerance(ref_g[1], bf16),
                    bwd_tolerance(ref_g[2], bf16)))}
    if any(e > t for e, t in errs.values()):
        fail(f"dropout kernels at GPT-2's shape: {errs}")
    del ref, got, ref_g
    delta = _delta(out, dout)
    pairs = s * (s + 1) // 2
    gemm = 2 * b * h * d * pairs             # one causal product
    int_ops = DROPOUT_INT_OPS * b * h * pairs
    io = q.numel() * q.element_size()
    rows = 2 * b * h * s * 4                 # lse and delta

    def drop_bound(nbytes, products):
        """The larger of bytes over the memory's rate and the products at
        the bf16 tensor-core rate plus the mask's integer operations at the
        CUDA cores' 67 T/s, the card's float32 rate (the data sheet lists no
        integer rate)."""
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = (products * gemm / H100_BF16_FLOPS
                 + int_ops / H100_FP32_FLOPS) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, dropout_p=p))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             dropout_p=p)
    dot = dout.transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    del lib_out, qt, kt, vt, dot
    bwd_plain = time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, out, dout, lse, True, None, p, dseed), 5)
    shape = "q,k,v [8, 512, 12, 64] bf16 causal, dropout 0.1"
    records = []
    for name, line, src, fn, nbytes, products, plain_ms, lib_ms, note in (
            ("flash_attention_dropout", 124, "flash_attention.cu",
             lambda pp: flash_attention(q, k, v, True, None, pp, dseed),
             4 * io + b * h * s * 4, 2,
             time_ms(lambda: flash_attention_plain(q, k, v, True, None, p,
                                                   dseed), 5),
             lib_fwd, "F.scaled_dot_product_attention(dropout_p=0.1): "
                      "another mask, timed as a yardstick"),
            ("flash_attention_bwd_dq_dropout", 180, "flash_attention_bwd.cu",
             lambda pp: flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                               True, None, pp, dseed),
             5 * io + rows, 3, bwd_plain, lib_bwd,
             "backward of F.scaled_dot_product_attention(dropout_p=0.1), "
             "dq, dk, dv together"),
            ("flash_attention_bwd_dkv_dropout", 231,
             "flash_attention_bwd.cu",
             lambda pp: flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                True, None, pp, dseed),
             6 * io + rows, 4, bwd_plain, lib_bwd,
             "backward of F.scaled_dot_product_attention(dropout_p=0.1), "
             "dq, dk, dv together")):
        b_ms, b_by = drop_bound(nbytes, products)
        rec = {"name": name, "route": "cuda",
               "source": f"paddle_tpu_torch/ops/hopper/csrc/{src}",
               "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
               "shape": shape, "max_abs_err": errs[name][0],
               "tol": errs[name][1], "ms": time_ms(lambda: fn(p)),
               "no_dropout_ms": time_ms(lambda: fn(0.0)),
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "library_note": note}
        if "bwd" in name:
            rec["plain_note"] = "the whole plain backward (dq, dk, dv)"
        records.append(rec)
        emit({"phase": "kernels", "timing": rec})
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
    return records


def phase_routing(seed):
    """Attention calls the flash kernels do not take reach the dense route,
    with its one-time warning, and never a kernel wrapper that raises:
    Llama's tiny config (head dim 16, float32) trains one batch on the
    card, a float16 call completes, and strided q, k, v (GPT-2's slices of
    one projection) take the kernel as copies, forward and backward, with
    dropout, equal to the call on contiguous copies."""
    import warnings

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.hopper import launch_counts, \
        reset_launch_counts
    PF._DENSE_ROUTE_SEEN.clear()
    reset_launch_counts()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        model = LlamaForCausalLM(llama_tiny_config(), device="cuda",
                                 generator=torch.Generator(device="cuda")
                                 .manual_seed(seed))
        gen = torch.Generator(device="cuda").manual_seed(seed + 11)
        ids = torch.randint(0, 128, (2, 32), generator=gen, device="cuda")
        _, loss = model(ids, labels=ids)
        loss.backward()
        half = torch.randn(2, 64, 4, 64, generator=gen, device="cuda").half()
        out16 = PF.scaled_dot_product_attention(half, half, half,
                                                is_causal=True)
        dense = launch_counts()
        qkv = torch.randn(2, 256, 3, 12, 64, generator=gen,
                          device="cuda").to(torch.bfloat16).requires_grad_()
        g = torch.randn(2, 256, 12, 64, generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = PF.scaled_dot_product_attention(
            *qkv.unbind(2), is_causal=True, dropout_p=DROPOUT_P,
            generator=torch.Generator().manual_seed(seed))
        out.backward(g)
        leaves = [t.detach().contiguous().requires_grad_()
                  for t in qkv.unbind(2)]
        ref = PF.scaled_dot_product_attention(
            *leaves, is_causal=True, dropout_p=DROPOUT_P,
            generator=torch.Generator().manual_seed(seed))
        ref.backward(g)
        torch.cuda.synchronize()
    strided = {n: c - dense[n] for n, c in launch_counts().items()
               if c != dense[n]}
    reasons = sorted({str(w.message).split("(", 1)[-1].rstrip(")")
                      for w in seen if "dense attention" in str(w.message)})
    rec = {"phase": "routing", "llama_tiny_loss": float(loss.detach()),
           "float16_finite": bool(torch.isfinite(out16).all()),
           "dense_launches": {n: c for n, c in dense.items() if c},
           "strided_launches": strided, "dense_reasons": reasons,
           "strided_equal": torch.equal(out, ref) and torch.equal(
               qkv.grad, torch.stack([t.grad for t in leaves], 2))}
    emit(rec)
    ok = (math.isfinite(rec["llama_tiny_loss"]) and rec["float16_finite"]
          and not any(n.startswith("flash") for n in rec["dense_launches"])
          and strided == {"flash_attention_dropout": 2,
                          "flash_attention_bwd_dq_dropout": 2,
                          "flash_attention_bwd_dkv_dropout": 2}
          and rec["strided_equal"]
          and any("head_dim 16" in r for r in reasons)
          and any("float16" in r for r in reasons))
    if not ok:
        fail(f"attention routing: {rec}")


# -- phase 3 -----------------------------------------------------------------
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
    for step in ("prefill", "decode_step"):
        rms_vector_only(profile[step], step, ["rms_norm_fwd_vec"])
    if profile["prefill"]["flash_fwd_kernels"] != ["flash_fwd_wgmma"]:
        fail(f"prefill forward kernels "
             f"{profile['prefill']['flash_fwd_kernels']}, expected the wgmma "
             "build only")
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


# -- phase 4b ----------------------------------------------------------------

# the batcher phase's configuration (and the default pow2 prompt ladder,
# greedy picks)
BATCHER = dict(max_batch=8, s_max=1024)
# The batcher phase's logit checks are held to what the bf16 model itself
# spreads, measured in the same run, not to a fixed tolerance:
# - a bucketed prefill to its own exact-length prefill within that
#   prompt's spread between the exact prefill at batch 1 and at batch 2
#   (the same math at another row count), plus one bf16 step at the row's
#   largest magnitude (PREFILL_MARGIN). The spread is 0 unless a prompt
#   has fewer than 161 tokens: below that cuBLAS reduces the 11008 -> 4096
#   product in another order at some row counts, and below 132 rows the
#   RMSNorm forward takes its decode plan (tools/prefill_spread.py; PERF.md);
# - the batcher's tokens to a full bf16 forward over prompt + generated
#   within the float32 model's verdict on the bf16 forward's own picks:
#   how far below the float32 top logit they lie, relative to the row's
#   largest magnitude.
PREFILL_MARGIN = 2.0 ** -8


def batcher_traffic(seed, vocab):
    """24 requests: prompt lengths uniform in [64, 768], max_new_tokens
    uniform in [16, 64] and the prompts' tokens uniform over the vocabulary,
    all drawn from `seed`."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(64, 769, 24)
    news = rng.randint(16, 65, 24)
    return [(rng.randint(0, vocab, n).astype(np.int64), int(m))
            for n, m in zip(lengths, news)]


def batcher_run(model, traffic, compile):
    """Serve `traffic` through a new ContinuousBatcher: 12 requests up
    front and 12 more after the 5th step, so that admission happens
    mid-flight and slots are reused. The launch counters are set to 0 just
    before and read just after. Returns (each request's full sequence, the
    run's report, the batcher)."""
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops.hopper import launch_counts, reset_launch_counts
    reg = get_registry()
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = ContinuousBatcher(model, compile=compile, **BATCHER)
    reset_launch_counts()
    t0 = time.perf_counter()
    rids = [b.submit(p, n) for p, n in traffic[:12]]
    early = []
    for _ in range(5):
        early += b.step()
    rids += [b.submit(p, n) for p, n in traffic[12:]]
    outs = b.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    outs.update({rid: b.pop_result(rid) for rid in early})
    stats = b.stats()

    def dense(name):
        return reg.get(name).labels(engine="dense")

    step_s = dense("serving_step_seconds")
    ttft_s = dense("serving_ttft_seconds")
    report = {
        "compile": compile, "max_batch": BATCHER["max_batch"],
        "s_max": BATCHER["s_max"],
        "admissions": dense("serving_admissions_total").value,
        "steps": stats["steps"], "tokens": stats["generated_tokens"],
        "wall_s": wall, "tokens_per_s": stats["generated_tokens"] / wall,
        # the decode dispatch alone (the step's admissions excluded), from
        # the batcher's serving_step_seconds; the first graphed step holds
        # the capture
        "decode_ms_per_step": step_s.quantile(0.5) * 1e3,
        "decode_ms_first_step_or_max": step_s.quantile(1.0) * 1e3,
        "ttft_ms_median": ttft_s.quantile(0.5) * 1e3,
        "ttft_ms_max": ttft_s.quantile(1.0) * 1e3,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "wrapper_counts": launches,
        "captures": getattr(b._step_fn, "captures", 0),
        "replays": getattr(b._step_fn, "replays", 0),
        "stats": stats,
    }
    return [outs[r] for r in rids], report, b


def batcher_profile(b, prompt=512, new=64):
    """Profile one step that admits a request into every slot (8 prefills
    at the 512 bucket and a decode), time 8 decode steps, then profile 8
    more: the admissions' and the steps' kernels and the idle share of a
    step."""
    rng = np.random.RandomState(0)
    vocab = b.model.config.vocab_size
    prompts = [rng.randint(0, vocab, prompt) for _ in range(b.max_batch)]
    live = []

    def admit_all():
        live[:] = [b.submit(p, new) for p in prompts]
        b.step()

    admit = profile_one(admit_all)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        b.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    steps = profile_one(b.step, calls=8)
    for rid in live:
        b.abort(rid)
    device_ms = (steps["device_ms"] / 8 if steps["device_ms"] !=
                 "not measured" else "not measured")
    return {"admissions": admit, "steps": steps, "step_wall_ms": wall_ms,
            "step_device_ms": device_ms,
            "device_idle_share": (1 - device_ms / wall_ms
                                  if device_ms != "not measured"
                                  else "not measured")}


def serving_model(seed):
    """Llama-2-7B (bf16, all 32 layers) with random weights from `seed`: the
    serve, batcher and paged phases' model."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    return LlamaForCausalLM(llama2_7b_config(dtype="bfloat16"),
                            device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(seed))


def phase_batcher(seed, model):
    """The dense ContinuousBatcher at Llama-2-7B width (bf16, 32 layers,
    random weights from --seed), max_batch 8, s_max 1024, the pow2 prompt
    ladder, greedy: the same traffic eagerly (compile=False) and with the
    decode step replayed as a CUDA graph (compile=True). Checks, for each
    mode: every request completes with prompt + max_new_tokens tokens; the
    launch counts (eager: 32 flash forwards an admission and 65 RMSNorm
    forwards an admission or a step; graphed: the same for the admissions
    and 65 for the eager warm-up call and for the capture, which launches
    nothing; one replay a step); the profiles of 8 admissions (the
    tensor-core forward only) and of 8 steps (the RMSNorm vector build
    only). Then: both modes give the same tokens; for 4 requests, one full
    forward over prompt + generated puts the batcher's token's logit at
    each generated position no further below that row's top logit,
    relative to the row's largest magnitude, than the bf16 forward's own
    picks lie below a float32 copy's top; each request's bucketed prefill
    agrees with its exact-length prefill within that prompt's spread
    between batch 1 and batch 2 plus PREFILL_MARGIN, and its argmax is the
    batcher's first token. Returns each run's launches (graphed: the
    replays' included), the graphed run's wrapper counts, and the eager
    run's sequences."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    from paddle_tpu_torch.ops.hopper import KERNELS
    from paddle_tpu_torch.perf.buckets import resolve_ladder
    cfg = model.config
    layers = cfg.num_hidden_layers
    norms = 2 * layers + 1
    traffic = batcher_traffic(seed, cfg.vocab_size)
    outs, counts = {}, {}
    for compile in (False, True):
        mode = "graphed" if compile else "eager"
        got, rep, b = batcher_run(model, traffic, compile)
        rep["profile"] = batcher_profile(b)
        del b                      # the graph and its memory pool
        torch.cuda.empty_cache()
        for (p, n), o in zip(traffic, got):
            if len(o) != len(p) + n or not np.array_equal(o[:len(p)], p):
                fail(f"batcher ({mode}) returned {len(o)} tokens for a "
                     f"prompt of {len(p)} and {n} new ones, or lost the "
                     "prompt")
        adm, steps = rep["admissions"], rep["steps"]
        if adm != len(traffic):
            fail(f"batcher ({mode}) admitted {adm} of {len(traffic)}")
        expect = dict.fromkeys(KERNELS, 0)
        expect["flash_attention"] = layers * adm
        expect["rms_norm"] = norms * (adm + steps) if not compile else \
            norms * (adm + 2 * rep["captures"])
        # a wrapper counts where it launches, and also at capture, where it
        # does not; each replay launches the captured step's norms again
        rep["launches"] = dict(rep["wrapper_counts"])
        rep["launches"]["rms_norm"] += norms * (rep["replays"] -
                                                rep["captures"])
        emit({"phase": "batcher", "mode": mode, "layers": layers,
              "requests": len(traffic), **rep})
        if rep["wrapper_counts"] != expect or (compile and (
                rep["captures"] != 1 or rep["replays"] != steps)):
            fail(f"batcher ({mode}) launch counts {rep['wrapper_counts']} "
                 f"({rep['captures']} captures, {rep['replays']} replays of "
                 f"{steps} steps), expected {expect}")
        prof = rep["profile"]
        if prof["admissions"]["flash_fwd_kernels"] != ["flash_fwd_wgmma"]:
            fail(f"batcher ({mode}) admission attention kernels "
                 f"{prof['admissions']['flash_fwd_kernels']}, expected the "
                 "wgmma build only")
        rms_vector_only(prof["admissions"], f"batcher ({mode}) admissions",
                        ["rms_norm_fwd_vec"])
        rms_vector_only(prof["steps"], f"batcher ({mode}) steps",
                        ["rms_norm_fwd_vec"])
        if prof["steps"]["flash_fwd_kernels"]:
            fail(f"batcher ({mode}) decode steps ran a flash forward")
        outs[mode], counts[mode] = got, rep["launches"]
        if compile:
            counts["graphed_wrapper_counts"] = rep["wrapper_counts"]
    if any(not np.array_equal(a, g)
           for a, g in zip(outs["eager"], outs["graphed"])):
        fail("the graphed decode step gave other tokens than the eager one")

    # the tokens against the model itself: bf16 on the card, and a float32
    # copy of it for the floor of the full-forward check
    ref = LlamaForCausalLM(llama2_7b_config(), device="cuda")
    ref.load_state_dict(model.state_dict())
    ladder = resolve_ladder("pow2", hi=BATCHER["s_max"])
    full, prefills = [], []

    def gaps(logits, toks):
        # each row's top logit less the logit at toks, over its largest
        # magnitude
        picked = logits.gather(1, toks[:, None])[:, 0]
        return (logits.max(-1).values - picked) / logits.abs().max(-1).values

    with torch.no_grad():
        for i, ((p, n), seq) in enumerate(zip(traffic, outs["eager"])):
            if i < 4:
                ids = torch.from_numpy(seq[None, :-1]).cuda()
                toks = torch.from_numpy(seq[len(p):]).cuda()
                bf16 = model(ids)[0, len(p) - 1:].float()
                f32 = ref(ids)[0, len(p) - 1:].float()
                full.append({"i": i, "n": len(p), "new": n,
                             "gap": float(gaps(bf16, toks).max()),
                             "bf16_picks_vs_f32": float(
                                 gaps(f32, bf16.argmax(-1)).max())})
            padded = np.zeros(ladder.bucket(len(p)), np.int64)
            padded[:len(p)] = p
            bucketed, _, _ = model.prefill(
                torch.from_numpy(padded[None]).cuda(), BATCHER["s_max"],
                torch.full((1, 1), len(p), dtype=torch.int32,
                           device="cuda"))
            exact = torch.from_numpy(p[None]).cuda()
            one, _, _ = model.prefill(exact, BATCHER["s_max"])
            two, _, _ = model.prefill(exact.repeat(2, 1), BATCHER["s_max"])
            scale = float(one.abs().max())
            spread = max_err(two[:1], one) / scale
            prefills.append({"i": i, "n": len(p), "bucket": len(padded),
                             "err": max_err(bucketed, one) / scale,
                             "spread_batch2_vs_batch1": spread,
                             "limit": spread + PREFILL_MARGIN})
            if int(bucketed[0, -1].argmax()) != int(seq[len(p)]):
                fail(f"request {i}: the batcher's first token is not its "
                     "bucketed prefill's argmax")
    del ref
    floor = max(r["bf16_picks_vs_f32"] for r in full)
    rec = {"phase": "batcher", "check": "tokens", "graphed_equals_eager": True,
           "full_forward": max(r["gap"] for r in full),
           "full_forward_limit": floor, "full_forward_requests": full,
           "bucketed_prefill": max(r["err"] for r in prefills),
           "bucketed_prefill_margin": PREFILL_MARGIN,
           "bucketed_prefill_requests": [r for r in prefills
                                         if r["err"] or r[
                                             "spread_batch2_vs_batch1"]],
           "bucketed_prefill_bit_equal": sum(not r["err"] for r in prefills)}
    emit(rec)
    if rec["full_forward"] > floor:
        fail(f"the batcher's tokens lie further below a full forward's top "
             f"logit than the bf16 model's own picks lie below the float32 "
             f"model's: {rec}")
    over = [r for r in prefills if r["err"] > r["limit"]]
    if over:
        fail(f"bucketed prefills disagree with exact-length ones beyond "
             f"their own batch-2 spread: {over}")
    torch.cuda.empty_cache()
    return counts, outs["eager"]


# -- phase 4c ----------------------------------------------------------------

# Run A: benchmarks/bench_decode.py:190-192's PagedContinuousBatcher (block
# 64, 64-token chunks, pages on demand) over the batcher phase's traffic.
PAGED_A = dict(max_batch=8, s_max=1024, block_size=64, prefill_chunk=64,
               policy="ondemand")
# Run B: benchmarks/bench_gateway.py:75-79's (pages on demand, the prefix
# cache, the pow2 ladder) at block 16 and 7B width; 228 pages (of the 512
# that 8 full slots would take) make seed 0's traffic preempt.
PAGED_B = dict(max_batch=8, s_max=1024, block_size=16, n_pages=228,
               policy="ondemand", prefix_cache=True, prompt_buckets="pow2")
# The fused phase: benchmarks/bench_decode.py:207-211's configuration, Run
# A's with fused admission (one 64-token chunk a step inside the decode
# step's call), then with decode_block=8. Its step norms B + C rows.
FUSED = dict(PAGED_A, fused_admission=True)
FUSED_ROWS = PAGED_A["max_batch"] + PAGED_A["prefill_chunk"]
# The fused run's pool small enough that seed 0's traffic aborts an
# admission: an abort needs a lone decoder to cross into a new page while
# the admission in flight holds every other page. Simulated on the host
# with this batcher (its page accounting does not read the tokens), the
# traffic aborts one admission at 15 pages and at no other size from 13
# (its largest request) to 128 (every slot's worst case).
FUSED_SMALL_PAGES = 15


def paged_traffic(seed, vocab):
    """24 requests sharing 4 system prompts of 512 tokens (request i takes
    prompt i % 4), each with a tail of 16-256 tokens and 16-64 new tokens,
    all drawn from `seed`."""
    rng = np.random.RandomState(seed + 1)
    systems = [rng.randint(0, vocab, 512).astype(np.int64)
               for _ in range(4)]
    tails = rng.randint(16, 257, 24)
    news = rng.randint(16, 65, 24)
    return [(np.concatenate([systems[i % 4],
                             rng.randint(0, vocab, t).astype(np.int64)]),
             int(n)) for i, (t, n) in enumerate(zip(tails, news))]


def count_calls(obj, name):
    """Count calls of obj.name and collect the shapes of their first
    arguments (an instance attribute wraps the method; `del obj.name`
    restores it). Returns [calls, the set of shapes]."""
    fn, box = getattr(obj, name), [0, set()]

    def counted(*args, **kw):
        box[0] += 1
        if args:
            box[1].add(tuple(args[0].shape))
        return fn(*args, **kw)
    setattr(obj, name, counted)
    return box


def paged_run(model, traffic, config, compile):
    """Serve `traffic` through a new PagedContinuousBatcher(**config): 12
    requests up front and 12 after the 5th step. The launch counters, the
    model's paged_prefill_into calls (one a prefill or a chunk, or a
    graph's warm-up or capture) and the batcher's aborted fused admissions
    are set to 0 just before and read just after; the batcher audits its
    pages after every release. The report also holds the shapes of the ids
    the prefill calls took, each captured function's captures and replays,
    and each request's prefix-cache hit rows at each of its admissions.
    Returns (each request's full sequence, the run's report, the
    batcher)."""
    from paddle_tpu_torch.inference import PagedContinuousBatcher
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops.hopper import launch_counts, reset_launch_counts
    reg = get_registry()
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = PagedContinuousBatcher(model, compile=compile, **config)
    calls = count_calls(model, "paged_prefill_into")
    aborts = count_calls(b, "_abort_admission")
    hits, prefill_end = {}, b._trace_prefill_end

    def record_hit(req, **tags):
        # fused admissions use no prefix cache and record no hit
        hits.setdefault(req.rid, []).append(tags.get("prefix_hit", 0))
        return prefill_end(req, **tags)
    b._trace_prefill_end = record_hit
    reset_launch_counts()
    t0 = time.perf_counter()
    rids = [b.submit(p, n) for p, n in traffic[:12]]
    early = []
    for _ in range(5):
        early += b.step()
    rids += [b.submit(p, n) for p, n in traffic[12:]]
    outs = b.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # the wrappers close over bound methods of b: left in place, they
    # would keep b (its pools and graphs) alive past `del b`, until a
    # full garbage collection
    del model.paged_prefill_into, b._abort_admission, b._trace_prefill_end
    outs.update({rid: b.pop_result(rid) for rid in early})
    stats = b.stats()

    def paged(name):
        return reg.get(name).labels(engine="paged")

    step_s = paged("serving_step_seconds")
    ttft_s = paged("serving_ttft_seconds")
    report = {
        "compile": compile, **{k: v for k, v in config.items()},
        "n_pages": b.n_pages,
        "admissions": paged("serving_admissions_total").value,
        "prefill_calls": calls[0], "prefill_shapes": sorted(calls[1]),
        "steps": stats["steps"],
        "tokens": stats["generated_tokens"], "wall_s": wall,
        "tokens_per_s": stats["generated_tokens"] / wall,
        "decode_ms_per_step": step_s.quantile(0.5) * 1e3,
        "decode_ms_first_step_or_max": step_s.quantile(1.0) * 1e3,
        "ttft_ms_median": ttft_s.quantile(0.5) * 1e3,
        "ttft_ms_max": ttft_s.quantile(1.0) * 1e3,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "preemptions": stats["preemptions"],
        "prefix_hit_tokens": reg.get("serving.prefix_hit_tokens").value,
        "prefix_miss_tokens": reg.get("serving.prefix_miss_tokens").value,
        "prefix_evictions": reg.get("serving.prefix_evictions").value,
        "pages_leaked": reg.get("serving.pages_leaked").value,
        "aborted_admissions": aborts[0],
        "wrapper_counts": launches,
        # per captured function: [captures, replays] (graphed runs)
        "graphs": {name: [fn.captures, fn.replays] for name, fn in (
            (name, getattr(b, f"_{name}_fn", None))
            for name in ("step", "chunk", "fused", "block"))
            if hasattr(fn, "replays")},
        "stats": stats,
        "prefix_hit_rows": [hits.get(r, []) for r in rids],
    }
    return [outs[r] for r in rids], report, b


def layer_parts(model):
    """One layer's pieces for paged_step_split, for either family: (its
    weight products over x [rows, E] and wide [rows, intermediate], one
    norm over x, the LM head, the layer count, heads, KV heads and head
    width)."""
    cfg = model.config
    if hasattr(model, "transformer"):                  # GPT-2
        block = model.transformer.h[0]
        attn, mlp = block.attn, block.mlp

        def products(x, wide):
            for lin in (attn.c_attn, attn.c_proj, mlp.c_fc):
                lin(x)
            mlp.c_proj(wide)
        return (products, block.ln_1, model._logits,
                cfg.num_hidden_layers, cfg.num_attention_heads,
                cfg.num_attention_heads, cfg.head_dim)
    layer = model.model.layers[0]
    attn, mlp = layer.self_attn, layer.mlp

    def products(x, wide):
        for lin in (attn.q_proj, attn.k_proj, attn.v_proj, attn.o_proj,
                    mlp.gate_proj, mlp.up_proj):
            lin(x)
        mlp.down_proj(wide)
    return (products, layer.input_layernorm, model._lm_logits,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.head_dim)


def paged_step_split(b, reps=20, chunk=0, chunk_at=448):
    """Device ms of one decode step's parts at the batcher's state (its page
    pool, block table and timelines), each timed alone with CUDA events
    (median of `reps`) and multiplied by the step's count of it: the
    timeline gather and float32 cast of K and V (of an int8 pool: the
    gather and dequantization, "gather_and_dequant"), the attention over them
    (scores, mask, softmax, P V), the weight products (7 a layer and the
    LM head for Llama, 4 for GPT-2) and the 2L + 1 norms. With `chunk` C,
    the fused step's parts: the products and norms over B + C rows, one
    more timeline gathered (the admission's) and its C tokens attended over
    it at rows `chunk_at` onwards."""
    from paddle_tpu_torch.incubate.nn.functional import decode_attention
    model, cfg = b.model, b.model.config
    products, norm, head, layers, h, kvh, d = layer_parts(model)
    bsz = b.max_batch
    kc, vc = b._state["layers"][0]
    # an int8 pool's timeline is dequantized as it is gathered (layer 0's
    # scales: static, or the slots' dynamic rows)
    kdq = vdq = None
    if kc.dtype == torch.int8:
        sc = (b._state.get("cache_scales") or model._cachekv_scales)[0]
        kdq, vdq = sc["kdq"], sc["vdq"]
    part = "gather_and_dequant" if kdq is not None else "gather_and_cast"
    b._sync_tables()
    bt = b._state["block_tables"].long()
    dec = b._state["dec_lens"].long()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = bsz + chunk
    act = next(model.parameters()).dtype
    x = torch.randn(rows, cfg.hidden_size, generator=gen, device="cuda",
                    dtype=act)
    q = torch.randn(bsz, 1, h, d, generator=gen, device="cuda", dtype=act)

    def gather(table):
        rows = table.shape[0]
        return (decode_attention._gather_paged(
                    kc, table, None if kdq is None else kdq[:rows]
                    if kdq.dim() == 2 else kdq),
                decode_attention._gather_paged(
                    vc, table, None if vdq is None else vdq[:rows]
                    if vdq.dim() == 2 else vdq))

    gk, gv = gather(bt)

    def events(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # the host queues the events and the calls before the card
            # reaches them, so its launch latency stays outside
            torch.cuda._sleep(1_000_000)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[reps // 2]

    wide = torch.zeros(rows, cfg.intermediate_size, device="cuda",
                       dtype=x.dtype)

    with torch.no_grad():
        split = {
            part: layers * events(lambda: gather(bt)),
            "attention": layers * events(lambda: decode_attention._attend(
                q, gk, gv, dec[:, None], dec + 1)),
            # the LM head over the decode rows (and the chunk's one row)
            "weight_products": layers * events(lambda: products(x, wide))
            + events(lambda: [head(x[:n]) for n in (bsz, 1)[
                :1 + bool(chunk)]]),
            "norms": (2 * layers + 1) * events(lambda: norm(x)),
        }
        if chunk:
            # the admission's timeline (any table row: each gathers all
            # its pages) and its chunk, in the middle of a prompt
            qc = torch.randn(1, chunk, h, d, generator=gen, device="cuda",
                             dtype=act)
            gkc, gvc = gather(bt[:1])
            pos = torch.arange(chunk_at, chunk_at + chunk,
                               device="cuda")[None]
            split[part] += layers * events(lambda: gather(bt[:1]))
            split["attention"] += layers * events(
                lambda: decode_attention._attend(
                    qc, gkc, gvc, pos, pos[:, -1] + 1))
    return split


def paged_profile(b, prompt=512, new=64, admit=4):
    """Profile one step that admits `admit` requests (prompts of `prompt`
    tokens) and decodes, time 8 decode steps, profile 8 more, then time the
    step's parts (paged_step_split): the admissions' and the steps'
    kernels, the idle share of a step and where its device time goes."""
    rng = np.random.RandomState(0)
    vocab = b.model.config.vocab_size
    prompts = [rng.randint(0, vocab, prompt) for _ in range(admit)]
    live = []

    def admit_all():
        live[:] = [b.submit(p, new) for p in prompts]
        b.step()

    admissions = profile_one(admit_all)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        b.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    steps = profile_one(b.step, calls=8)
    split = paged_step_split(b)
    for rid in live:
        b.abort(rid)
    b.audit_pages()
    device_ms = (steps["device_ms"] / 8 if steps["device_ms"] !=
                 "not measured" else "not measured")
    if device_ms != "not measured":
        split["other"] = device_ms - sum(split.values())
    return {"admissions": admissions, "steps": steps,
            "step_wall_ms": wall_ms, "step_device_ms": device_ms,
            "step_split_ms": split,
            "device_idle_share": (1 - device_ms / wall_ms
                                  if device_ms != "not measured"
                                  else "not measured")}


def pick_gaps(logits, toks):
    """Each row's top logit less the logit at toks, over the row's largest
    magnitude."""
    picked = logits.gather(1, toks[:, None])[:, 0]
    return (logits.max(-1).values - picked) / logits.abs().max(-1).values


def bf16_spread(model, ref, seqs, prompt_lens):
    """How far below a float32 copy's top logit the bf16 model's own picks
    lie (pick_gaps over every generated position of `seqs`): the noise of a
    bf16 pick in this run, which a token that differs between two bf16
    paths may not exceed. Also each sequence's own tokens against its bf16
    full forward. Returns (spread, the largest such gap, per sequence)."""
    rows = []
    dev = next(model.parameters()).device
    with torch.no_grad():
        for seq, n in zip(seqs, prompt_lens):
            ids = torch.from_numpy(seq[None, :-1]).to(dev)
            toks = torch.from_numpy(seq[n:]).to(dev)
            bf16 = model(ids)[0, n - 1:].float()
            f32 = ref(ids)[0, n - 1:].float()
            rows.append({"n": n, "new": len(seq) - n,
                         "gap": float(pick_gaps(bf16, toks).max()),
                         "bf16_picks_vs_f32": float(
                             pick_gaps(f32, bf16.argmax(-1)).max())})
    return (max(r["bf16_picks_vs_f32"] for r in rows),
            max(r["gap"] for r in rows), rows)


def divergence(ref, pairs):
    """Two paths' sequences of the same requests: `pairs` of (prompt
    length, sequence a, sequence b). Counts the generated tokens that
    differ; at each request's first differing token (the two share all
    before it) the float32 copy's verdict: how far apart the two picks'
    logits lie, over the row's largest magnitude. Returns (differing
    tokens, the first differences)."""
    differing, firsts = 0, []
    dev = next(ref.parameters()).device
    with torch.no_grad():
        for i, (n, a, b) in enumerate(pairs):
            diff = np.flatnonzero(a[n:] != b[n:])
            differing += len(diff)
            if not len(diff):
                continue
            j = n + int(diff[0])
            row = ref(torch.from_numpy(a[None, :j]).to(dev))[0, -1].float()
            scale = row.abs().max()
            firsts.append({"i": i, "at": j - n, "new": len(a) - n,
                           "gap": float((row[int(a[j])] - row[int(b[j])])
                                        .abs() / scale),
                           # each pick below the float32 top
                           "below_top": [float((row.max() - row[int(x[j])])
                                               / scale) for x in (a, b)]})
    return differing, firsts


def phase_paged(seed, model, dense_tokens):
    """The PagedContinuousBatcher at Llama-2-7B width (bf16, 32 layers,
    random weights from --seed; plain paged attention over a page pool).

    Run A (PAGED_A, the batcher phase's traffic), eagerly and with the
    decode step replayed as a CUDA graph; Run B (PAGED_B, paged_traffic,
    the prefix cache), graphed, and its traffic again eagerly with no
    prefix cache in the default pool (no preemption: "B plain"); then
    generate_paged at the serve phase's shape (4 x 512 prompt tokens, 32
    new, block 64). Checks: every request completes at its full length;
    Run A's graphed tokens equal its eager ones with one capture; Run B
    preempts and hits the prefix cache; no page leaks; the RMSNorm wrapper
    counts 65 launches a prefill call (a chunk or a whole prefill) and a
    decode step (graphed: 65 for the warm-up and for the capture, and the
    replays counted by to_static), and nothing else launches; the profiles
    of 4 admissions and 8 steps show the norms ran the RMSNorm vector build
    only and no flash kernel; the RMSNorm forward against its plain version
    at every prefill shape the runs gave it. Then, against a float32 copy:
    the bf16 spread of the run (bf16_spread over 4 of Run A's requests);
    Run B's tokens against their full forward within it, for 4 requests
    that missed the cache and 4 that hit it; and where Run A's tokens
    differ from the dense batcher's, Run B's from B plain's, or
    generate_paged's from generate's, the two picks within it (the paths
    sum in other orders: PERF.md). Returns each run's launches (graphed:
    the replays' included)."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    from paddle_tpu_torch.ops.hopper import (KERNELS, launch_counts,
                                             reset_launch_counts)
    cfg = model.config
    layers = cfg.num_hidden_layers
    norms = 2 * layers + 1
    traffic_a = batcher_traffic(seed, cfg.vocab_size)
    traffic_b = paged_traffic(seed, cfg.vocab_size)
    plain_b = dict(PAGED_B, prefix_cache=False, n_pages=None)
    outs, counts, reps = {}, {}, {}
    for name, mode, config, traffic, compile in (
            ("A", "A eager", PAGED_A, traffic_a, False),
            ("A", "A graphed", PAGED_A, traffic_a, True),
            ("B", "B graphed", PAGED_B, traffic_b, True),
            ("B", "B plain", plain_b, traffic_b, False)):
        got, rep, b = paged_run(model, traffic, config, compile)
        rep["profile"] = paged_profile(b)
        del b                      # the graph, its memory pool, the pages
        torch.cuda.empty_cache()
        for (p, n), o in zip(traffic, got):
            if len(o) != len(p) + n or not np.array_equal(o[:len(p)], p):
                fail(f"paged run {mode} returned {len(o)} tokens for a "
                     f"prompt of {len(p)} and {n} new ones, or lost the "
                     "prompt")
        # the wrapper counts 65 a Python call of the model (a prefill, a
        # chunk, an eager step, a graph's warm-up and its capture); each
        # replay launches its graph's 65 again, and a capture launches
        # nothing
        graphs = rep["graphs"]
        (step_c, step_r), (chunk_c, chunk_r) = (
            graphs.get(g, (0, 0)) for g in ("step", "chunk"))
        expect = dict.fromkeys(KERNELS, 0)
        expect["rms_norm"] = norms * (rep["prefill_calls"] + (
            2 * step_c if compile else rep["steps"]))
        rep["launches"] = dict(rep["wrapper_counts"])
        rep["launches"]["rms_norm"] += norms * (step_r - step_c
                                                + chunk_r - chunk_c)
        # the prefills and chunks the batcher ran (graphed: chunk replays)
        rep["prefill_runs"] = rep["prefill_calls"] - 2 * chunk_c + chunk_r
        emit({"phase": "paged", "run": name, "mode": mode, "layers": layers,
              "requests": len(traffic), **rep})
        if rep["admissions"] < len(traffic):
            fail(f"paged run {mode} admitted {rep['admissions']} of "
                 f"{len(traffic)}")
        chunked = compile and config.get("prefill_chunk")
        if rep["wrapper_counts"] != expect or (compile and (
                step_c != 1 or step_r != rep["steps"]
                or chunk_c != (1 if chunked else 0))):
            fail(f"paged run {mode} launch counts {rep['wrapper_counts']} "
                 f"(graphs {graphs}, {rep['steps']} steps), expected "
                 f"{expect}, one decode step capture and "
                 f"{int(bool(chunked))} chunk capture")
        if rep["pages_leaked"] != 0:
            fail(f"paged run {mode} leaked {rep['pages_leaked']} pages")
        if mode == "B graphed" and (rep["preemptions"] < 1
                                    or rep["prefix_hit_tokens"] <= 0):
            fail(f"paged run {mode}: {rep['preemptions']} preemptions and "
                 f"{rep['prefix_hit_tokens']} prefix hit tokens, expected "
                 "at least one of each")
        prof = rep["profile"]
        for part in ("admissions", "steps"):
            rms_vector_only(prof[part], f"paged run {mode} {part}",
                            ["rms_norm_fwd_vec"])
            if prof[part]["flash_fwd_kernels"]:
                fail(f"paged run {mode} {part} ran a flash forward")
        outs[mode], counts[mode], reps[mode] = got, rep["launches"], rep
    if any(not np.array_equal(a, g)
           for a, g in zip(outs["A eager"], outs["A graphed"])):
        fail("the graphed paged decode step and chunk gave other tokens "
             "than the eager ones")
    if reps["A graphed"]["prefill_runs"] != reps["A eager"]["prefill_runs"]:
        fail(f"Run A graphed replayed {reps['A graphed']['prefill_runs']} "
             f"chunks, eager ran {reps['A eager']['prefill_runs']}")

    # generate_paged at the serve phase's shape, beside generate
    ids = torch.randint(0, cfg.vocab_size, (4, 512),
                        generator=torch.Generator().manual_seed(seed + 1)
                        ).cuda()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paged_ids = model.generate_paged(ids, 32, block_size=64)
    torch.cuda.synchronize()
    paged_s = time.perf_counter() - t0
    gen_launches = launch_counts()
    expect = dict.fromkeys(KERNELS, 0)
    expect["rms_norm"] = norms * 32
    if gen_launches != expect:
        fail(f"generate_paged launch counts {gen_launches}, expected "
             f"{expect}")
    dense_ids = model.generate(ids, 32)
    if tuple(paged_ids.shape) != (4, 544) or not torch.equal(
            paged_ids[:, :512], ids):
        fail(f"generate_paged returned {tuple(paged_ids.shape)} or lost "
             "the prompt")
    counts["generate_paged"] = gen_launches

    # the RMSNorm forward against its plain version at every prefill shape
    # the runs gave it (64-token chunks, the ladder's rungs and what the
    # capacity clamps them to, generate_paged's prompt)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = sorted({sh for r in reps.values() for sh in r["prefill_shapes"]}
                    | {tuple(ids.shape)})
    for sh in shapes:
        rms_case(gen, torch.bfloat16, (*sh, cfg.hidden_size))

    # Run B's rows for the full-forward check: 4 that missed the cache and
    # the first 4 whose admission hit it
    hit_rows = reps["B graphed"]["prefix_hit_rows"]
    hit = [i for i, h in enumerate(hit_rows) if h[0] > 0][:4]
    if len(hit) < 4:
        fail(f"Run B: fewer than 4 requests hit the prefix cache at "
             f"admission: {hit_rows}")
    b_check = [i for i, h in enumerate(hit_rows) if h[0] == 0][:4] + hit

    # the tokens against a float32 copy of the model
    ref = LlamaForCausalLM(llama2_7b_config(), device="cuda")
    ref.load_state_dict(model.state_dict())
    spread, _, spread_rows = bf16_spread(
        model, ref, outs["A eager"][:4], [len(p) for p, _ in traffic_a[:4]])
    _, b_gap, b_rows = bf16_spread(
        model, ref, [outs["B graphed"][i] for i in b_check],
        [len(traffic_b[i][0]) for i in b_check])
    for i, r in zip(b_check, b_rows):
        r.update(request=i, prefix_hit_rows=hit_rows[i])
    vs_dense = divergence(ref, [(len(p), a, d) for (p, _), a, d in zip(
        traffic_a, outs["A eager"], dense_tokens)])
    vs_plain = divergence(ref, [(len(p), g, e) for (p, _), g, e in zip(
        traffic_b, outs["B graphed"], outs["B plain"])])
    vs_generate = divergence(ref, [(512, a, d) for a, d in zip(
        paged_ids.cpu().numpy(), dense_ids.cpu().numpy())])
    del ref
    torch.cuda.empty_cache()
    rec = {"phase": "paged", "check": "tokens",
           "graphed_equals_eager": True, "bf16_spread": spread,
           "bf16_spread_requests": spread_rows,
           "run_b_full_forward": b_gap, "run_b_requests": b_rows,
           "run_a_vs_dense": {"differing_tokens": vs_dense[0],
                              "tokens": sum(n for _, n in traffic_a),
                              "first_differences": vs_dense[1]},
           "run_b_vs_plain": {"differing_tokens": vs_plain[0],
                              "tokens": sum(n for _, n in traffic_b),
                              "first_differences": vs_plain[1]},
           "rms_norm_prefill_shapes": [list(sh) for sh in shapes],
           "generate_paged_vs_generate": {
               "differing_tokens": vs_generate[0], "tokens": 4 * 32,
               "first_differences": vs_generate[1]},
           "generate_paged_s": paged_s}
    emit(rec)
    if b_gap > spread:
        fail(f"Run B's tokens lie further below their full forward's top "
             f"logit than the bf16 spread {spread}: {b_rows}")
    over = [r for r in vs_dense[1] + vs_plain[1] + vs_generate[1]
            if r["gap"] > spread]
    if over:
        fail(f"paged and dense picks, or prefix-cache and plain ones, "
             f"differ by more than the bf16 spread {spread}: {over}")
    return counts, spread, outs["A graphed"]


def fused_profile(b, prompt=512, short=64, new=64):
    """Fill all slots but one with `short`-token prompts (one chunk each),
    then admit a `prompt`-token one into the last: time half of its fused
    steps (7 decoders and a chunk each) and profile the other half, then
    time the fused step's parts (paged_step_split with the chunk)."""
    rng = np.random.RandomState(0)
    vocab = b.model.config.vocab_size
    live = [b.submit(rng.randint(0, vocab, short), new)
            for _ in range(b.max_batch - 1)]
    for _ in range(b.max_batch - 1):
        b.step()
    live.append(b.submit(rng.randint(0, vocab, prompt), new))
    half = prompt // b.prefill_chunk // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(half):
        b.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / half
    steps = profile_one(b.step, calls=half)
    split = paged_step_split(b, chunk=b.prefill_chunk,
                             chunk_at=prompt - b.prefill_chunk)
    for rid in live:
        b.abort(rid)
    b.audit_pages()
    device_ms = (steps["device_ms"] / half if steps["device_ms"] !=
                 "not measured" else "not measured")
    if device_ms != "not measured":
        split["other"] = device_ms - sum(split.values())
    return {"fused_steps": steps, "fused_step_wall_ms": wall_ms,
            "fused_step_device_ms": device_ms, "fused_step_split_ms": split,
            "device_idle_share": (1 - device_ms / wall_ms
                                  if device_ms != "not measured"
                                  else "not measured")}


def phase_fused(seed, model, spread, run_a):
    """The paged batcher's fused admission and K-step decode blocks at
    Llama-2-7B width (bf16, 32 layers, random weights from --seed), all
    graphed: Run A's traffic through FUSED (one 64-token chunk a step
    inside the decode step's call), then with decode_block=8, then with
    FUSED_SMALL_PAGES pages. Checks: every request completes at its full
    length; each run captures the fused step once (and the block once);
    the block run runs blocks and gives the per-step run's tokens exactly;
    the small pool aborts an admission; no page leaks; the RMSNorm wrapper
    and to_static's replays count 65 launches a fused step, decode step
    and block sub-step and nothing else launches; the profile of 4 fused
    steps (7 decoders and a chunk) shows the RMSNorm vector build only and
    no flash kernel; the RMSNorm forward against its plain version at the
    fused step's rows. Where the fused tokens leave Run A graphed's
    (`run_a`), or the small pool's leave the fused run's, the two picks lie
    within the paged phase's bf16 spread (`spread`) against a float32 copy.
    Returns each run's launches (the replays' included)."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    from paddle_tpu_torch.ops.hopper import KERNELS
    cfg = model.config
    layers = cfg.num_hidden_layers
    norms = 2 * layers + 1
    traffic = batcher_traffic(seed, cfg.vocab_size)
    k_block = 8                   # benchmarks/bench_decode.py:207
    outs, counts, reps = {}, {}, {}
    for mode, config in (
            ("fused", FUSED),
            ("fused block", dict(FUSED, decode_block=k_block)),
            ("fused small", dict(FUSED, n_pages=FUSED_SMALL_PAGES))):
        got, rep, b = paged_run(model, traffic, config, True)
        if mode == "fused":
            rep["profile"] = fused_profile(b)
        del b
        torch.cuda.empty_cache()
        for (p, n), o in zip(traffic, got):
            if len(o) != len(p) + n or not np.array_equal(o[:len(p)], p):
                fail(f"{mode} run returned {len(o)} tokens for a prompt of "
                     f"{len(p)} and {n} new ones, or lost the prompt")
        k = config.get("decode_block") or 0
        graphs = rep["graphs"]
        (step_c, step_r), (fused_c, fused_r), (block_c, block_r) = (
            graphs.get(g, (0, 0)) for g in ("step", "fused", "block"))
        # as in the paged phase: 65 a Python call of a step (a block's
        # call: 65 a sub-step), 65 a replay, a capture launches nothing
        expect = dict.fromkeys(KERNELS, 0)
        expect["rms_norm"] = norms * 2 * (step_c + fused_c + k * block_c)
        rep["launches"] = dict(rep["wrapper_counts"])
        rep["launches"]["rms_norm"] += norms * (
            step_r - step_c + fused_r - fused_c + k * (block_r - block_c))
        rep["fused_steps"], rep["decode_steps"] = fused_r, step_r
        rep["decode_blocks"] = rep["stats"]["decode_blocks"]
        emit({"phase": "fused", "mode": mode, "layers": layers,
              "requests": len(traffic), **rep})
        if rep["admissions"] < len(traffic):
            fail(f"{mode} run admitted {rep['admissions']} of "
                 f"{len(traffic)}")
        if rep["wrapper_counts"] != expect or rep["prefill_calls"] or (
                fused_c, step_c, block_c) != (1, 1, int(k > 0)) or \
                step_r + fused_r + k * block_r != rep["steps"]:
            fail(f"{mode} run launch counts {rep['wrapper_counts']} (graphs "
                 f"{graphs}, {rep['prefill_calls']} prefill calls, "
                 f"{rep['steps']} steps), expected {expect}, one capture "
                 "each and every step a replay")
        if k and not 0 < block_r == rep["decode_blocks"]:
            fail(f"{mode} run: {rep['decode_blocks']} decode blocks, "
                 f"{block_r} block replays")
        if rep["pages_leaked"] != 0:
            fail(f"{mode} run leaked {rep['pages_leaked']} pages")
        if mode == "fused small" and rep["aborted_admissions"] < 1:
            fail(f"{mode} run ({FUSED_SMALL_PAGES} pages) aborted no "
                 "admission")
        if mode == "fused":
            prof = rep["profile"]["fused_steps"]
            rms_vector_only(prof, f"{mode} steps", ["rms_norm_fwd_vec"])
            if prof["flash_fwd_kernels"]:
                fail(f"{mode} steps ran a flash forward")
        outs[mode], counts[mode], reps[mode] = got, rep["launches"], rep
    if any(not np.array_equal(a, g)
           for a, g in zip(outs["fused"], outs["fused block"])):
        fail("the decode blocks gave other tokens than the per-step fused "
             "run")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, rrec = rms_case(gen, torch.bfloat16, (FUSED_ROWS, cfg.hidden_size))

    ref = LlamaForCausalLM(llama2_7b_config(), device="cuda")
    ref.load_state_dict(model.state_dict())
    vs_a = divergence(ref, [(len(p), f, a) for (p, _), f, a in zip(
        traffic, outs["fused"], run_a)])
    vs_small = divergence(ref, [(len(p), f, s) for (p, _), f, s in zip(
        traffic, outs["fused"], outs["fused small"])])
    del ref
    torch.cuda.empty_cache()
    tokens = sum(n for _, n in traffic)
    rec = {"phase": "fused", "check": "tokens", "block_equals_per_step": True,
           "bf16_spread": spread,
           "fused_vs_run_a_graphed": {"differing_tokens": vs_a[0],
                                      "tokens": tokens,
                                      "first_differences": vs_a[1]},
           "small_pool_vs_fused": {"differing_tokens": vs_small[0],
                                   "tokens": tokens,
                                   "first_differences": vs_small[1]},
           "rms_norm_fused_rows": rrec}
    emit(rec)
    over = [r for r in vs_a[1] + vs_small[1] if r["gap"] > spread]
    if over:
        fail(f"fused and per-step picks, or small-pool and fused ones, "
             f"differ by more than the bf16 spread {spread}: {over}")
    return counts


# -- phase 4e ----------------------------------------------------------------

# benchmarks/bench_decode.py:84-96's TPU configuration (GPT-2 124M-class at
# vocab 32000), served in bf16 (the bench leaves the config's float32):
# batch 8, 256-token context, s_max 512, 32 new tokens
GPT2_SERVE_CFG = dict(vocab_size=32000, hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, max_position_embeddings=1024,
                      dropout=0.0, dtype="bfloat16")
GPT2_BATCH, GPT2_CTX, GPT2_S_MAX, GPT2_NEW = 8, 256, 512, 32
# bench_decode.py:173-188's drive: one warm-up request of the context's
# length and 8 new tokens, the counters reset, then these prompt lengths
# (ctx - 17, ctx, ctx + 13, ctx - 5, ctx + 29, ctx), 32 new tokens each,
# all submitted up front
GPT2_REQ_LENS = [GPT2_CTX - 17, GPT2_CTX, GPT2_CTX + 13, GPT2_CTX - 5,
                 GPT2_CTX + 29, GPT2_CTX]
# the batchers of bench_decode.py:190-211 at its 8 slots and s_max 512
GPT2_DENSE = dict(max_batch=GPT2_BATCH, s_max=GPT2_S_MAX)
GPT2_PAGED = dict(GPT2_DENSE, block_size=64, prefill_chunk=64,
                  policy="ondemand")
GPT2_FUSED = dict(GPT2_PAGED, fused_admission=True)


def gpt2_serving_model(seed):
    """bench_decode's GPT-2 in bf16, its weights from a generator on the
    card seeded with `seed`, in eval mode."""
    from paddle_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    return GPT2ForCausalLM(GPT2Config(**GPT2_SERVE_CFG), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed), seed=seed).eval()


def gpt2_traffic(seed, vocab):
    """The warm-up prompt and the 6 measured prompts, drawn from `seed`."""
    rng = np.random.RandomState(seed)
    warm = rng.randint(0, vocab, GPT2_CTX).astype(np.int64)
    return warm, [rng.randint(0, vocab, n).astype(np.int64)
                  for n in GPT2_REQ_LENS]


GPT2_WINDOWS = 3            # measured windows a run (the median reported)


def gpt2_drive(model, config, compile, traffic, paged):
    """bench_decode.py's drive through a new batcher: the warm-up request
    (its captures land there), then GPT2_WINDOWS measured windows, each
    with the counters, the registry and the launch counters set to 0 just
    before, the 6 requests submitted up front and run to the end. Returns
    (the first window's full sequences, the run's report: the median
    window's figures, every window's tokens/s, and the launches of the
    first window)."""
    from paddle_tpu_torch.inference import (ContinuousBatcher,
                                            PagedContinuousBatcher)
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops.hopper import launch_counts, reset_launch_counts
    reg = get_registry()
    warm, prompts = traffic
    engine = "paged" if paged else "dense"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cls = PagedContinuousBatcher if paged else ContinuousBatcher
    b = cls(model, compile=compile, **config)
    # the pool's gauges as the constructor set them (the windows reset the
    # registry)
    gauges = ({"kv_quant_enabled": reg.get("serving.kv_quant_enabled").value,
               "kv_quant_bytes_saved":
                   reg.get("serving.kv_quant_bytes_saved").value,
               "pool_bytes": sum(t.numel() * t.element_size()
                                 for layer in b._state["layers"]
                                 for t in layer),
               "pool_dtype": str(b._state["layers"][0][0].dtype)}
              if paged else {})
    b.submit(warm, 8)
    b.run_until_done()
    fns = {name: getattr(b, f"_{name}_fn", None)
           for name in ("step", "chunk", "fused", "block", "chunk_dyn_first",
                        "chunk_dyn_rest")}
    fns = {k: f for k, f in fns.items() if hasattr(f, "replays")}
    before = {k: (f.captures, f.replays) for k, f in fns.items()}

    def series(name):
        return reg.get(name).labels(engine=engine)

    windows, seqs = [], []
    for w in range(GPT2_WINDOWS):
        torch.cuda.synchronize()
        b.reset_stats()
        reg.reset()
        reset_launch_counts()
        t0 = time.perf_counter()
        rids = [b.submit(p, GPT2_NEW) for p in prompts]
        outs = b.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = b.stats()
        seqs.append([outs[r] for r in rids])
        windows.append({
            "wall_s": wall,
            # bench_decode's figures: the batcher's own tokens/s and slot
            # utilization over the measured window
            "tokens_per_s": stats["tokens_per_sec"],
            "tokens_per_s_wall": stats["generated_tokens"] / wall,
            "slot_utilization": stats["slot_utilization"],
            "steps": stats["steps"], "tokens": stats["generated_tokens"],
            "completed_requests": stats["completed_requests"],
            "decode_blocks": stats["decode_blocks"],
            "preemptions": stats["preemptions"],
            "cachekv_clip_rate": stats["cachekv_clip_rate"],
            "admissions": series("serving_admissions_total").value,
            "step_ms_median":
                series("serving_step_seconds").quantile(0.5) * 1e3,
            "ttft_ms_median":
                series("serving_ttft_seconds").quantile(0.5) * 1e3,
            "ttft_ms_max": series("serving_ttft_seconds").quantile(1.0)
            * 1e3,
            "launches": launch_counts()})
    order = sorted(range(GPT2_WINDOWS),
                   key=lambda i: windows[i]["tokens_per_s"])
    report = {"compile": compile, **config,
              **windows[order[GPT2_WINDOWS // 2]],
              "launches": windows[0]["launches"],
              "windows_tokens_per_s": [w["tokens_per_s"] for w in windows],
              "windows_equal_tokens": all(
                  all(np.array_equal(a, c) for a, c in zip(seqs[0], o))
                  for o in seqs[1:]),
              "windows_launches_equal": all(
                  w["launches"] == windows[0]["launches"] for w in windows),
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              # per captured function: [captures, replays] over the
              # batcher's life, and in the measured windows
              "graphs": {k: [f.captures, f.replays] for k, f in fns.items()},
              "window_replays": {k: f.replays - before[k][1]
                                 for k, f in fns.items()},
              # a window's fused steps and blocks, one replay each
              "replays_per_window": {
                  k: (f.replays - before[k][1]) / GPT2_WINDOWS
                  for k, f in fns.items()},
              "window_captures": {k: f.captures - before[k][0]
                                  for k, f in fns.items()},
              **gauges}
    if paged:
        report["pages_leaked"] = reg.get("serving.pages_leaked").value
        report["audit_pages"] = b.audit_pages()
    return seqs[0], report, b


def gpt2_generate_checks(model, seed, phase="gpt2_serve"):
    """generate at bench_decode's shape (8 x 256 prompt tokens, s_max 512,
    32 greedy new tokens) with the launch counts around it, its prefill
    and eager decode timed, then bench_decode's compiled decode step:
    to_static(decode_step, donate_args=(1,)), 4 warm and 32 timed steps,
    its tokens equal to the eager step's from the same prefill. Its record
    carries `phase`."""
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.ops.hopper import (KERNELS, launch_counts,
                                             reset_launch_counts)
    cfg = model.config
    layers = cfg.num_hidden_layers
    ids = torch.randint(0, cfg.vocab_size, (GPT2_BATCH, GPT2_CTX),
                        generator=torch.Generator().manual_seed(seed + 1)
                        ).cuda()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, GPT2_NEW, s_max=GPT2_S_MAX)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = launch_counts()
    expect = dict.fromkeys(KERNELS, 0)
    expect["flash_attention"] = layers
    if launches != expect:
        fail(f"gpt2 generate launch counts {launches}, expected {expect}")
    if tuple(out.shape) != (GPT2_BATCH, GPT2_CTX + GPT2_NEW) or \
            not torch.equal(out[:, :GPT2_CTX], ids) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail(f"gpt2 generate returned {tuple(out.shape)}, lost the prompt "
             "or left the vocabulary")
    with torch.no_grad():
        prefill_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches, t = model.prefill(ids, GPT2_S_MAX)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        tok0 = logits[:, -1].argmax(-1, keepdim=True)
        # eager decode: 36 steps (the graphed run's 4 warm and 32 timed),
        # the tokens kept
        eager_caches, eager_t = caches.clone(), t.clone()
        tok, eager_toks = tok0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(36):
            lg, eager_caches, eager_t = model.decode_step(tok, eager_caches,
                                                          eager_t)
            tok = lg[:, -1].argmax(-1, keepdim=True)
            eager_toks.append(tok)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / 36
        # bench_decode's kv_cache_compiled_tokens_per_s
        step = to_static(model.decode_step, donate_args=(1,))
        tok, graph_toks = tok0, []
        for i in range(36):
            if i == 4:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            lg, caches, t = step(tok, caches, t)
            tok = lg[:, -1].argmax(-1, keepdim=True)
            graph_toks.append(tok)
        torch.cuda.synchronize()
        graphed_s = time.perf_counter() - t0
        graph = [step.captures, step.replays]
    same = all(torch.equal(a, g) for a, g in zip(eager_toks, graph_toks))
    rec = {"phase": phase, "part": "generate", "batch": GPT2_BATCH,
           "prompt": GPT2_CTX, "new_tokens": GPT2_NEW, "s_max": GPT2_S_MAX,
           "layers": layers, "dtype": "bfloat16", "generate_s": generate_s,
           "launches": launches, "prefill_ms": sorted(prefill_ms)[1],
           "eager_decode_ms_per_step": eager_ms,
           "eager_decode_tokens_per_s": GPT2_BATCH * 1e3 / eager_ms,
           "graphed_decode_ms_per_step": graphed_s * 1e3 / 32,
           "kv_cache_compiled_steps_per_s": 32 / graphed_s,
           "kv_cache_compiled_tokens_per_s": GPT2_BATCH * 32 / graphed_s,
           "graph": graph,
           "graphed_equals_eager": same}
    emit(rec)
    if graph != [1, 36]:
        fail(f"gpt2 compiled decode step: [captures, replays] {graph}, "
             "expected one capture and 36 replays")
    if not same:
        fail("gpt2: the graphed decode step gave other tokens than the "
             "eager one")
    # no profiler session before the timings above (PERF.md: one may slow
    # what runs after it); the profiles come last in the phase
    return launches, {"ids": ids, "step": step, "tok": tok,
                      "caches": caches, "t": t, "timed": rec}


def gpt2_generate_profiles(model, held):
    """The device time of generate's prefill, an eager decode step and a
    replay of the captured one, and their idle shares against the timings
    gpt2_generate_checks took before any profile."""
    ids, step, tok, caches, t = (held[k] for k in ("ids", "step", "tok",
                                                   "caches", "t"))
    timed = held["timed"]
    with torch.no_grad():
        out = {"prefill": profile_one(lambda: model.prefill(ids,
                                                            GPT2_S_MAX)),
               "eager_step": profile_one(lambda: model.decode_step(
                   tok, caches.clone(), t)),
               "replay": profile_one(lambda: step(tok, caches, t))}
    idle = {}
    for part, wall in (("prefill", timed["prefill_ms"]),
                       ("eager_step", timed["eager_decode_ms_per_step"]),
                       ("replay", timed["graphed_decode_ms_per_step"])):
        dev = out[part]["device_ms"]
        idle[part] = ("not measured" if dev == "not measured"
                      else 1 - dev / wall)
    emit({"phase": "gpt2_serve", "profile": "generate",
          "device_ms": {k: v["device_ms"] for k, v in out.items()},
          "idle_share": idle, **out})
    return out["prefill"]


def phase_gpt2_serve(seed):
    """bench_decode.py's serving cell on the port: GPT-2 124M-class (vocab
    32000, 12 layers, 12 heads x 64; bf16, random weights from --seed,
    eval mode), nothing cut. generate (8 x 256, 32 new) and the compiled
    decode step (gpt2_generate_checks); then bench_decode's traffic
    (gpt2_drive, 3 measured windows a run) through the dense
    ContinuousBatcher (8 slots, s_max 512, the pow2 ladder) eager and
    graphed, then the PagedContinuousBatcher (block 64, 64-token chunks, on
    demand) graphed, per step with fused admission, and with fused
    admission and decode_block=8; then the profiles. Checks: every run
    completes its 6 requests at full length, each window the same tokens;
    one capture of each captured function a run (in the warm-up), every
    measured dense step a replay; the dense runs launch the flash forward
    12 times an admission, the paged runs no kernel (their attention is
    plain); the graphed dense tokens equal the eager ones and the fused
    block run's equal the fused run's; where the paged or fused tokens
    leave the dense run's, the two picks lie within twice the run's bf16
    spread against a float32 copy (bf16_spread over the 6 requests: each
    bf16 path's pick lies within the spread of the float32 top); no page
    leaks, the audit clean; the prefill profiles show the bf16 tensor-core
    forward at d 64 without dropout and no other attention kernel; the
    model's dropout generators untouched; no dense-route warning. Reports
    bench_decode's figures (kv_cache_compiled_tokens_per_s,
    batcher_tokens_per_s, fused_batcher_tokens_per_s and the fused run's
    slot utilization) and the device ms by part of a graphed paged step and
    a fused step. Returns the launch counts of generate and of the dense
    runs."""
    import warnings
    from paddle_tpu_torch.inference import PagedContinuousBatcher
    from paddle_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    from paddle_tpu_torch.nn import functional as port_F
    from paddle_tpu_torch.ops.hopper import KERNELS
    t_phase = time.perf_counter()
    dense_routes = set(port_F._DENSE_ROUTE_SEEN)
    model = gpt2_serving_model(seed)
    cfg = model.config
    layers = cfg.num_hidden_layers
    seeds0 = model.attention_seeds.get_state()
    drops0 = model.dropout_generator.get_state()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gen_launches, held = gpt2_generate_checks(model, seed)
        traffic = gpt2_traffic(seed, cfg.vocab_size)
        outs, reps, counts = {}, {}, {"generate": gen_launches}
        # each run's captured functions that must be captured once (in
        # the warm-up); any other is captured at most once
        for mode, config, compile, paged, captured in (
                ("dense eager", GPT2_DENSE, False, False, ()),
                ("dense graphed", GPT2_DENSE, True, False, ("step",)),
                ("paged graphed", GPT2_PAGED, True, True,
                 ("step", "chunk")),
                ("fused", GPT2_FUSED, True, True, ("step", "fused")),
                ("fused block", dict(GPT2_FUSED, decode_block=8), True,
                 True, ("fused", "block"))):
            got, rep, b = gpt2_drive(model, config, compile, traffic, paged)
            del b
            torch.cuda.empty_cache()
            emit({"phase": "gpt2_serve", "run": mode, "layers": layers,
                  "requests": len(GPT2_REQ_LENS), **rep})
            for p, o in zip(traffic[1], got):
                if len(o) != len(p) + GPT2_NEW or \
                        not np.array_equal(o[:len(p)], p):
                    fail(f"gpt2 {mode} returned {len(o)} tokens for a "
                         f"prompt of {len(p)}, or lost the prompt")
            if rep["completed_requests"] != len(GPT2_REQ_LENS) or not \
                    rep["windows_equal_tokens"] or \
                    not rep["windows_launches_equal"]:
                fail(f"gpt2 {mode} completed {rep['completed_requests']} "
                     f"of {len(GPT2_REQ_LENS)} requests, or its windows "
                     "gave other tokens or launches than its first")
            expect = dict.fromkeys(KERNELS, 0)
            if not paged:
                expect["flash_attention"] = layers * rep["admissions"]
            if rep["launches"] != expect:
                fail(f"gpt2 {mode} launch counts {rep['launches']}, "
                     f"expected {expect}")
            graphs = rep["graphs"]
            if any(graphs.get(k, [0])[0] != 1 for k in captured) or any(
                    v[0] > 1 for v in graphs.values()) or any(
                    rep["window_captures"].values()):
                fail(f"gpt2 {mode}: graphs {graphs}, expected one capture "
                     f"of each of {captured}, in the warm-up")
            if compile and not paged and rep["window_replays"]["step"] \
                    != GPT2_WINDOWS * rep["steps"]:
                fail(f"gpt2 {mode}: {rep['window_replays']} replays of "
                     f"{GPT2_WINDOWS} x {rep['steps']} steps")
            if paged and (rep["pages_leaked"] or rep["audit_pages"]):
                fail(f"gpt2 {mode} leaked pages: {rep['pages_leaked']}, "
                     f"audit {rep['audit_pages']}")
            if mode == "fused block" and not rep["decode_blocks"]:
                fail("gpt2 fused block run ran no decode block")
            outs[mode], reps[mode] = got, rep
            if not paged:
                counts[mode] = rep["launches"]
        # the profiles, after every timing: generate's; 4 admissions at
        # the 256 rung; a graphed paged step and a fused step (each
        # batcher warmed, so its graphs are captured, then profiled); then
        # the fused block run once more, to see whether the sessions slow
        # what follows them
        prefill_profile = gpt2_generate_profiles(model, held)
        del held
        admission_profile = profile_one(lambda: [model.prefill(
            torch.from_numpy(np.resize(p, GPT2_CTX)[None]).cuda(),
            GPT2_S_MAX) for p in traffic[1][:4]])
        profiles = {}
        for mode, config, prof in (
                ("paged graphed", GPT2_PAGED,
                 lambda b: paged_profile(b, prompt=GPT2_CTX, new=64)),
                ("fused", GPT2_FUSED,
                 lambda b: fused_profile(b, prompt=GPT2_CTX, short=64,
                                         new=64))):
            b = PagedContinuousBatcher(model, compile=True, **config)
            b.submit(traffic[0], 8)
            b.run_until_done()
            profiles[mode] = prof(b)
            emit({"phase": "gpt2_serve", "profile": mode, **profiles[mode]})
            del b
            torch.cuda.empty_cache()
        _, after, b = gpt2_drive(model, dict(GPT2_FUSED, decode_block=8),
                                 True, traffic, True)
        del b
        torch.cuda.empty_cache()
    routes = [str(w.message) for w in caught
              if "dense attention instead" in str(w.message)]
    if routes or port_F._DENSE_ROUTE_SEEN != dense_routes:
        fail(f"gpt2 serving took the dense attention route: {routes}, "
             f"{port_F._DENSE_ROUTE_SEEN - dense_routes}")
    if not (torch.equal(model.attention_seeds.get_state(), seeds0)
            and torch.equal(model.dropout_generator.get_state(), drops0)):
        fail("gpt2 serving advanced the model's dropout generators")
    for what, prof in (("generate prefill", prefill_profile),
                       ("dense admissions", admission_profile)):
        builds = prof["flash_builds"]
        if prof["flash_fwd_kernels"] != ["flash_fwd_wgmma"] or \
                prof["flash_bwd_kernels"] or not builds or \
                not all(b.startswith("flash_fwd_wgmma<64,")
                        and not dropout_build(b) for b in builds):
            fail(f"gpt2 {what} attention builds {builds}, expected the "
                 "bf16 wgmma forward at d 64 without dropout only")
    for mode, prof in profiles.items():
        for part in ("admissions", "steps", "fused_steps"):
            if part in prof and prof[part]["flash_fwd_kernels"]:
                fail(f"gpt2 {mode} {part} ran a flash forward")

    # the tokens: graphed dense equal eager dense; the fused block run
    # equals the fused run; the paged and fused runs against the dense
    # one within the model's own bf16 spread
    if any(not np.array_equal(a, g) for a, g in
           zip(outs["dense eager"], outs["dense graphed"])):
        fail("gpt2: the graphed dense batcher gave other tokens than the "
             "eager one")
    if any(not np.array_equal(a, g) for a, g in
           zip(outs["fused"], outs["fused block"])):
        fail("gpt2: the decode blocks gave other tokens than the per-step "
             "fused run")
    ref = GPT2ForCausalLM(GPT2Config(**dict(GPT2_SERVE_CFG,
                                            dtype="float32")),
                          device="cuda").eval()
    ref.load_state_dict(model.state_dict())
    lens = [len(p) for p in traffic[1]]
    spread, own_gap, spread_rows = bf16_spread(
        model, ref, outs["dense eager"], lens)
    checks = {}
    for mode in ("paged graphed", "fused"):
        diff = divergence(ref, [(n, d, o) for n, d, o in zip(
            lens, outs["dense eager"], outs[mode])])
        checks[mode] = {"differing_tokens": diff[0],
                        "tokens": GPT2_NEW * len(lens),
                        "first_differences": diff[1]}
    del ref
    torch.cuda.empty_cache()
    fused_wins = (reps["fused"]["tokens_per_s"]
                  > reps["paged graphed"]["tokens_per_s"])
    rec = {"phase": "gpt2_serve", "check": "tokens",
           "graphed_equals_eager": True, "block_equals_per_step": True,
           "bf16_spread": spread, "pick_gap_limit": 2 * spread,
           "dense_own_full_forward_gap": own_gap,
           "bf16_spread_requests": spread_rows,
           "vs_dense_eager": checks,
           "bench_decode": {
               "batcher_tokens_per_s": reps["paged graphed"]["tokens_per_s"],
               "batcher_slot_utilization":
                   reps["paged graphed"]["slot_utilization"],
               "fused_batcher_tokens_per_s": reps["fused"]["tokens_per_s"],
               "fused_batcher_slot_utilization":
                   reps["fused"]["slot_utilization"],
               "fused_block_tokens_per_s":
                   reps["fused block"]["tokens_per_s"],
               "paged_serving_decode_tokens_per_sec":
                   reps["fused block"]["tokens_per_s"],
               "dense_graphed_tokens_per_s":
                   reps["dense graphed"]["tokens_per_s"]},
           "fused_beats_graphed_paged": fused_wins,
           "fused_block_after_profiles_tokens_per_s":
               after["windows_tokens_per_s"],
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    # each of two bf16 paths picks within the spread of the float32 top,
    # so two picks that differ lie within twice it of each other
    over = [(m, r) for m, c in checks.items()
            for r in c["first_differences"] if r["gap"] > 2 * spread]
    if over:
        fail(f"gpt2 paged or fused picks differ from the dense batcher's by "
             f"more than twice the bf16 spread {spread}: {over}")
    del model
    torch.cuda.empty_cache()
    return counts


# -- phase 4f ----------------------------------------------------------------

# benchmarks/bench_gateway.py's TPU branch (:249-267, 43-65): the GPT-2 of
# gpt2_serve (bf16 here; the bench leaves the config's float32), 2 dense
# replicas of 4 slots and s_max 512 behind one gateway, a 256-token warm-up
# request, then 12 requests of 256 + (i * 7) % 32 - 16 prompt tokens and 32
# new; every third is tenant "batch" at low priority, the rest
# "interactive" at high; session s{i % 4}
GW_REPLICAS, GW_SLOTS, GW_S_MAX = 2, 4, 512
GW_CTX, GW_REQUESTS, GW_NEW = 256, 12, 32
GW_POLICIES = ("least_loaded", "affinity", "weighted_rr")
GW_WINDOWS = 3              # measured windows a policy (the median reported)
GW_DENSE = dict(max_batch=GW_SLOTS, s_max=GW_S_MAX)
# the failover run: r1 dies at its 9th step with work (its requests then
# hold ~9 delivered tokens each and resume on r0 from prompt + delivered)
GW_KILL_AFTER = 8
# the shared-prefix workload (bench_gateway.py:136-230, TPU sizing): 4
# system prompts of 128 tokens, 24 requests with tails of 16-48 tokens and
# 12 new, over 2 paged replicas under the affinity policy
GW_SYS, GW_SYS_LEN, GW_SHARED_REQ, GW_TAILS, GW_SHARED_NEW = \
    4, 128, 24, (16, 48), 12
GW_PAGED = dict(max_batch=4, s_max=512, block_size=16, n_pages=160,
                policy="ondemand", prompt_buckets="pow2")


def gw_traffic(seed, vocab):
    """The warm-up prompt and the 12 requests (prompt, tenant, priority,
    session), drawn from `seed`; every policy gets the same ones."""
    rng = np.random.RandomState(seed + 12)
    warm = rng.randint(0, vocab, GW_CTX).astype(np.int64)
    reqs = []
    for i in range(GW_REQUESTS):
        low = i % 3 == 2
        reqs.append((rng.randint(0, vocab, GW_CTX + (i * 7) % 32 - 16)
                     .astype(np.int64), "batch" if low else "interactive",
                     "low" if low else "high", f"s{i % 4}"))
    return warm, reqs


def gw_dense_replica(model, warm):
    """A graphed dense replica, warmed alone so its decode graph is captured
    before it joins a gateway."""
    from paddle_tpu_torch.inference import ContinuousBatcher
    b = ContinuousBatcher(model, compile=True, **GW_DENSE)
    b.submit(warm, 4)
    b.run_until_done()
    return b


def gw_quantile(xs, q):
    """bench_gateway.py's percentile: the sorted sample at int(q * n)."""
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def gw_drive(gw, submits):
    """Submit, step the gateway until its work is done, and read every
    request off the gateway's own records before popping it (registry
    histograms are process-wide; bench_gateway.py:105-126). Returns (the
    sequences in submit order, the window's figures, the requests'
    records)."""
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops.hopper import launch_counts, reset_launch_counts
    reg = get_registry()
    for rep in gw.pool.replicas():
        rep.batcher.reset_stats()
    gw.reset_stats()
    reg.reset()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gids = [submit(gw) for submit in submits]
    steps = 0
    while gw._has_work():
        gw.step()
        steps += 1
        if steps > 5000:
            fail("gateway: the work did not finish in 5000 steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = gw.stats()
    ttft, tpot, placed, seqs, records = [], [], [], [], []
    for g in gids:
        req = gw._finished.get(g)
        if req is None:
            fail(f"gateway: request {g} did not complete "
                 f"({gw._failed.get(g)!r})")
        records.append(req)
        ttft.append(req.first_token_t - req.submit_t)
        n = len(req.delivered)
        if n > 1:
            tpot.append((req.finish_t - req.first_token_t) / (n - 1))
        placed.append(req.replica)
        seqs.append(gw.pop_result(g))
    # the host's share of a tick: the window's wall less the replicas'
    # steps (gateway.replica.step_seconds), over the ticks
    rep_s = sum(reg.get("gateway.replica.step_seconds")
                .labels(replica=r.name).sum for r in gw.pool.replicas())
    return seqs, {
        "wall_s": wall, "gateway_steps": steps,
        "tokens_per_s": st["delivered_tokens"] / wall,
        "delivered_tokens": st["delivered_tokens"],
        "ttft_ms_p50": gw_quantile(ttft, 0.5) * 1e3,
        "ttft_ms_p99": gw_quantile(ttft, 0.99) * 1e3,
        "tpot_ms_p50": gw_quantile(tpot, 0.5) * 1e3 if tpot else None,
        "tpot_ms_p99": gw_quantile(tpot, 0.99) * 1e3 if tpot else None,
        "completions": st["completions"], "requeued": st["requeued"],
        "failures": st["failures"],
        "replica_completed": {r.name: r.batcher.stats()["completed_requests"]
                              for r in gw.pool.replicas()},
        "replica_steps": {r.name: r.batcher.stats()["steps"]
                          for r in gw.pool.replicas()},
        "placed": placed,
        "tick_host_ms": (wall - rep_s) * 1e3 / max(steps, 1),
        "step_ms": wall * 1e3 / max(steps, 1),
        "launches": launch_counts()}, records


def gw_routed_run(model, policy, traffic, layers):
    """One policy's gateway over two graphed dense replicas: the gateway's
    warm-up request, then GW_WINDOWS windows of the 12 requests. Checks
    each window: 12 completions and no failure, the flash forward launched
    12 times an admission and nothing else, no graph captured, every
    replica step a replay. Returns (the first window's sequences, the
    report: the median window's figures and every window's tokens/s, and
    the gateway, kept for the profile)."""
    from paddle_tpu_torch.inference import Gateway
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops.hopper import KERNELS
    warm, reqs = traffic
    gw = Gateway(policy=policy)
    for i in range(GW_REPLICAS):
        gw.add_replica(f"r{i}", gw_dense_replica(model, warm))
    gw.submit(warm, 4, tenant="warmup")
    gw.run_until_done()
    submits = [lambda g, p=p, t=t, pr=pr, s=s: g.submit(
        p, GW_NEW, tenant=t, priority=pr, session_id=s)
        for p, t, pr, s in reqs]
    windows, seqs = [], None
    for w in range(GW_WINDOWS):
        graphs0 = {r.name: (r.batcher._step_fn.captures,
                            r.batcher._step_fn.replays)
                   for r in gw.pool.replicas()}
        got, rep, _ = gw_drive(gw, submits)
        admissions = get_registry().get("serving_admissions_total") \
            .labels(engine="dense").value
        rep["admissions"] = admissions
        rep["window_captures"] = sum(
            r.batcher._step_fn.captures - graphs0[r.name][0]
            for r in gw.pool.replicas())
        rep["window_replays"] = sum(
            r.batcher._step_fn.replays - graphs0[r.name][1]
            for r in gw.pool.replicas())
        expect = dict.fromkeys(KERNELS, 0)
        expect["flash_attention"] = layers * admissions
        if rep["completions"] != GW_REQUESTS or rep["failures"] or \
                admissions != GW_REQUESTS:
            fail(f"gateway {policy} window {w}: {rep['completions']} of "
                 f"{GW_REQUESTS} completed, {rep['failures']} failed, "
                 f"{admissions} admissions")
        if rep["launches"] != expect:
            fail(f"gateway {policy} window {w}: launch counts "
                 f"{rep['launches']}, expected {expect}")
        if rep["window_captures"] or rep["window_replays"] != \
                sum(rep["replica_steps"].values()):
            fail(f"gateway {policy} window {w}: {rep['window_captures']} "
                 f"captures and {rep['window_replays']} replays for "
                 f"{rep['replica_steps']} replica steps")
        for (p, *_), o in zip(reqs, got):
            if len(o) != len(p) + GW_NEW or not np.array_equal(o[:len(p)],
                                                               p):
                fail(f"gateway {policy} returned {len(o)} tokens for a "
                     f"prompt of {len(p)}, or lost the prompt")
        if seqs is None:
            seqs = got
        elif any(not np.array_equal(a, b) for a, b in zip(seqs, got)):
            rep["other_tokens_than_window_0"] = True
        windows.append(rep)
    order = sorted(range(GW_WINDOWS),
                   key=lambda i: windows[i]["tokens_per_s"])
    report = {"policy": policy, **windows[order[GW_WINDOWS // 2]],
              "launches": windows[0]["launches"],
              "windows_tokens_per_s": [w["tokens_per_s"] for w in windows],
              "windows_equal_tokens": not any(
                  w.get("other_tokens_than_window_0") for w in windows),
              "graphs": {r.name: [r.batcher._step_fn.captures,
                                  r.batcher._step_fn.replays]
                         for r in gw.pool.replicas()}}
    return seqs, report, gw


def gw_failover(model, traffic, layers):
    """A least_loaded gateway whose replica r1 dies (chaos
    gateway.step.r1 raises at its step GW_KILL_AFTER + 1, with work in
    flight): r1 is declared dead, its requests requeue and finish on r0.
    Returns (the sequences, each request's resume point or None, the
    report)."""
    from paddle_tpu_torch.inference import Gateway
    from paddle_tpu_torch.observability.trace_context import get_recorder
    from paddle_tpu_torch.resilience import arm_scenario, disarm
    warm, reqs = traffic
    gw = Gateway(policy="least_loaded")
    for i in range(GW_REPLICAS):
        gw.add_replica(f"r{i}", gw_dense_replica(model, warm))
    submits = [lambda g, p=p, t=t, pr=pr, s=s: g.submit(
        p, GW_NEW, tenant=t, priority=pr, session_id=s)
        for p, t, pr, s in reqs]
    arm_scenario(f"seed=0; gateway.step.r1:transient_error:"
                 f"after={GW_KILL_AFTER},count=1")
    try:
        seqs, rep, records = gw_drive(gw, submits)
    finally:
        disarm()
    # each requeued request's resume point: the tokens it held when r1 died
    # (its trace's requeue event)
    resume = []
    for req in records:
        ev = [s for s in get_recorder().spans(req.trace.trace_id)
              if s.name == "requeue"] if req.trace is not None else []
        resume.append(ev[0].tags["delivered"] if ev else None)
    rep.update({"alive": {r.name: r.alive for r in gw.pool.replicas()},
                "requeued_requests": sum(r is not None for r in resume),
                "resume_points": resume})
    if rep["alive"] != {"r0": True, "r1": False}:
        fail(f"gateway failover: replicas alive {rep['alive']}, expected r1 "
             "dead")
    if rep["requeued"] < 1 or rep["completions"] != GW_REQUESTS or \
            rep["failures"] or set(rep["placed"]) != {"r0"}:
        fail(f"gateway failover: requeued {rep['requeued']}, "
             f"{rep['completions']} completions, {rep['failures']} "
             f"failures, finished on {set(rep['placed'])}")
    if rep["launches"]["flash_attention"] < layers * GW_REQUESTS:
        fail(f"gateway failover: {rep['launches']['flash_attention']} flash "
             "forwards, fewer than one prefill a request")
    del gw
    return seqs, resume, rep


def gw_shared_prefix(model, seed):
    """bench_gateway.py's shared-prefix workload on 2 paged replicas
    (graphed) under the affinity policy: the prefix cache on, then off,
    over the identical workload, the warm phase (each system prompt with
    three tails) kept out of the window; then the no-shared-prefix control,
    on and off. Checks: every request completes at its length, no page
    leaks, the cache hits when on, no kernel launch (paged attention is
    plain). Returns the report."""
    from paddle_tpu_torch.inference import Gateway, PagedContinuousBatcher
    from paddle_tpu_torch.ops.hopper import KERNELS
    vocab = model.config.vocab_size

    def build(cache_on):
        gw = Gateway(policy="affinity")
        for i in range(GW_REPLICAS):
            gw.add_replica(f"r{i}", PagedContinuousBatcher(
                model, compile=True, prefix_cache=cache_on, **GW_PAGED))
        return gw

    def cache_totals(gw):
        hit = miss = 0
        for rep in gw.pool.replicas():
            c = rep.batcher.prefix_cache
            if c is not None:
                hit += c.hit_tokens
                miss += c.miss_tokens
        return hit, miss

    def measured(gw, prompts):
        seqs, rep, _ = gw_drive(gw, [
            lambda g, p=p, i=i: g.submit(p, GW_SHARED_NEW, tenant=f"t{i % 4}")
            for i, p in enumerate(prompts)])
        for p, o in zip(prompts, seqs):
            if len(o) != len(p) + GW_SHARED_NEW:
                fail(f"gateway shared prefix returned {len(o)} tokens for a "
                     f"prompt of {len(p)}")
        audits = {r.name: r.batcher.audit_pages() for r in gw.pool.replicas()}
        if any(audits.values()) or rep["completions"] != len(prompts):
            fail(f"gateway shared prefix: audits {audits}, "
                 f"{rep['completions']} of {len(prompts)} completed")
        if rep["launches"] != dict.fromkeys(KERNELS, 0):
            fail(f"gateway shared prefix launched {rep['launches']}")
        rep["audit_pages"] = audits
        return rep

    out = {}
    for label, cache_on in (("on", True), ("off", False)):
        rng = np.random.RandomState(seed + 7)    # one workload, both runs
        sys_prompts = [rng.randint(0, vocab, GW_SYS_LEN)
                       for _ in range(GW_SYS)]
        prompts = [np.concatenate([sys_prompts[i % GW_SYS], rng.randint(
            0, vocab, int(rng.randint(*GW_TAILS)))])
            for i in range(GW_SHARED_REQ)]
        gw = build(cache_on)
        lo, hi = GW_TAILS
        for sp in sys_prompts:
            for wt in (lo, (lo + hi) // 2, hi):
                gw.submit(np.concatenate([sp, rng.randint(0, vocab, wt)]), 4,
                          tenant="warmup")
        gw.run_until_done()
        hit0, miss0 = cache_totals(gw)
        rep = measured(gw, prompts)
        hit1, miss1 = cache_totals(gw)
        rep["hit_tokens"], rep["miss_tokens"] = hit1 - hit0, miss1 - miss0
        out[label] = rep
        del gw
    if not out["on"]["hit_tokens"]:
        fail("gateway shared prefix: the cache never hit")
    control = {}
    for label, cache_on in (("on", True), ("off", False)):
        rng = np.random.RandomState(seed + 11)
        prompts = [rng.randint(0, vocab, GW_SYS_LEN + int(rng.randint(
            *GW_TAILS))) for _ in range(GW_SHARED_REQ)]
        gw = build(cache_on)
        gw.submit(rng.randint(0, vocab, GW_SYS_LEN), 4, tenant="warmup")
        gw.run_until_done()
        control[label] = measured(gw, prompts)
        del gw
    torch.cuda.empty_cache()
    on, off = out["on"], out["off"]
    return {
        "prefix_hit_rate": on["hit_tokens"] / max(
            on["hit_tokens"] + on["miss_tokens"], 1),
        "ttft_ms_p99_cache_on": on["ttft_ms_p99"],
        "ttft_ms_p99_cache_off": off["ttft_ms_p99"],
        "shared_tokens_per_s_cache_on": on["tokens_per_s"],
        "shared_tokens_per_s_cache_off": off["tokens_per_s"],
        "no_shared_tokens_per_s_cache_on": control["on"]["tokens_per_s"],
        "no_shared_tokens_per_s_cache_off": control["off"]["tokens_per_s"],
        # the trace-derived goodput figures (observability.ledger over the
        # waterfalls) are not ported yet: ROADMAP.md, queue 1, item 9
        "goodput_frac_cache_on": "absent (not ported)",
        "goodput_frac_cache_off": "absent (not ported)",
        "runs": {"cache on": on, "cache off": off,
                 "control cache on": control["on"],
                 "control cache off": control["off"]}}


def phase_gateway(seed):
    """The port's serving Gateway at bench_gateway.py's TPU configuration:
    GPT-2 124M-class (gpt2_serving_model: vocab 32000, 12 x 768, 12 heads
    of 64, bf16, eval mode) behind a gateway of 2 graphed dense
    ContinuousBatcher replicas (4 slots, s_max 512). Runs: the routed run
    under least_loaded, affinity and weighted_rr, each on a fresh gateway
    (gw_routed_run, 3 windows); a lone graphed dense batcher (4 slots) on
    the same prompts, whose tokens each policy's must equal, or, where they
    differ, part within twice the run's bf16 spread against a float32 copy
    (bf16_spread, divergence); the failover run (gw_failover), whose
    tokens are held to the lone batcher's the same way before and after
    each request's resume point; the shared-prefix workload over 2 graphed
    paged replicas (gw_shared_prefix); then one profiled window a policy,
    for a step's idle share. Reports per policy the median window's routed
    tokens/s, TTFT and TPOT p50/p99 from the gateway's request records,
    completions, requeues, each replica's completions, the host ms of a
    tick outside the replicas' steps, and the flash forward's launches.
    Returns {kernel: {run: launches}} of the dense gateway runs."""
    from paddle_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    from paddle_tpu_torch.ops.hopper import KERNELS
    t_phase = time.perf_counter()
    model = gpt2_serving_model(seed)
    cfg = model.config
    layers = cfg.num_hidden_layers
    traffic = gw_traffic(seed, cfg.vocab_size)
    warm, reqs = traffic
    prompts = [r[0] for r in reqs]
    lens = [len(p) for p in prompts]
    with torch.no_grad():
        routed, gateways = {}, {}
        for policy in GW_POLICIES:
            seqs, rep, gw = gw_routed_run(model, policy, traffic, layers)
            routed[policy] = (seqs, rep)
            gateways[policy] = gw
            emit({"phase": "gateway", "run": policy, "layers": layers,
                  "replicas": GW_REPLICAS, **rep})
        lone = gw_dense_replica(model, warm)
        rids = [lone.submit(p, GW_NEW) for p in prompts]
        outs = lone.run_until_done()
        lone_seqs = [outs[r] for r in rids]
        del lone
        fo_seqs, resume, fo_rep = gw_failover(model, traffic, layers)
        emit({"phase": "gateway", "run": "failover", **fo_rep})
        shared = gw_shared_prefix(model, seed)
        emit({"phase": "gateway", "run": "shared prefix", **shared})
        # the profiles, after every timing: one window a policy, for a
        # gateway step's device time against the median window's wall
        idle = {}
        for policy, gw in gateways.items():
            rep = routed[policy][1]
            submits = [lambda g, p=p, t=t, pr=pr, s=s: g.submit(
                p, GW_NEW, tenant=t, priority=pr, session_id=s)
                for p, t, pr, s in reqs]
            prof = profile_one(lambda: gw_drive(gw, submits))
            dev = prof["device_ms"]
            idle[policy] = {
                "window_device_ms": dev,
                "step_device_ms": (dev / rep["gateway_steps"]
                                   if dev != "not measured" else dev),
                "step_wall_ms": rep["step_ms"],
                "device_idle_share": (1 - dev / (rep["wall_s"] * 1e3)
                                      if dev != "not measured" else dev),
                "top": prof["top"][:6], "flash_builds": prof["flash_builds"]}
            if prof["flash_fwd_kernels"] != ["flash_fwd_wgmma"] or not all(
                    b.startswith("flash_fwd_wgmma<64,") and not
                    dropout_build(b) for b in prof["flash_builds"]):
                fail(f"gateway {policy}: attention builds "
                     f"{prof['flash_builds']}, expected the bf16 wgmma "
                     "forward at d 64 without dropout only")
        del gateways
        torch.cuda.empty_cache()
    # the tokens: each policy and the failover run against the lone batcher
    ref = GPT2ForCausalLM(GPT2Config(**dict(GPT2_SERVE_CFG,
                                            dtype="float32")),
                          device="cuda").eval()
    ref.load_state_dict(model.state_dict())
    spread, own_gap, _ = bf16_spread(model, ref, lone_seqs, lens)
    checks = {}
    for name, seqs in [(p, routed[p][0]) for p in GW_POLICIES] + \
            [("failover", fo_seqs)]:
        diff = divergence(ref, [(n, a, b) for n, a, b in zip(
            lens, lone_seqs, seqs)])
        checks[name] = {"differing_tokens": diff[0],
                        "tokens": GW_NEW * len(lens),
                        "first_differences": diff[1]}
    fo = checks["failover"]
    for r in fo["first_differences"]:
        r["resume_point"] = resume[r["i"]]
        r["before_resume"] = resume[r["i"]] is None or \
            r["at"] < resume[r["i"]]
    del ref
    torch.cuda.empty_cache()
    rec = {"phase": "gateway", "check": "tokens",
           "bf16_spread": spread, "pick_gap_limit": 2 * spread,
           "lone_own_full_forward_gap": own_gap, "vs_lone_batcher": checks,
           "idle": idle,
           "bench_gateway": {
               "routed_tokens_per_s": {p: routed[p][1]["tokens_per_s"]
                                       for p in GW_POLICIES},
               **{f"{k}_ms_{q}": routed["least_loaded"][1][f"{k}_ms_{q}"]
                  for k in ("ttft", "tpot") for q in ("p50", "p99")},
               "completions": routed["least_loaded"][1]["completions"],
               "requeued": routed["least_loaded"][1]["requeued"],
               **{k: shared[k] for k in (
                   "prefix_hit_rate", "ttft_ms_p99_cache_on",
                   "ttft_ms_p99_cache_off", "shared_tokens_per_s_cache_on",
                   "shared_tokens_per_s_cache_off",
                   "no_shared_tokens_per_s_cache_on",
                   "no_shared_tokens_per_s_cache_off")}},
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    # each of two bf16 paths picks within the spread of the float32 top, so
    # two picks that differ lie within twice it of each other
    over = [(m, r) for m, c in checks.items()
            for r in c["first_differences"] if r["gap"] > 2 * spread]
    if over:
        fail(f"gateway tokens differ from the lone batcher's by more than "
             f"twice the bf16 spread {spread}: {over}")
    del model
    torch.cuda.empty_cache()
    counts = {}
    for name in KERNELS:
        counts[name] = {p: routed[p][1]["launches"][name] for p in GW_POLICIES}
        counts[name]["failover"] = fo_rep["launches"][name]
    return counts


# Late in a long process a profiler session has lost its first few device
# records, whatever their timing, which emptied sessions of a few launches
# (PERF.md, section 7): each session opens with this many spin kernels,
# whose records are left out.
# -- phase 4g ----------------------------------------------------------------

# int8 serving. A: bench_decode's GPT-2 (GPT2_SERVE_CFG, bf16) with int8
# weights (nn.quant.quantize_linear_layers, bench_decode's kv_cache_int8
# arm; quantization.serving_quantize, bench_quant's weights arm) and int8
# KV pages (static, calibrated on one [8, 256] batch; dynamic, per
# request). B: Llama-2-7B Run A with calibrated int8 pages.
QUANT_LOGIT_REL = 0.05       # int8 against bf16 prefill logits: the JAX
                             # package's own bound (tests/test_quant_serving
                             # .py:45-46, 131-132), held at GPT-2's 12 layers
# At Llama-2-7B's 32 random layers bf16 itself lies ~6% from float32 and
# int8 pages ~11% from float32 in float32 arithmetic (PERF.md), so 5% of
# bf16 is out of reach; there int8 pages' logits are held within this many
# times bf16's own distance from a float32 copy at the same prompt
QUANT_LLAMA_NOISE = 3.0
QUANT_CALIB_LEN = 512        # Llama's calibration prompt
# serving_quantize's bound for the measured run: at its default (0.02)
# every layer of the random-weight model falls back (probe errors
# 2.3-4.8%), which the phase reports too
QUANT_ERR_BOUND = 0.05


def quant_code_check(run):
    """Run `run()` with the paged attention's cache write watched: at its
    first write with quant scales (layer 0 of the first prefill), the int8
    codes it left in the pools are held, bit for bit, to clip(round(x * q),
    -127, 127) of the K and V rows it was given, computed here on the
    card. Returns (run's result, the check's record)."""
    from paddle_tpu_torch.incubate.nn.functional import decode_attention
    write, rec = decode_attention._scatter_paged, {}

    def watched(kc, vc, bt, seq_of, pos, kt, vt, block_size, k_quant=None,
                v_quant=None):
        first = k_quant is not None and not rec
        if first:
            rows = [(kc, kt.clone(), k_quant.clone()),
                    (vc, vt.clone(), v_quant.clone())]
        write(kc, vc, bt, seq_of, pos, kt, vt, block_size, k_quant, v_quant)
        if first:
            blk = (pos // block_size).clamp(max=bt.shape[1] - 1)
            phys, off = bt[seq_of, blk], pos % block_size
            for name, (pool, x, q) in zip("kv", rows):
                qs = q[seq_of][:, :, None] if q.dim() == 2 \
                    else q[None, :, None]
                want = torch.clamp(torch.round(x.float() * qs), -127,
                                   127).to(torch.int8)
                got = pool[phys, :, off]
                rec[name] = {"rows": int(x.shape[0]),
                             "scales": list(q.shape),
                             "pool_dtype": str(pool.dtype),
                             "differing_codes": int((got != want).sum()),
                             "top_bin_share": float(
                                 (want.abs() == 127).float().mean())}
    decode_attention._scatter_paged = watched
    try:
        out = run()
    finally:
        decode_attention._scatter_paged = write
    if not rec or any(r["differing_codes"] or r["pool_dtype"] !=
                      "torch.int8" for r in rec.values()):
        fail(f"int8 page codes differ from clip(round(x * q)) of their own "
             f"rows, or no quantized write ran: {rec}")
    return out, rec


def logit_rel(got, ref):
    """Largest |got - ref| over the largest |ref|."""
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def quant_quality(what, got, ref):
    rel = logit_rel(got, ref)
    if not rel <= QUANT_LOGIT_REL:
        fail(f"{what}: int8 last-position logits lie {rel} (relative to "
             f"the largest bf16 logit) from bf16's, over {QUANT_LOGIT_REL}")
    return rel


def dynamic_reference(model, prompt, new, chunk, block):
    """The dynamic int8 contract driven by hand, one request: its prompt in
    `chunk`-token chunks (the first computing the scales from its valid
    rows, the rest quantizing with them) into int8 pages, then greedy
    paged decode steps with those scales in the state. Returns the full
    sequence."""
    from paddle_tpu_torch.models.generation import paged_state
    dev = next(model.parameters()).device
    L = len(prompt)
    bps = -(-(L + new) // block)
    bt = torch.arange(bps, dtype=torch.int32, device=dev)[None]
    pool = model.paged_alloc(bps + 1, block, cache_dtype="int8")
    padded = np.zeros(-(-L // chunk) * chunk, np.int64)
    padded[:L] = prompt
    scales, logits = None, None
    with torch.no_grad():
        for dec in range(0, len(padded), chunk):
            at = (L - 1) - dec
            args = (torch.from_numpy(padded[None, dec:dec + chunk]).to(dev),
                    pool, bt, block)
            kw = dict(dec_base=torch.tensor([dec], dtype=torch.int32,
                                            device=dev),
                      logits_at=torch.tensor([at if 0 <= at < chunk else 0],
                                             dtype=torch.int32, device=dev))
            if scales is None:
                lg, _, scales = model.paged_prefill_into(
                    *args, dynamic_cache_scales=True,
                    dynamic_scale_valid=torch.tensor(
                        [min(L - dec, chunk)], dtype=torch.int32,
                        device=dev), **kw)
            else:
                lg, _ = model.paged_prefill_into(*args, cache_scales=scales,
                                                 **kw)
            if 0 <= at < chunk:
                logits = lg
        state = paged_state(pool, bt, 1, L, block, bps)
        state["cache_scales"] = scales
        toks = [int(logits.argmax(-1))]
        for _ in range(new - 1):
            lg, state = model.paged_decode_step(
                torch.tensor([toks[-1]], device=dev), state)
            toks.append(int(lg.argmax(-1)))
    return np.concatenate([prompt, np.asarray(toks, np.int64)])


def paged_generate_each(model, prompts, new):
    """generate_paged of each prompt alone (batch 1, block 64): the model's
    own paged route, which the batchers' tokens are held to."""
    with torch.no_grad():
        return [model.generate_paged(
            torch.from_numpy(p[None]).cuda(), n, block_size=64)[0]
            .cpu().numpy() for p, n in zip(prompts, new)]


def token_match(a_seqs, b_seqs, lens):
    """bench_quant.py:236-238's token-match rate: the mean over requests of
    the share of generated positions where two runs agree."""
    return float(np.mean([np.mean(a[n:] == b[n:])
                          for a, b, n in zip(a_seqs, b_seqs, lens)]))


def quant_gpt2(seed):
    """Part A of phase_quant (its docstring). Returns the flash forward's
    launches by run."""
    import copy
    from paddle_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    from paddle_tpu_torch.nn.quant import (WeightOnlyLinear,
                                           quantize_linear_layers)
    from paddle_tpu_torch.ops.hopper import (KERNELS, launch_counts,
                                             reset_launch_counts)
    from paddle_tpu_torch.quantization import serving_quantize
    model = gpt2_serving_model(seed)
    cfg = model.config
    layers = cfg.num_hidden_layers
    traffic = gpt2_traffic(seed, cfg.vocab_size)
    lens = [len(p) for p in traffic[1]]
    news = [GPT2_NEW] * len(lens)
    counts, rec = {}, {"phase": "quant", "part": "gpt2"}
    flash = dict.fromkeys(KERNELS, 0)
    flash["flash_attention"] = layers

    def drive(m, config, what):
        captured = (("fused", "block") if config.get("fused_admission")
                    else ("step", "chunk_dyn_first", "chunk_dyn_rest")
                    if config.get("cache_quant") else ("step", "chunk"))
        got, rep, b = gpt2_drive(m, config, True, traffic, True)
        del b
        torch.cuda.empty_cache()
        emit({"phase": "quant", "run": what, "layers": layers, **rep})
        if rep["completed_requests"] != len(lens) or \
                not rep["windows_equal_tokens"] or rep["pages_leaked"] or \
                rep["audit_pages"]:
            fail(f"quant {what}: {rep['completed_requests']} requests "
                 "completed, windows differ or pages leaked")
        graphs = rep["graphs"]
        if any(graphs.get(k, [0])[0] != 1 for k in captured) or any(
                v[0] > 1 for v in graphs.values()) or any(
                rep["window_captures"].values()):
            fail(f"quant {what}: graphs {graphs}, expected one capture of "
                 f"each of {captured}, in the warm-up")
        if rep["launches"] != dict.fromkeys(KERNELS, 0):
            fail(f"quant {what}: launches {rep['launches']}; the paged "
                 "runs launch no kernel")
        for p, o in zip(traffic[1], got):
            if len(o) != len(p) + GPT2_NEW or not np.array_equal(
                    o[:len(p)], p):
                fail(f"quant {what} returned {len(o)} tokens for a prompt "
                     f"of {len(p)}, or lost the prompt")
        return got, rep

    def held_to(what, ref32, got, against, spread):
        diff = divergence(ref32, [(n, a, g) for n, a, g in zip(
            lens, against, got)])
        rec[f"{what}_vs_own_reference"] = {
            "differing_tokens": diff[0], "tokens": sum(news),
            "first_differences": diff[1], "pick_gap_limit": 2 * spread}
        over = [r for r in diff[1] if r["gap"] > 2 * spread]
        if over:
            fail(f"quant {what}: picks differ from the same quantized "
                 f"model's own route by more than twice the bf16 spread "
                 f"{spread}: {over}")

    ids = torch.randint(0, cfg.vocab_size, (GPT2_BATCH, GPT2_CTX),
                        generator=torch.Generator().manual_seed(seed + 2)
                        ).cuda()
    with torch.no_grad():
        # the bf16 model: its compiled decode step and paged run, and the
        # prefill logits every int8 variant is held to
        gen_bf16, held = gpt2_generate_checks(model, seed, phase="quant")
        counts["generate bf16"] = gen_bf16
        bf16_steps = held["timed"]["kv_cache_compiled_tokens_per_s"]
        del held
        bf16_dense = model.prefill(ids, GPT2_S_MAX)[0][:, -1]
        bf16_paged = model.paged_prefill(ids, 64)[0]
        seqs_bf16, rep_bf16 = drive(model, GPT2_PAGED, "paged bf16")
        ref32 = GPT2ForCausalLM(GPT2Config(**dict(GPT2_SERVE_CFG,
                                                  dtype="float32")),
                                device="cuda").eval()
        ref32.load_state_dict(model.state_dict())
        spread, _, _ = bf16_spread(model, ref32, seqs_bf16, lens)
        rec["bf16_spread"] = spread

        # A1: weight-only int8 linears, bench_decode's kv_cache_int8 arm
        wmodel = copy.deepcopy(model)
        n_int8 = quantize_linear_layers(wmodel)
        gen_int8, held = gpt2_generate_checks(wmodel, seed, phase="quant")
        counts["generate weight-only int8"] = gen_int8
        int8_bytes = sum(m.quant_weight.numel() for m in wmodel.modules()
                         if isinstance(m, WeightOnlyLinear))
        rec["weight_only_int8"] = {
            "int8_linears": n_int8, "int8_weight_bytes": int8_bytes,
            "kv_cache_int8_steps_per_s":
                held["timed"]["kv_cache_compiled_steps_per_s"],
            "kv_cache_int8_tokens_per_s":
                held["timed"]["kv_cache_compiled_tokens_per_s"],
            "bf16_kv_cache_compiled_tokens_per_s": bf16_steps,
            "logit_rel": quant_quality(
                "weight-only int8 prefill",
                wmodel.prefill(ids, GPT2_S_MAX)[0][:, -1], bf16_dense)}
        del wmodel, held
        torch.cuda.empty_cache()

        # A2: serving_quantize, bench_quant's weights arm: the decisions at
        # the default bound, then the run at QUANT_ERR_BOUND
        default = serving_quantize(model)._serving_quant_report
        rec["serving_quantize_default_bound"] = {
            k: default[k] for k in ("layers_quantized", "layers_fallback",
                                    "bytes_saved", "err_bound")}
        qmodel = serving_quantize(model, err_bound=QUANT_ERR_BOUND)
        report = qmodel._serving_quant_report
        qref32 = copy.deepcopy(qmodel).float()
        seqs_q, rep_q = drive(qmodel, GPT2_PAGED, "paged int8 weights")
        spread_q, _, _ = bf16_spread(qmodel, qref32, seqs_q, lens)
        held_to("paged int8 weights", qref32, seqs_q,
                paged_generate_each(qmodel, traffic[1], news), spread_q)
        rec["serving_quantize"] = {
            "layers_quantized": report["layers_quantized"],
            "layers_fallback": report["layers_fallback"],
            "bytes_saved": report["bytes_saved"],
            "err_bound": report["err_bound"],
            "max_rel_err": max(v["rel_err"]
                               for v in report["layers"].values()),
            "bf16_spread": spread_q,
            "tokens_per_s": rep_q["tokens_per_s"],
            "tpot_p50_ms": rep_q["step_ms_median"],
            "bf16_tokens_per_s": rep_bf16["tokens_per_s"],
            "bf16_tpot_p50_ms": rep_bf16["step_ms_median"],
            "token_match": token_match(seqs_bf16, seqs_q, lens),
            "logit_rel": quant_quality(
                "serving_quantize prefill",
                qmodel.prefill(ids, GPT2_S_MAX)[0][:, -1], bf16_dense)}
        if report["layers_quantized"] < 1:
            fail(f"serving_quantize quantized no layer: {report}")
        del qmodel, qref32
        torch.cuda.empty_cache()

        # A3: static int8 pages, calibrated on one [8, 256] batch
        reset_launch_counts()
        model.calibrate_cachekv_int8(ids)
        counts["calibrate"] = launch_counts()
        if counts["calibrate"] != flash:
            fail(f"GPT-2 calibration launches {counts['calibrate']}, "
                 f"expected {flash}")
        (int8_paged, _), codes = quant_code_check(
            lambda: model.paged_prefill(ids, 64))
        rec["static_pages"] = {
            "codes": codes, "logit_rel": quant_quality(
                "static int8 pages prefill", int8_paged, bf16_paged)}
        runs = {}
        for what, config in (
                ("paged static int8 pages", dict(GPT2_PAGED,
                                                 kv_quant="int8")),
                ("fused block static int8 pages",
                 dict(GPT2_FUSED, kv_quant="int8", decode_block=8))):
            runs[what] = drive(model, config, what)
            if runs[what][1]["pool_dtype"] != "torch.int8":
                fail(f"quant {what}: a {runs[what][1]['pool_dtype']} pool")
        own = paged_generate_each(model, traffic[1], news)
        for what, (got, rep) in runs.items():
            held_to(what, ref32, got, own, spread)
            rec["static_pages"][what] = {
                k: rep[k] for k in ("tokens_per_s", "step_ms_median",
                                    "pool_bytes", "kv_quant_bytes_saved",
                                    "kv_quant_enabled", "decode_blocks")}
        rec["static_pages"]["bf16_pool_bytes"] = rep_bf16["pool_bytes"]
        model.calibrate_cachekv_int8(None)

        # A4: dynamic int8 pages, per request
        dev_ids = torch.from_numpy(traffic[1][0][None, :64]).cuda()
        _, codes = quant_code_check(lambda: model.paged_prefill_into(
            dev_ids, model.paged_alloc(2, 64, cache_dtype="int8"),
            torch.zeros(1, 1, dtype=torch.int32, device="cuda"), 64,
            dynamic_cache_scales=True))
        got, rep = drive(model, dict(GPT2_PAGED,
                                     cache_quant="dynamic_int8"),
                         "paged dynamic int8 pages")
        if rep["pool_dtype"] != "torch.int8":
            fail(f"quant dynamic pages: a {rep['pool_dtype']} pool")
        held_to("paged dynamic int8 pages", ref32, got,
                [dynamic_reference(model, p, n, 64, 64)
                 for p, n in zip(traffic[1], news)], spread)
        rec["dynamic_pages"] = {
            "codes": codes, "tokens_per_s": rep["tokens_per_s"],
            "step_ms_median": rep["step_ms_median"],
            "pool_bytes": rep["pool_bytes"],
            "cachekv_clip_rate": rep["cachekv_clip_rate"]}
    emit(rec)
    del model, ref32
    torch.cuda.empty_cache()
    return counts


def quant_llama(seed, model, spread):
    """Part B of phase_quant (its docstring). Returns the RMSNorm's
    launches by run (graphed: the replays' included)."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    from paddle_tpu_torch.inference import PagedContinuousBatcher
    from paddle_tpu_torch.ops.hopper import (KERNELS, launch_counts,
                                             reset_launch_counts)
    cfg = model.config
    layers = cfg.num_hidden_layers
    norms = 2 * layers + 1
    traffic = batcher_traffic(seed, cfg.vocab_size)
    rec, counts = {"phase": "quant", "part": "llama", "layers": layers}, {}
    prompt = torch.randint(0, cfg.vocab_size, (1, QUANT_CALIB_LEN),
                           generator=torch.Generator().manual_seed(seed + 3)
                           ).cuda()

    def split(config):
        """A step's device ms by part (paged_step_split) with 4 requests
        of 512 tokens admitted and 16 steps decoded, as paged_profile
        measures Run A's."""
        b = PagedContinuousBatcher(model, compile=False, **config)
        rng = np.random.RandomState(0)
        rids = [b.submit(rng.randint(0, cfg.vocab_size, 512), 64)
                for _ in range(4)]
        for _ in range(16):
            b.step()
        out = paged_step_split(b)
        for rid in rids:
            b.abort(rid)
        b.audit_pages()
        del b
        torch.cuda.empty_cache()
        return out

    with torch.no_grad():
        bf16_logits = model.paged_prefill(prompt, 64)[0]
        rec["split_bf16"] = split(PAGED_A)
        reset_launch_counts()
        model.calibrate_cachekv_int8(prompt)
        counts["calibrate"] = launch_counts()
        expect = dict.fromkeys(KERNELS, 0)
        expect["flash_attention"] = layers
        expect["rms_norm"] = norms
        if counts["calibrate"] != expect:
            fail(f"Llama calibration launches {counts['calibrate']}, "
                 f"expected {expect}")
        (int8_logits, _), rec["codes"] = quant_code_check(
            lambda: model.paged_prefill(prompt, 64))
        scales = model._cachekv_scales
        config = dict(PAGED_A, kv_quant="int8")
        got, rep, b = paged_run(model, traffic, config, True)
        pool = b._state["layers"]
        rep["pool_dtype"] = str(pool[0][0].dtype)
        rep["pool_bytes"] = sum(t.numel() * t.element_size()
                                for layer in pool for t in layer)
        rep["bf16_pool_bytes"] = sum(t.numel() * 2 for layer in pool
                                     for t in layer)
        del b, pool
        torch.cuda.empty_cache()
        graphs = rep["graphs"]
        (step_c, step_r), (chunk_c, chunk_r) = (
            graphs.get(g, (0, 0)) for g in ("step", "chunk"))
        expect = dict.fromkeys(KERNELS, 0)
        expect["rms_norm"] = norms * (rep["prefill_calls"] + 2 * step_c)
        rep["launches"] = dict(rep["wrapper_counts"])
        rep["launches"]["rms_norm"] += norms * (step_r - step_c
                                                + chunk_r - chunk_c)
        counts["A graphed int8 pages"] = rep["launches"]
        emit({"phase": "quant", "run": "llama A graphed int8 pages",
              "layers": layers, "requests": len(traffic), **rep})
        for (p, n), o in zip(traffic, got):
            if len(o) != len(p) + n or not np.array_equal(o[:len(p)], p):
                fail(f"Llama int8 run returned {len(o)} tokens for a prompt "
                     f"of {len(p)} and {n} new ones, or lost the prompt")
        if rep["pool_dtype"] != "torch.int8" or rep["pages_leaked"] or \
                rep["wrapper_counts"] != expect or step_c != 1 or \
                step_r != rep["steps"] or chunk_c != 1 or \
                rep["admissions"] < len(traffic):
            fail(f"Llama int8 run: pool {rep['pool_dtype']}, leaked "
                 f"{rep['pages_leaked']}, launches {rep['wrapper_counts']} "
                 f"(graphs {graphs}), expected {expect} and one capture "
                 "each")
        rec["run"] = {k: rep[k] for k in ("wall_s", "tokens_per_s",
                                          "decode_ms_per_step", "steps",
                                          "tokens", "pool_bytes",
                                          "bf16_pool_bytes",
                                          "peak_memory_gib")}
        rec["split_int8"] = split(PAGED_A)
        # the same model's own paged route for 4 requests
        own = paged_generate_each(model, [p for p, _ in traffic[:4]],
                                  [n for _, n in traffic[:4]])
        model.calibrate_cachekv_int8(None)
    ref = LlamaForCausalLM(llama2_7b_config(), device="cuda")
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        f32_logits = ref.paged_prefill(prompt, 64)[0]
        ref._cachekv_scales = scales
        int8_f32_logits = ref.paged_prefill(prompt, 64)[0]
        ref._cachekv_scales = None
    rec["logits"] = {
        "int8_vs_bf16": logit_rel(int8_logits, bf16_logits),
        "bf16_vs_float32": logit_rel(bf16_logits, f32_logits),
        "int8_in_float32_vs_float32": logit_rel(int8_f32_logits,
                                                f32_logits),
        "bound": QUANT_LLAMA_NOISE}
    if not rec["logits"]["int8_vs_bf16"] <= QUANT_LLAMA_NOISE * \
            rec["logits"]["bf16_vs_float32"]:
        fail(f"Llama int8 pages: prefill logits {rec['logits']}: int8 lies "
             f"more than {QUANT_LLAMA_NOISE}x bf16's own distance from "
             "float32 from bf16")
    if spread is None:
        spread, _, _ = bf16_spread(model, ref, got[:4],
                                   [len(p) for p, _ in traffic[:4]])
    diff = divergence(ref, [(len(p), o, g) for (p, _), o, g in zip(
        traffic[:4], own, got[:4])])
    del ref
    torch.cuda.empty_cache()
    rec["vs_own_generate_paged"] = {
        "differing_tokens": diff[0],
        "tokens": sum(n for _, n in traffic[:4]),
        "first_differences": diff[1], "pick_gap_limit": 2 * spread}
    emit(rec)
    over = [r for r in diff[1] if r["gap"] > 2 * spread]
    if over:
        fail(f"Llama int8 pages: batcher picks differ from the calibrated "
             f"model's generate_paged by more than twice the bf16 spread "
             f"{spread}: {over}")
    return counts


def phase_quant(seed, model=None, spread=None):
    """Int8 serving on the port. A: bench_decode's GPT-2 (GPT2_SERVE_CFG,
    bf16, gpt2_traffic's requests): generate and the compiled decode step
    (8 x 256, s_max 512) in bf16 and with quantize_linear_layers' int8
    linears; the paged batcher (GPT2_PAGED, graphed) in bf16 and with
    serving_quantize's int8 weights; calibrate_cachekv_int8 on one [8, 256]
    batch, then GPT2_PAGED with kv_quant="int8" and GPT2_FUSED with
    decode_block=8; GPT2_PAGED with cache_quant="dynamic_int8" (64-token
    chunks: every prompt takes the first-chunk and later-chunk calls). B:
    Llama-2-7B (`model`, or serving_model(seed)): Run A's traffic through
    PAGED_A with kv_quant="int8", graphed, after calibrate_cachekv_int8 on
    one 512-token prompt, and a step's device ms by part beside bf16
    pages'. Checks: the pools are int8 where asked; the codes one prefill
    wrote (layer 0: static GPT-2 and Llama, dynamic GPT-2) equal
    clip(round(x * q)) of its own rows on the card, bit for bit; GPT-2's
    int8 pages' and int8 weights' last-position prefill logits within 5% of
    the largest bf16 one at the same rows (Llama's int8 pages' within
    QUANT_LLAMA_NOISE times bf16's own distance from a float32 copy); each
    quantized batcher's tokens
    against the same quantized model's own route (generate_paged, or by
    hand for dynamic pages; A1's graphed decode against its eager one,
    exactly) within twice the run's bf16 spread (`spread`: the paged
    phase's, for Llama); the flash forward launched by the calibrations
    and generates, the RMSNorm kernel by Llama's run. Returns each run's
    launches."""
    t0 = time.perf_counter()
    counts = {"gpt2": quant_gpt2(seed)}
    if model is None:
        model = serving_model(seed)
    counts["llama"] = quant_llama(seed, model, spread)
    emit({"phase": "quant", "phase_s": time.perf_counter() - t0})
    return counts


# -- phase 4h ----------------------------------------------------------------

# A: benchmarks/bench_prefix_churn.py:39-48's churn stream at serving_model's
# width: 32 shared prefixes of 3 blocks of 16 tokens (a 96-page working set)
# over a 22-page pool, 2 slots, s_max 96, a unique 5-token tail a request, 4
# new tokens; a warm pass over every prefix, then 96 Zipf(0.5) draws.
TIER_BLOCK, TIER_PREFIX_BLOCKS, TIER_PREFIXES = 16, 3, 32
TIER_TAIL, TIER_NEW, TIER_REQUESTS, TIER_ZIPF = 5, 4, 96, 0.5
TIER_CFG = dict(max_batch=2, s_max=96, block_size=TIER_BLOCK, n_pages=22,
                policy="ondemand", prefix_cache=True)
# the bench's 0.25 GiB holds every page of its 2-layer model; a Llama-2-7B
# page is 32 layers x K and V x 32 heads x 16 rows x 128 x 2 bytes = 8 MiB,
# so 1 GiB holds the 96-page working set
TIER_HOST_GIB = 1.0
TIER_IDLE_PROMPTS = 12       # the window timed, then profiled, for idle
TIER_PROBE_NODES = 4         # pages whose round trip is held byte for byte

# B: benchmarks/bench_session.py:49-63's session on gpt2_serving_model: a
# 13-block (208-token) first turn, 6 new tokens, a 7-token follow-up; 10
# churn prompts of 5 blocks and 3; 2 slots, s_max 240, 34 pages; the tiers
# sized in the bench's pages (its 0.0008 and 0.05 GiB over its 196,608-byte
# page): a host tier of 4.37 pages over a disk tier of 273 in a temporary
# directory (a GPT-2 bf16 page is 12 layers x K and V x 12 heads x 16 x 64
# x 2 bytes = 576 KiB: 0.0024 and 0.15 GiB); pipelined 3 slots of 5-block
# chunks, serial 1 whole-tail chunk; 2 reps
SESS_BLOCKS, SESS_CONT, SESS_NEW = 13, 7, 6
SESS_CHURN, SESS_CHURN_BLOCKS = 10, 5
SESS_CFG = dict(max_batch=2, s_max=240, block_size=16, n_pages=34,
                policy="ondemand", prefix_cache=True)
SESS_HOST_PAGES, SESS_DISK_PAGES = 0.0008 * 2**30 / 196608, 273
SESS_LEGS = {"pipelined": (3, 5), "serial": (1, None)}
SESS_REPS = 2
# C: the session drill over the gateway phase's paged replicas
GW_SESSION_NEW, GW_SESSION_CONT, GW_SESSION_CHURN = 16, 16, 8


def tier_stream(seed, vocab):
    """(prefixes, the measured prompts): bench_prefix_churn's _workload
    drawn from `seed`."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(0, vocab, TIER_BLOCK * TIER_PREFIX_BLOCKS)
                .astype(np.int64) for _ in range(TIER_PREFIXES)]
    w = 1.0 / np.arange(1, TIER_PREFIXES + 1) ** TIER_ZIPF
    picks = rng.choice(TIER_PREFIXES, size=TIER_REQUESTS, p=w / w.sum())
    prompts = [np.concatenate([prefixes[p], rng.randint(
        0, vocab, TIER_TAIL).astype(np.int64)]) for p in picks]
    return prefixes, prompts


def tier_probes(b, rec):
    """Wrap the batcher's spill callback and chunk install: the first
    TIER_PROBE_NODES demoted pages' rows are copied before their
    demotion and compared, bit for bit, with the rows of the page each is
    promoted into (bf16 blobs); with tier_quant the first demoted page's
    blob is held to clip(rint(x / scale)) of its own rows, computed in
    numpy float32 (the JAX package's arithmetic)."""
    spill, install = b._read_page_blob, b._install_chunk
    tracked = {}

    def rows_of(page):
        return torch.stack([t[page] for kv in b._state["layers"]
                            for t in kv]).clone()

    def probed_spill(node):
        before = None
        if b.tier_quant and not rec["quant_checked"] or \
                not b.tier_quant and len(tracked) < TIER_PROBE_NODES:
            before = rows_of(node.page)
        blob = spill(node)
        if before is None:
            return blob
        if not b.tier_quant:
            tracked[id(node)] = (node, before)
            return blob
        x = before.float().cpu().numpy().reshape(blob["t"].shape)
        amax = np.abs(x).max(axis=(-2, -1), keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        codes = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        rec["quant_checked"] = True
        rec["quant_codes_differing"] = int(
            (codes != blob["t"].numpy()).sum())
        rec["quant_scales_equal"] = scale.tobytes() == \
            blob["ts"].numpy().tobytes()
        return blob

    def probed_install(promo, chunk, staged):
        install(promo, chunk, staged)
        for node, page in zip(chunk["nodes"], chunk["pages"]):
            hit = tracked.pop(id(node), None)
            if hit is not None:
                rec["round_trips"].append(bool(torch.equal(
                    rows_of(page).view(torch.int16),
                    hit[1].view(torch.int16))))

    rec.update(quant_checked=False, round_trips=[])
    b.prefix_cache._spill = probed_spill
    b._install_chunk = probed_install


def tier_run(model, prefixes, prompts, host_kv_gib=None, tier_quant=None,
             idle=False):
    """bench_prefix_churn's _run_stream through a graphed
    PagedContinuousBatcher(**TIER_CFG): the warm pass, then the measured
    Zipf stream one step at a time (each step's wall; the steps that began
    with a promotion in flight and slots decoding, the bench's overlap; the
    steps that decoded while one was in flight after them). The launch
    counters, the registry and the model's paged_prefill_into calls are set
    to 0 before the warm pass and read after the stream. With a host tier
    the probes of tier_probes run; with `idle`, one window of
    TIER_IDLE_PROMPTS more prompts is then timed, and run again under the
    profiler, for the idle share. Returns (the measured requests'
    sequences, the report)."""
    from paddle_tpu_torch.inference import PagedContinuousBatcher
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops.hopper import launch_counts, reset_launch_counts
    reg = get_registry()
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = PagedContinuousBatcher(model, compile=True, host_kv_gib=host_kv_gib,
                               tier_quant=tier_quant, **TIER_CFG)
    probes = {}
    if host_kv_gib:
        tier_probes(b, probes)
    calls = count_calls(model, "paged_prefill_into")
    reset_launch_counts()
    t_start = time.perf_counter()
    try:
        for p in prefixes:
            b.submit(p, TIER_NEW)
        b.run_until_done()
        base = b.prefix_cache.stats()
        rids = [b.submit(p, TIER_NEW) for p in prompts]
        times, overlap, decoded_in_flight = [], 0, 0
        t_run = time.perf_counter()
        while b._has_work():
            pending, decoding = b._promo is not None, bool(b._slot_req)
            steps = b._tele.steps
            t0 = time.perf_counter()
            b.step()
            times.append(time.perf_counter() - t0)
            overlap += pending and decoding
            decoded_in_flight += (b._promo is not None
                                  and b._tele.steps > steps)
            if len(times) > 20000:
                fail("tiers: the churn stream did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = launch_counts()
        decode_steps = b._tele.steps
        outs = [b.pop_result(r) for r in rids]
        del model.paged_prefill_into
        st = b.prefix_cache.stats()
        leaked = b.audit_pages()
        audit = b.prefix_cache.audit_tiers()
        t = np.sort(np.asarray(times))
        hit = st["hit_tokens"] - base["hit_tokens"]
        miss = st["miss_tokens"] - base["miss_tokens"]
        promo_h = reg.get("serving.prefix_promotion_seconds")
        demote_h = reg.get("serving.prefix_demotion_seconds")
        # registered by the first AsyncLoader (the tiered runs')
        load_s = getattr(reg.get("prefetch.async_load_seconds"), "sum", 0)
        step_c, step_r = b._step_fn.captures, b._step_fn.replays
        rep = {
            "host_kv_gib": host_kv_gib, "tier_quant": tier_quant,
            **TIER_CFG, "hit_rate": hit / max(hit + miss, 1),
            "hit_tokens": hit, "miss_tokens": miss,
            "requests": len(prompts), "steps": len(times),
            "overlap_steps": int(overlap),
            "steps_decoding_with_promotion_in_flight":
                int(decoded_in_flight),
            "wall_s": wall,
            "step_ms_p50": float(t[len(t) // 2]) * 1e3,
            "step_ms_p99": float(t[min(len(t) - 1,
                                       int(len(t) * 0.99))]) * 1e3,
            "cache": st, "tiers_audit": audit, "pages_leaked": leaked,
            "prefill_calls": calls[0], "decode_steps": decode_steps,
            "graph": [step_c, step_r],
            "wrapper_counts": launches,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "host_bytes_end": b._host_bytes_g.value,
            "host_bytes_peak": b._host_bytes_g.peak,
            "spill_raw_bytes": reg.get(
                "serving.prefix_spill_raw_bytes").value,
            "spill_blob_bytes": reg.get(
                "serving.prefix_spill_blob_bytes").value,
            "promotion_ms_p50": (promo_h.quantile(0.5) or 0) * 1e3,
            "promotion_ms_p99": (promo_h.quantile(0.99) or 0) * 1e3,
            "promotions_streams": promo_h.count,
            "demotion_ms_p50": (demote_h.quantile(0.5) or 0) * 1e3,
            "demotion_gb_per_s": (st["demoted_bytes"] / demote_h.sum / 1e9
                                  if demote_h.sum else None),
            # the workers' time a chunk: its tier reads, the copy to the
            # card and the wait for it
            "promotion_copy_gb_per_s": (st["promoted_bytes"] / load_s / 1e9
                                        if load_s else None),
            "promotion_stream_gb_per_s": (st["promoted_bytes"] / promo_h.sum
                                          / 1e9 if promo_h.sum else None),
            "dequant_ms_sum": reg.get("quant.dequant_seconds").sum * 1e3,
            "probes": probes,
            "run_s": time.perf_counter() - t_start}
        if idle:
            rng = np.random.RandomState(TIER_REQUESTS)
            window = [prompts[i] for i in rng.randint(
                0, len(prompts), TIER_IDLE_PROMPTS)]

            def run_window():
                for p in window:
                    b.submit(p, TIER_NEW)
                b.run_until_done()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_window()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
            prof = profile_one(run_window)
            dev = prof["device_ms"]
            rep["idle"] = {
                "window_wall_ms": window_ms, "window_device_ms": dev,
                "device_idle_share": (1 - dev / window_ms
                                      if dev != "not measured" else dev),
                "top": prof["top"][:6]}
        return outs, rep
    finally:
        b.close()
        # the cache's spill callback and the probes close over b: only a
        # collection frees its pool and its graph
        del b
        gc.collect()
        torch.cuda.empty_cache()




def tier_divergence(model, ref_box, pairs):
    """divergence() against a float32 copy of `model`, built on first need
    into ref_box[0] (a 27 GB copy at Llama-2-7B width)."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    if all(np.array_equal(a, b) for _, a, b in pairs):
        return 0, []
    if not ref_box:
        ref = LlamaForCausalLM(llama2_7b_config(), device="cuda")
        ref.load_state_dict(model.state_dict())
        ref_box.append(ref)
    return divergence(ref_box[0], pairs)


def phase_tiers(seed, model, spread):
    """Part A of the tiers phase: the KV cache's host tier at Llama-2-7B
    width (`model`, bf16, 32 layers, uncalibrated), bench_prefix_churn's
    stream (tier_stream) through TIER_CFG, graphed: device only, then with
    a TIER_HOST_GIB host tier, then with the host tier and
    tier_quant="int8" (bench_quant's tier arm). Checks: the tiered hit
    rate is above the device-only one; the tiered runs demote and promote,
    and decode while a promotion is in flight; audit_pages and audit_tiers
    are clean; the probed pages' rows after demotion and promotion equal
    their copies from before it, byte for byte; the tier_quant run stores
    at most 0.55 of the raw bytes, and its probed page's codes and scales
    are clip(rint(x / scale)) of its rows in numpy float32; the RMSNorm
    wrapper counts 65 launches a prefill call and a decode step (graphed:
    the warm-up and the capture; the replays counted by to_static), one
    capture and a replay a decode step, nothing else launches; the tiered
    tokens equal the device-only ones or, at each first difference, both
    picks lie within twice the paged phase's bf16 spread (`spread`) of a
    float32 copy's top (tier_quant's within QUANT_LLAMA_NOISE times that:
    int8 KV moves the 32 random layers' logits up to that many times bf16's
    own distance from float32, phase quant).
    Returns each run's launches (the replays' included)."""
    from paddle_tpu_torch.ops.hopper import KERNELS
    t_phase = time.perf_counter()
    cfg = model.config
    norms = 2 * cfg.num_hidden_layers + 1
    prefixes, prompts = tier_stream(seed, cfg.vocab_size)
    outs, reps, counts = {}, {}, {}
    with torch.no_grad():
        for name, gib, tq in (("device only", None, None),
                              ("tiered", TIER_HOST_GIB, None),
                              ("tiered int8", TIER_HOST_GIB, "int8")):
            got, rep = tier_run(model, prefixes, prompts, gib, tq,
                                idle=name == "tiered")
            step_c, step_r = rep["graph"]
            expect = dict.fromkeys(KERNELS, 0)
            expect["rms_norm"] = norms * (rep["prefill_calls"] + 2 * step_c)
            counts[name] = dict(rep["wrapper_counts"])
            counts[name]["rms_norm"] += norms * (step_r - step_c)
            rep["launches"] = counts[name]
            emit({"phase": "tiers", "part": "A", "run": name,
                  "layers": cfg.num_hidden_layers, **rep})
            for p, o in zip(prompts, got):
                if len(o) != len(p) + TIER_NEW or \
                        not np.array_equal(o[:len(p)], p):
                    fail(f"tiers {name}: {len(o)} tokens for a prompt of "
                         f"{len(p)}, or the prompt lost")
            if rep["wrapper_counts"] != expect or step_c != 1 or \
                    step_r != rep["decode_steps"]:
                fail(f"tiers {name}: launch counts {rep['wrapper_counts']} "
                     f"(graph {rep['graph']}, {rep['prefill_calls']} "
                     f"prefill calls, {rep['decode_steps']} decode steps), "
                     f"expected {expect}, one capture and a replay a step")
            if rep["pages_leaked"]:
                fail(f"tiers {name}: {rep['pages_leaked']} pages leaked")
            outs[name], reps[name] = got, rep
    dev, tiered, tq = (reps[n] for n in ("device only", "tiered",
                                         "tiered int8"))
    if not tiered["hit_rate"] > dev["hit_rate"]:
        fail(f"tiers: the tiered hit rate {tiered['hit_rate']} is not above "
             f"the device-only {dev['hit_rate']}")
    for name in ("tiered", "tiered int8"):
        rep, st = reps[name], reps[name]["cache"]
        if st["demotions"] < 1 or st["promotions"] < 1 or \
                rep["steps_decoding_with_promotion_in_flight"] < 1:
            fail(f"tiers {name}: {st['demotions']} demotions, "
                 f"{st['promotions']} promotions, "
                 f"{rep['steps_decoding_with_promotion_in_flight']} steps "
                 "decoding with a promotion in flight")
        if "host_bytes" not in rep["tiers_audit"]:
            fail(f"tiers {name}: the tier audit reports {rep['tiers_audit']}")
    trips = tiered["probes"]["round_trips"]
    if not trips or not all(trips):
        fail(f"tiers: demoted and promoted pages' rows against their copies "
             f"from before the demotion: {trips}")
    pq = tq["probes"]
    if not pq["quant_checked"] or pq["quant_codes_differing"] or \
            not pq["quant_scales_equal"]:
        fail(f"tiers int8: the probed page's codes and scales against "
             f"clip(rint(x / scale)): {pq}")
    if not tq["spill_blob_bytes"] <= 0.55 * tq["spill_raw_bytes"]:
        fail(f"tiers int8: {tq['spill_blob_bytes']} stored bytes of "
             f"{tq['spill_raw_bytes']} raw")
    t_ref = time.perf_counter()
    ref_box = []
    lens = [len(p) for p in prompts]
    checks = {}
    with torch.no_grad():
        for name, limit in (("tiered", 2 * spread),
                            ("tiered int8", QUANT_LLAMA_NOISE * 2 * spread)):
            diff = tier_divergence(model, ref_box, [
                (n, a, b) for n, a, b in zip(lens, outs["device only"],
                                             outs[name])])
            checks[name] = {"differing_tokens": diff[0],
                            "tokens": TIER_NEW * len(prompts),
                            "first_differences": diff[1],
                            "pick_limit": limit}
    del ref_box
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, rrec = rms_case(gen, torch.bfloat16, (1, TIER_BLOCK * TIER_PREFIX_BLOCKS
                                             + TIER_TAIL, cfg.hidden_size))
    emit({"phase": "tiers", "part": "A", "check": "tokens",
          "bf16_spread": spread, "vs_device_only": checks,
          "rms_norm_prefill_rows": rrec,
          "hit_rate": {n: r["hit_rate"] for n, r in reps.items()},
          "token_check_s": time.perf_counter() - t_ref,
          "phase_s": time.perf_counter() - t_phase})
    over = [(n, r) for n, c in checks.items() for r in c["first_differences"]
            if max(r["below_top"]) > c["pick_limit"]]
    if over:
        fail(f"tiers: tiered picks leave the device-only ones by more than "
             f"their limits: {over}")
    return counts


def session_batcher(model, root, tiers=True, slots=3, chunk=5):
    """bench_session's _batcher (graphed): SESS_CFG with the host and disk
    tiers and the manifest store under `root`; without `tiers`, the
    baseline's plain prefix cache."""
    from paddle_tpu_torch.inference import PagedContinuousBatcher
    cfg = model.config
    page_gib = (cfg.num_hidden_layers * 2 * cfg.hidden_size * SESS_CFG[
        "block_size"] * next(model.parameters()).element_size() / 2**30)
    kw = dict(SESS_CFG)
    if tiers:
        kw.update(host_kv_gib=SESS_HOST_PAGES * page_gib,
                  disk_kv_dir=os.path.join(root, "kv_disk"),
                  disk_kv_gib=SESS_DISK_PAGES * page_gib, promo_slots=slots,
                  promo_chunk_blocks=chunk,
                  session_store=os.path.join(root, "sessions"))
    return PagedContinuousBatcher(model, compile=True, **kw)


def session_turn(b, prompt, new=SESS_NEW):
    rid = b.submit(prompt, new)
    return b.run_until_done()[rid]


def session_leg(model, root, prompt, cont, churn, slots, chunk):
    """bench_session's _pause_churn_resume: the first turn, the pause (pin
    and publish), the churn, then the timed resume through the promotion
    stream. Returns the leg's record."""
    from paddle_tpu_torch.observability.metrics import get_registry
    b = session_batcher(model, root, slots=slots, chunk=chunk)
    try:
        out1 = session_turn(b, prompt)
        published = b.pause_session("agent", out1)
        for p in churn:
            b.submit(p, SESS_NEW)
        b.run_until_done()
        pinned = b._session_pins.get("agent", [])
        residency = [n.residency for n in pinned]
        toks = b.resume_session("agent")
        if toks is None or not np.array_equal(toks, out1):
            fail(f"tiers session: the manifest resolved {toks}, not the "
                 "first turn's sequence")
        h = get_registry().histogram("serving.prefix_promotion_seconds")
        promos, sum0 = b.prefix_cache.promotions, h.sum
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out2 = session_turn(b, np.concatenate([toks, cont]))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        leaked = b.audit_pages()
        st = b.prefix_cache.stats()
        return {"out1": out1, "out2": out2, "resume_ms": resume_s * 1e3,
                "promo_stream_ms": (h.sum - sum0) * 1e3,
                "published": bool(published), "pinned": len(pinned),
                "residency_before_resume": residency,
                "resume_promotions": b.prefix_cache.promotions - promos,
                "pin_drops": st["session_pin_drops"],
                "pages_leaked": leaked, "tiers_audit":
                    b.prefix_cache.audit_tiers()}
    finally:
        b.close()
        del b
        gc.collect()


def tiers_sessions(model, ref, root):
    """Part B: bench_session's three legs (phase_tiers_sessions' docstring)
    under `root`, each turn against the baseline's by divergence with the
    float32 copy `ref`. Returns (the record, {leg: divergence}, the
    baseline's (prompt length, sequence) pairs)."""
    vocab = model.config.vocab_size
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, vocab, 16 * SESS_BLOCKS).astype(np.int64)
    cont = rng.randint(0, vocab, SESS_CONT).astype(np.int64)
    churn = [rng.randint(0, vocab, 16 * SESS_CHURN_BLOCKS + 3)
             .astype(np.int64) for _ in range(SESS_CHURN)]
    base = session_batcher(model, root, tiers=False)
    base1 = session_turn(base, prompt)
    base2 = session_turn(base, np.concatenate([base1, cont]))
    del base
    legs = {name: [] for name in SESS_LEGS}
    # one untimed leg a geometry first, as the bench: first-use costs
    for name, (slots, chunk) in SESS_LEGS.items():
        session_leg(model, os.path.join(root, f"warm {name}"), prompt, cont,
                    churn, slots, chunk)
    for rep in range(SESS_REPS):
        for name, (slots, chunk) in SESS_LEGS.items():
            legs[name].append(session_leg(
                model, os.path.join(root, f"{name} {rep}"), prompt, cont,
                churn, slots, chunk))
    crash = session_batcher(model, os.path.join(root, "pipelined 0"))
    toks = crash.resume_session("agent")
    if toks is None:
        fail("tiers session: the crash leg's manifest did not resolve")
    crash2 = session_turn(crash, np.concatenate([toks, cont]))
    crash_leaked = crash.audit_pages()
    crash.close()
    del crash
    gc.collect()
    n1, n2 = len(prompt), len(base1) + SESS_CONT
    pairs = {"crash": [(n2, base2, crash2)]}
    for name, runs in legs.items():
        pairs[name] = [(n1, base1, r["out1"]) for r in runs] + \
            [(n2, base2, r["out2"]) for r in runs]
    diffs = {name: divergence(ref, p) for name, p in pairs.items()}
    rec = {
        "time_to_resume_ms": {n: min(r["resume_ms"] for r in runs)
                              for n, runs in legs.items()},
        "promo_stream_ms": {n: min(r["promo_stream_ms"] for r in runs)
                            for n, runs in legs.items()},
        "legs": {n: [{k: v for k, v in r.items()
                      if k not in ("out1", "out2")} for r in runs]
                 for n, runs in legs.items()},
        "equal_to_baseline": {n: d[0] == 0 for n, d in diffs.items()},
        "differences": {n: {"differing_tokens": d[0],
                            "first_differences": d[1]}
                        for n, d in diffs.items()},
        "crash_manifest_tokens": len(toks),
        "crash_pages_leaked": crash_leaked}
    for name, runs in legs.items():
        for r in runs:
            if "disk" not in r["residency_before_resume"]:
                fail(f"tiers session {name}: the pinned chain sat in "
                     f"{r['residency_before_resume']} before the resume, "
                     "not down to disk")
            if r["resume_promotions"] < 1 or r["pin_drops"] or \
                    not r["published"] or r["pages_leaked"]:
                fail(f"tiers session {name}: {r['resume_promotions']} "
                     f"promotions in the resume, {r['pin_drops']} pin drops, "
                     f"published {r['published']}, {r['pages_leaked']} "
                     "pages leaked")
    return rec, diffs, [(n1, base1), (n2, base2)]


def tiers_gateway(model, root):
    """Part C: a session over the gateway phase's two graphed paged
    replicas (GW_PAGED with the prefix cache) under the affinity policy,
    with a manifest store: a turn, pause_session, churn, the holding
    replica killed by chaos gateway.step.<name>, resume_session on the
    survivor from the manifest, release_session(delete_manifest=True);
    then the same two turns through a lone graphed paged batcher. Returns
    (the record, the (prompt length, lone, gateway) pairs)."""
    from paddle_tpu_torch.inference import Gateway, PagedContinuousBatcher
    from paddle_tpu_torch.resilience import arm_scenario, disarm
    vocab = model.config.vocab_size
    rng = np.random.RandomState(GW_SESSION_NEW)
    prompt = rng.randint(0, vocab, GW_CTX).astype(np.int64)
    cont = rng.randint(0, vocab, GW_SESSION_CONT).astype(np.int64)
    churn = [rng.randint(0, vocab, GW_CTX).astype(np.int64)
             for _ in range(GW_SESSION_CHURN)]

    def replica():
        return PagedContinuousBatcher(model, compile=True, prefix_cache=True,
                                      **GW_PAGED)
    gw = Gateway(policy="affinity",
                 session_store=os.path.join(root, "sessions"))
    for i in range(GW_REPLICAS):
        gw.add_replica(f"r{i}", replica())
    gid = gw.submit(prompt, GW_SESSION_NEW, session_id="conv")
    out1 = gw.run_until_done()[gid]
    published = gw.pause_session("conv")
    victim = gw._session_last_replica["conv"]
    pinned = len(gw.pool.get(victim).batcher._session_pins.get("conv", []))
    for p in churn:
        gw.submit(p, GW_SESSION_NEW)
    gw.run_until_done()
    arm_scenario(f"seed=0; gateway.step.{victim}:transient_error:count=1")
    try:
        gw.submit(prompt, 4)
        for _ in range(1000):
            gw.step()
            if not gw.pool.get(victim).alive:
                break
    finally:
        disarm()
    gw.run_until_done()
    gid2 = gw.resume_session("conv", new_tokens=cont,
                             max_new_tokens=GW_SESSION_NEW)
    while gw._has_work():
        gw.step()
    served_on = gw._finished[gid2].replica
    out2 = gw.pop_result(gid2)
    gw.release_session("conv", delete_manifest=True)
    alive = {r.name: r.alive for r in gw.pool.replicas()}
    audits = {r.name: r.batcher.audit_pages() for r in gw.pool.replicas()
              if r.alive}
    rec = {"published": published, "pinned_blocks": pinned,
           "victim": victim, "alive": alive, "resumed_on": served_on,
           "manifests_after_release": gw.session_store.sessions(),
           "findings": [f.kind for f in gw.session_store.drain_findings()],
           "stats": gw.stats(), "audit_pages": audits}
    del gw
    lone = replica()
    lone1 = session_turn(lone, prompt, GW_SESSION_NEW)
    lone2 = session_turn(lone, np.concatenate([lone1, cont]),
                         GW_SESSION_NEW)
    del lone
    gc.collect()
    torch.cuda.empty_cache()
    if not published or alive.get(victim) or served_on == victim or \
            rec["manifests_after_release"] or any(audits.values()) or \
            not np.array_equal(out2[:len(out1)], out1):
        fail(f"tiers gateway session: {rec}")
    return rec, [(len(prompt), lone1, out1),
                 (len(out1) + len(cont), lone2, out2)]



def phase_tiers_sessions(seed):
    """Parts B and C of the tiers phase on gpt2_serving_model (bf16, 12 x
    768, vocab 32000, weights from `seed`). B: bench_session.py:85-174's
    legs (session_leg, SESS_REPS reps each): pipelined (promo_slots 3,
    5-block chunks) and serial (one slot, one whole-tail chunk) after one
    untimed leg each, then the crash leg (a fresh batcher sharing only the
    store), against the uninterrupted two-turn baseline. C: tiers_gateway.
    Checks: the pinned chain reached the disk before each resume, the
    resume promoted it, the manifest published and resolved to the first
    turn's sequence, no pin dropped and no page or tier blob leaked; every
    leg's turns, the crash leg's and the gateway's equal their references
    or, at each first difference, the two picks lie within twice the bf16
    spread (bf16_spread of the baseline against a float32 copy); the
    gateway's victim died, the resume ran on the survivor and the release
    deleted the manifest; nothing launches a kernel (GPT-2's paged
    attention and LayerNorm are plain). Returns the launches."""
    import tempfile
    from paddle_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    from paddle_tpu_torch.ops.hopper import (KERNELS, launch_counts,
                                             reset_launch_counts)
    t_phase = time.perf_counter()
    model = gpt2_serving_model(seed)
    ref = GPT2ForCausalLM(GPT2Config(**dict(GPT2_SERVE_CFG,
                                            dtype="float32")),
                          device="cuda").eval()
    ref.load_state_dict(model.state_dict())
    with tempfile.TemporaryDirectory(prefix="tiers_") as root, \
            torch.no_grad():
        reset_launch_counts()
        sess, diffs, base = tiers_sessions(model, ref,
                                           os.path.join(root, "b"))
        gw_rec, gw_pairs = tiers_gateway(model, os.path.join(root, "c"))
        launches = launch_counts()
        spread, own, _ = bf16_spread(model, ref, [s for _, s in base],
                                     [n for n, _ in base])
        diffs["gateway"] = divergence(ref, gw_pairs)
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "tiers", "part": "B", **sess,
          "bf16_spread": spread, "baseline_own_full_forward_gap": own})
    emit({"phase": "tiers", "part": "C", **gw_rec,
          "vs_lone": {"differing_tokens": diffs["gateway"][0],
                      "first_differences": diffs["gateway"][1]},
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    over = [(n, r) for n, d in diffs.items() for r in d[1]
            if max(r["below_top"]) > 2 * spread]
    if over:
        fail(f"tiers sessions: picks leave their references by more than "
             f"twice the bf16 spread {spread}: {over}")
    if launches != dict.fromkeys(KERNELS, 0):
        fail(f"tiers sessions launched {launches}")
    return launches


PROFILE_PAD = 32


def profile_one(fn, calls=1):
    """Device time by kernel over `calls` calls of fn, after PROFILE_PAD
    spin kernels that are left out of the result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and "spin_kernel" not in e.key]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows) or "not measured",
            "top": [[k[:60], round(ms, 4), n] for k, ms, n in rows[:10]],
            # each flash build with its template arguments, and its records
            "flash_builds": {m: sum(n for k, _, n in rows if m in k)
                             for m in sorted({m for k, _, _ in rows
                                              for m in re.findall(
                                                  FLASH_BUILD, k)})},
            # each RMSNorm build: [device ms, records]
            "rms_norm_builds": {m: [sum(t for k, t, _ in rows if m in k),
                                    sum(n for k, _, n in rows if m in k)]
                                for m in sorted({m for k, _, _ in rows
                                                 for m in re.findall(
                                                     RMS_BUILD, k)})},
            **{f"{what}_kernels": sorted({m for k, _, _ in rows
                                          for m in re.findall(pat, k)})
               for what, pat in (("flash_fwd", r"flash_fwd_\w+"),
                                 ("flash_bwd", r"flash_bwd_\w+"),
                                 ("block_sparse",
                                  r"block_sparse_fwd_\w+"))}}


# a flash kernel's name with its template arguments in a profiler record
FLASH_BUILD = r"flash_(?:fwd|bwd)_\w+<[^<>]*>"
RMS_BUILD = r"rms_norm_\w+<[^<>]*>"


def rms_vector_only(profile, what, kernels):
    """Fail unless the profile's RMSNorm kernels are exactly `kernels`
    (names without template arguments): the main path's norms take the
    vector builds, never the general ones."""
    got = sorted({b.split("<")[0] for b in profile["rms_norm_builds"]})
    if got != sorted(kernels):
        fail(f"{what} RMSNorm kernels {got}, expected {sorted(kernels)}")


def dropout_build(build):
    """Whether a profiled flash build (``name<D, mask, window, dropout>``)
    is a dropout build: its last template argument is true."""
    return build.rsplit(",", 1)[-1].strip(" >") in ("true", "1")


# -- phase 4i ----------------------------------------------------------------

# A: generate_paged_speculative on serving_model (Llama-2-7B): a 512-token
# prompt, 128 new tokens, draft_k 4, block 64, compile=True, three drafts
SPEC_PROMPT, SPEC_NEW, SPEC_K, SPEC_BLOCK = 512, 128, 4, 64
# LLaMA-68M's published shape (JackFram/llama-68m, SpecInfer's draft for
# LLaMA-7B): 2 layers of 768, 12 heads of 64, intermediate 3072, vocab
# 32000; random weights from --seed like the target's
LLAMA_68M = dict(vocab_size=32000, hidden_size=768, intermediate_size=3072,
                 num_hidden_layers=2, num_attention_heads=12,
                 num_key_value_heads=12, max_position_embeddings=2048,
                 dtype="bfloat16")
SPEC_SELF_LAYERS = 2         # the target's first layers as a draft
# B: the batcher phase's traffic through the graphed paged batcher (block
# 64, no prefill chunks: a draft refuses them)
SPEC_BATCHER = dict(max_batch=8, s_max=1024, block_size=64)
# C: gpt2_serving_model with a draft of distilgpt2's depth at its width
SPEC_GPT2_DRAFT_LAYERS = 6
SPEC_GPT2_BATCHER = dict(max_batch=GPT2_BATCH, s_max=GPT2_S_MAX,
                         block_size=64)
# C's tier drill: tier_stream's churn at vocab 32000 through 2 slots
SPEC_TIER_CFG = dict(TIER_CFG, n_pages=22)
SPEC_TIER_PROMPTS = 24


def rms_launches_per_call(model):
    """RMSNorm wrapper launches in one pass of `model`: two a layer and the
    final norm for Llama; none for GPT-2 (LayerNorm is plain)."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    if isinstance(model, LlamaForCausalLM):
        return 2 * model.config.num_hidden_layers + 1
    return 0


class CaptureLog:
    """While active, records every jit.to_static function created (the
    speculative loop's four) and times each capture (warm-up and capture,
    synchronized), so a run's wall can be read without them."""

    def __init__(self):
        self.made, self.capture_s = [], 0.0

    def __enter__(self):
        import paddle_tpu_torch.jit as J
        self.J, self.orig = J, J.to_static

        def recorded(fn, donate_args=()):
            s = self.orig(fn, donate_args)
            self.watch(s)
            return s
        J.to_static = recorded
        return self

    def watch(self, s):
        cap = s._capture

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cap(*args)
            torch.cuda.synchronize()
            self.capture_s += time.perf_counter() - t0
            return out
        s._capture = timed
        self.made.append(s)
        return s

    def __exit__(self, *exc):
        self.J.to_static = self.orig


def graph_launches(counts, fns):
    """The run's launches: the wrapper's counts (eager calls, and each
    graph's warm-up and capture) and, for each captured function in
    `fns` = [(function, RMSNorm launches a call)], its replays after the
    capture's own."""
    out = dict(counts)
    out["rms_norm"] += sum(n * (f.replays - f.captures) for f, n in fns)
    return out


def llama_drafts(seed, model):
    """The three drafts of part A: LLaMA-68M's shape, the target's first
    SPEC_SELF_LAYERS layers with its embeddings, final norm and head (the
    same modules, no copy), and the target itself."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama2_7b_config)
    gen = torch.Generator(device="cuda").manual_seed(seed + 68)
    d68 = LlamaForCausalLM(LlamaConfig(**LLAMA_68M), device="cuda",
                           generator=gen)
    part = LlamaForCausalLM(llama2_7b_config(
        dtype="bfloat16", num_hidden_layers=SPEC_SELF_LAYERS),
        device="cuda", generator=gen)
    part.model.embed_tokens = model.model.embed_tokens
    part.model.layers = torch.nn.ModuleList(
        list(model.model.layers[:SPEC_SELF_LAYERS]))
    part.model.norm = model.model.norm
    part.lm_head = model.lm_head
    gc.collect()
    torch.cuda.empty_cache()
    return {"llama_68m": d68, f"self_{SPEC_SELF_LAYERS}_layers": part,
            "self": model}


def rms_timed(gen, shape):
    """The RMSNorm forward at `shape` (bf16) against its plain version
    (rms_case), then timed beside it, F.rms_norm and its bound."""
    from paddle_tpu_torch.ops.hopper import rms_norm, rms_norm_plain
    (x, w), rrec = rms_case(gen, torch.bfloat16, shape)
    n = x.numel()
    rows = n // x.shape[-1]
    r_bound, r_by = bound(2 * n * 2 + w.numel() * 2 + rows * 4, 4 * n,
                          H100_FP32_FLOPS)
    return {"shape": f"x {list(shape)} bf16", "build": rrec["build"],
            "threads": rrec["threads"], "max_abs_err": rrec["max_abs_err"],
            "tol": rrec["tol"], "ms": time_ms(lambda: rms_norm(x, w, 1e-5)),
            "plain_ms": time_ms(lambda: rms_norm_plain(x, w, 1e-5)),
            "bound_ms": r_bound, "bound_by": r_by,
            "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
                x, (x.shape[-1],), w, 1e-5))}


def idle_share(fn):
    """1 - the device ms of one profiled call of fn over the wall of an
    unprofiled call just before it (a profiler session's cost grows with
    the records, so callers keep fn short)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = profile_one(fn)["device_ms"]
    if dev == "not measured":
        return dev
    return 1 - dev / wall_ms


SPEC_IDLE_NEW = 16           # the batcher window profiled for idle


def idle_from_rounds(rec):
    """A standalone call's idle share estimated from its parts: its rounds
    times a round's device ms (spec_round_split, CUDA events on the same
    graphs) over its wall without the graphs' captures (profiling a whole
    call costs minutes at 7B: the records of ~600 graph replays)."""
    busy_ms = rec["spec_stats"]["rounds"] * rec["round_device_ms"]["round"]
    return 1 - busy_ms / ((rec["wall_s"] - rec["capture_s"]) * 1e3)


def spec_round_split(target, draft, ids, new, reps=10):
    """A round's device ms by part at one sequence's shapes, each part a
    CUDA graph timed by CUDA events (cold L2): the draft's catch-up of one
    token, its SPEC_K - 1 decode steps, and the target's verify of SPEC_K
    + 1 rows, all after the prompt."""
    from paddle_tpu_torch.jit import to_static
    L, dev = ids.shape[1], ids.device
    bps = -(-(L + new) // SPEC_BLOCK)
    with torch.no_grad():
        _, ts = target.paged_prefill(ids, SPEC_BLOCK, bps)
        _, ds = draft.paged_prefill(ids, SPEC_BLOCK, bps)

    def verify(i, layers, bt, dec):
        return target.paged_prefill_into(i, layers, bt, SPEC_BLOCK,
                                         dec_base=dec, logits_all=True)

    def catchup(i, layers, bt, dec, at):
        return draft.paged_prefill_into(i, layers, bt, SPEC_BLOCK,
                                        dec_base=dec, logits_at=at)
    v, c = to_static(verify, (1,)), to_static(catchup, (1,))
    d = to_static(draft.paged_decode_step, (1,))
    dec = torch.tensor([L], dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    tok = torch.zeros(1, dtype=torch.int64, device=dev)
    parts = {
        "catch_up": lambda: c(torch.zeros(1, 1, dtype=torch.int64,
                                          device=dev),
                              ds["layers"], ds["block_tables"], dec, zero),
        "draft_steps": lambda: [d(tok, ds) for _ in range(SPEC_K - 1)],
        "verify": lambda: v(torch.zeros(1, SPEC_K + 1, dtype=torch.int64,
                                        device=dev),
                            ts["layers"], ts["block_tables"], dec)}
    with torch.no_grad():
        out = {k: time_ms(fn, iters=reps) for k, fn in parts.items()}
    out["round"] = sum(out.values())
    del ts, ds, v, c, d
    return out


def spec_standalone(model, draft, ids, ref_seq, name):
    """One generate_paged_speculative call (compile=True): its tokens, the
    stats, the wall with and without the graphs' captures, and the
    launches (the replays' included), the counters set to 0 just before."""
    from paddle_tpu_torch.ops.hopper import launch_counts, reset_launch_counts
    nt, nd = rms_launches_per_call(model), rms_launches_per_call(draft)
    torch.cuda.synchronize()
    with CaptureLog() as log, torch.no_grad():
        reset_launch_counts()
        t0 = time.perf_counter()
        out, stats = model.generate_paged_speculative(
            ids, SPEC_NEW, draft, draft_k=SPEC_K, block_size=SPEC_BLOCK,
            compile=True, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    # the loop makes its graphs in this order: target step, draft step,
    # verify (the target), catch-up (the draft)
    launches = graph_launches(counts, zip(log.made, (nt, nd, nt, nd)))
    seq = out[0].cpu().numpy()

    rec = {"draft": name, "tokens_per_s": SPEC_NEW / wall,
           "tokens_per_s_without_captures": SPEC_NEW / (wall - log.capture_s),
           "wall_s": wall, "capture_s": log.capture_s,
           "captures": sum(f.captures for f in log.made),
           "replays": sum(f.replays for f in log.made),
           "spec_stats": stats, "launches": launches,
           "differing_tokens": int((seq != ref_seq).sum())}
    return seq, rec


def spec_batcher_run(model, traffic, draft=None, config=SPEC_BATCHER):
    """`traffic` through a new graphed PagedContinuousBatcher(**config)
    with `draft` (or none): 12 requests up front, 12 after the 5th step.
    The launch counters and the models' paged_prefill_into calls are set
    to 0 just before and read just after. Returns (the sequences, the
    report)."""
    from paddle_tpu_torch.inference import PagedContinuousBatcher
    from paddle_tpu_torch.ops.hopper import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(draft_model=draft, draft_k=SPEC_K) if draft is not None else {}
    b = PagedContinuousBatcher(model, compile=True, **config, **kw)
    log = CaptureLog()
    fns = [(b._step_fn, rms_launches_per_call(model))]
    if draft is not None:
        nd = rms_launches_per_call(draft)
        fns += [(b._verify_fn, rms_launches_per_call(model)),
                (b._dstep_fn, nd), (b._catchup_fn, nd)]
    for f, _ in fns:
        log.watch(f)
    calls = count_calls(model, "paged_prefill_into")
    dcalls = (count_calls(draft, "paged_prefill_into")
              if draft is not None and draft is not model else calls)
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        half = len(traffic) // 2
        rids = [b.submit(p, n) for p, n in traffic[:half]]
        early = []
        for _ in range(5):
            early += b.step()
        rids += [b.submit(p, n) for p, n in traffic[half:]]
        outs = b.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    del model.paged_prefill_into
    if draft is not None and draft is not model:
        del draft.paged_prefill_into
    outs.update({r: b.pop_result(r) for r in early})
    stats = b.stats()
    tokens = stats["generated_tokens"]
    window = [(p, SPEC_IDLE_NEW) for p, _ in traffic[:2]]

    def run_window():
        with torch.no_grad():
            for p, n in window:
                b.submit(p, n)
            b.run_until_done()
    passes = b.spec_stats["rounds"] + b.spec_stats["fallback_steps"] \
        if draft is not None else stats["steps"]
    rep = {"draft": None if draft is None else
           getattr(draft, "_spec_name", "draft"),
           "requests": len(traffic), "tokens": tokens, "wall_s": wall,
           "capture_s": log.capture_s,
           "tokens_per_s": tokens / wall,
           "tokens_per_s_without_captures": tokens / (wall - log.capture_s),
           "spec_stats": dict(b.spec_stats),
           "acceptance_rate": b.spec_stats["matched"]
           / max(b.spec_stats["proposed"], 1),
           "tokens_per_target_dispatch": tokens / max(passes, 1),
           "graphs": {k: [f.captures, f.replays] for k, (f, _) in zip(
               ("step", "verify", "draft_step", "catch_up"), fns)},
           "target_prefill_calls": calls[0],
           "draft_prefill_calls": dcalls[0] if dcalls is not calls else 0,
           "launches": graph_launches(counts, fns),
           "wrapper_counts": counts,
           "pages_leaked": b.audit_pages(),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           # a window of the first 2 prompts with SPEC_IDLE_NEW new tokens
           # after the run, timed, then again under the profiler
           "device_idle_share": idle_share(run_window)}
    # the wrapper counts what ran eagerly: each paged_prefill_into call
    # (admissions, the draft's mirrors, and the verify's and catch-up's
    # warm-ups and captures, which call it too) and the decode steps'
    # warm-ups and captures
    expect = rms_launches_per_call(model) * calls[0] + 2 * sum(
        n * f.captures for f, n in fns
        if f in (b._step_fn, getattr(b, "_dstep_fn", None)))
    if draft is not None and draft is not model:
        expect += rms_launches_per_call(draft) * dcalls[0]
    rep["rms_norm_wrapper_expected"] = expect
    seqs = [outs[r] for r in rids]
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return seqs, rep


def spec_check_batcher(what, rep, seqs, traffic):
    """Fail unless every request of a spec_batcher_run completed at full
    length with its prompt kept, no page leaked, no flash forward ran and
    the RMSNorm wrapper counted what ran eagerly (the report's expected
    count)."""
    for (p, n), s in zip(traffic, seqs):
        if len(s) != len(p) + n or not np.array_equal(s[:len(p)], p):
            fail(f"spec {what}: {len(s)} tokens for a prompt of {len(p)} "
                 f"and {n} new, or the prompt lost")
    if rep["pages_leaked"]:
        fail(f"spec {what}: {rep['pages_leaked']} pages leaked")
    if rep["wrapper_counts"]["flash_attention"]:
        fail(f"spec {what}: the paged path ran a flash forward")
    if rep["wrapper_counts"]["rms_norm"] != rep["rms_norm_wrapper_expected"]:
        fail(f"spec {what}: {rep['wrapper_counts']['rms_norm']} RMSNorm "
             f"wrapper launches, expected "
             f"{rep['rms_norm_wrapper_expected']}")


def phase_spec(seed, model, spread):
    """Parts A and B of the spec phase on `model` (serving_model:
    Llama-2-7B, bf16, 32 layers). A: generate_paged_speculative (a
    SPEC_PROMPT-token prompt, SPEC_NEW new tokens, draft_k SPEC_K, block
    SPEC_BLOCK, compile=True) with LLaMA-68M's shape, the target's first 2
    layers and the target itself as drafts, against generate_paged's greedy
    tokens (its decode step a graph); a round's device ms by part. B: the
    batcher phase's 24 requests through the graphed paged batcher
    (SPEC_BATCHER) without a draft, with the 68M draft and with the target
    as its own draft. Checks: every request completes at full length; no
    page leaks; no flash forward (the paged path's attention is plain);
    the RMSNorm wrapper counts 65 launches a target pass and 5 a draft pass
    that ran eagerly or in a graph's warm-up and capture, and RMSNorm ran
    in every run; tokens that leave the reference's lie, at each first
    difference, within twice the paged phase's bf16 spread (`spread`) of a
    float32 copy's top; the RMSNorm forward against its plain version at
    the verify's rows ([1, 5, 4096], [8, 5, 4096]) and the 68M draft's
    (768 wide: a prefill, the catch-up and a decode row), timed beside it,
    F.rms_norm and the bound. Returns (each run's launches, the replays'
    included; the RMSNorm records at those shapes)."""
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.ops.hopper import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    cfg = model.config
    vocab = cfg.vocab_size
    rng = np.random.RandomState(seed + SPEC_PROMPT)
    prompt = rng.randint(0, vocab, SPEC_PROMPT).astype(np.int64)
    ids = torch.from_numpy(prompt[None]).cuda()
    drafts = llama_drafts(seed, model)
    for n, d in drafts.items():
        d._spec_name = n
    counts, outs, recs = {}, {}, {}
    # the reference: greedy generate_paged, its decode step a graph
    with torch.no_grad():
        step = to_static(model.paged_decode_step, donate_args=(1,))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        ref = model.generate_paged(ids, SPEC_NEW, block_size=SPEC_BLOCK,
                                   decode_fn=step)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        counts["A generate_paged"] = graph_launches(
            launch_counts(), [(step, rms_launches_per_call(model))])
    ref_seq = ref[0].cpu().numpy()
    recs["generate_paged"] = {"tokens_per_s": SPEC_NEW / ref_wall,
                              "wall_s": ref_wall}
    for name, d in drafts.items():
        seq, rec = spec_standalone(model, d, ids, ref_seq, name)
        rec["round_device_ms"] = spec_round_split(model, d, ids, SPEC_NEW)
        rec["device_idle_share_from_rounds"] = idle_from_rounds(rec)
        emit({"phase": "spec", "part": "A", **rec})
        if len(seq) != SPEC_PROMPT + SPEC_NEW or \
                not np.array_equal(seq[:SPEC_PROMPT], prompt):
            fail(f"spec A {name}: {len(seq)} tokens")
        if rec["launches"]["rms_norm"] < 1 or \
                rec["launches"]["flash_attention"]:
            fail(f"spec A {name}: launches {rec['launches']}")
        outs[name], recs[name] = seq, rec
        counts[f"A {name}"] = rec["launches"]
    # B: the batcher phase's traffic
    traffic = batcher_traffic(seed, vocab)
    b_outs = {}
    for name, d in (("no draft", None), ("llama_68m", drafts["llama_68m"]),
                    ("self", model)):
        seqs, rep = spec_batcher_run(model, traffic, d)
        emit({"phase": "spec", "part": "B", "run": name, **rep})
        spec_check_batcher(f"B {name}", rep, seqs, traffic)
        if rep["launches"]["rms_norm"] < 1:
            fail(f"spec B {name}: no RMSNorm launch")
        b_outs[name], counts[f"B {name}"] = seqs, rep["launches"]
        recs[f"B {name}"] = rep
    # the tokens against the references, within twice the bf16 spread
    t_ref = time.perf_counter()
    ref_box, checks = [], {}
    with torch.no_grad():
        for name in drafts:
            checks[f"A {name}"] = tier_divergence(
                model, ref_box, [(SPEC_PROMPT, ref_seq, outs[name])])
        lens = [len(p) for p, _ in traffic]
        for name in ("llama_68m", "self"):
            checks[f"B {name}"] = tier_divergence(model, ref_box, [
                (n, a, b) for n, a, b in zip(lens, b_outs["no draft"],
                                             b_outs[name])])
    del ref_box
    gc.collect()
    torch.cuda.empty_cache()
    # the RMSNorm forward at this phase's new shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rms = [rms_timed(gen, shape) for shape in (
        (1, SPEC_K + 1, cfg.hidden_size),
        (SPEC_BATCHER["max_batch"], SPEC_K + 1, cfg.hidden_size),
        (1, SPEC_PROMPT, LLAMA_68M["hidden_size"]),
        (1, 2, LLAMA_68M["hidden_size"]),
        (SPEC_BATCHER["max_batch"], 1, LLAMA_68M["hidden_size"]))]
    del drafts
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "spec", "part": "A and B", "check": "tokens",
          "bf16_spread": spread, "pick_limit": 2 * spread,
          "generate_paged": recs["generate_paged"],
          "vs_reference": {k: {"differing_tokens": v[0],
                               "first_differences": v[1]}
                           for k, v in checks.items()},
          "rms_norm_new_shapes": rms,
          "token_check_s": time.perf_counter() - t_ref,
          "phase_s": time.perf_counter() - t_phase})
    over = [(k, r) for k, v in checks.items() for r in v[1]
            if max(r["below_top"]) > 2 * spread]
    if over:
        fail(f"spec: speculative picks leave the reference's by more than "
             f"twice the bf16 spread {spread}: {over}")
    return counts, rms


def spec_tier_probes(b, rec):
    """Wrap the spill callback and the chunk install of a draft-carrying
    batcher: the first TIER_PROBE_NODES demoted pages' rows in both pools
    are copied before their demotion and compared, byte for byte, with
    the rows of the page each is promoted into."""
    spill, install = b._read_page_blob, b._install_chunk
    tracked = {}

    def rows_of(page):
        return [torch.stack([t[page] for kv in state["layers"]
                             for t in kv]).clone()
                for state in (b._state, b._dstate)]

    def probed_spill(node):
        if len(tracked) < TIER_PROBE_NODES:
            tracked[id(node)] = rows_of(node.page)
        return spill(node)

    def probed_install(promo, chunk, staged):
        install(promo, chunk, staged)
        for node, page in zip(chunk["nodes"], chunk["pages"]):
            hit = tracked.pop(id(node), None)
            if hit is not None:
                rec["round_trips"].append([
                    bool(torch.equal(a.view(torch.int16),
                                     b_.view(torch.int16)))
                    for a, b_ in zip(rows_of(page), hit)])

    rec["round_trips"] = []
    b.prefix_cache._spill = probed_spill
    b._install_chunk = probed_install


def phase_spec_gpt2(seed):
    """Part C of the spec phase on gpt2_serving_model (bf16, 12 x 768,
    vocab 32000) with a draft of SPEC_GPT2_DRAFT_LAYERS layers at its
    width (random weights from --seed): generate_paged_speculative
    (compile=True) on gpt2_serve's 6 prompts against generate_paged's
    greedy tokens; gpt2_serve's traffic through the graphed paged batcher
    (SPEC_GPT2_BATCHER) without the draft and with it; the gateway drill
    (two graphed paged replicas, GW_PAGED with the prefix cache and the
    draft, chaos serving.step killing one mid-decode) against a lone
    batcher; a draft-carrying batcher with a host tier over tier_stream's
    churn, its promoted pages of both pools byte for byte. Checks: full
    lengths, no leaks, no kernel launched (GPT-2's paged attention and
    LayerNorm are plain), the drill's victim dead, requeues and every
    request finished, demotions and promotions, and tokens within twice
    the bf16 spread (bf16_spread against a float32 copy). Returns the
    launches."""
    from paddle_tpu_torch.inference import Gateway, PagedContinuousBatcher
    from paddle_tpu_torch.models import GPT2Config, GPT2ForCausalLM
    from paddle_tpu_torch.ops.hopper import (KERNELS, launch_counts,
                                             reset_launch_counts)
    from paddle_tpu_torch.resilience import arm_scenario, disarm
    t_phase = time.perf_counter()
    model = gpt2_serving_model(seed)
    model._spec_name = "gpt2"
    draft = GPT2ForCausalLM(GPT2Config(**dict(
        GPT2_SERVE_CFG, num_hidden_layers=SPEC_GPT2_DRAFT_LAYERS)),
        device="cuda", generator=torch.Generator(device="cuda")
        .manual_seed(seed + 6), seed=seed).eval()
    draft._spec_name = f"gpt2_{SPEC_GPT2_DRAFT_LAYERS}_layers"
    ref = GPT2ForCausalLM(GPT2Config(**dict(GPT2_SERVE_CFG,
                                            dtype="float32")),
                          device="cuda").eval()
    ref.load_state_dict(model.state_dict())
    vocab = model.config.vocab_size
    _, prompts = gpt2_traffic(seed, vocab)
    pairs, recs = {}, {}
    reset_launch_counts()
    with torch.no_grad():
        # standalone, each prompt
        std = []
        for p in prompts:
            ids = torch.from_numpy(p[None]).cuda()
            want = model.generate_paged(ids, GPT2_NEW, block_size=64)[0]
            with CaptureLog() as log:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, st = model.generate_paged_speculative(
                    ids, GPT2_NEW, draft, draft_k=SPEC_K, block_size=64,
                    compile=True, return_stats=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            std.append({"wall_s": wall, "capture_s": log.capture_s,
                        **st})
            pairs.setdefault("standalone", []).append(
                (len(p), want.cpu().numpy(), out[0].cpu().numpy()))
        tot = sum(r["wall_s"] for r in std)
        cap = sum(r["capture_s"] for r in std)
        recs["standalone"] = {
            "tokens_per_s": GPT2_NEW * len(prompts) / tot,
            "tokens_per_s_without_captures":
                GPT2_NEW * len(prompts) / (tot - cap),
            "acceptance_rate": sum(r["matched"] for r in std)
            / max(sum(r["proposed"] for r in std), 1),
            "tokens_per_target_dispatch": GPT2_NEW * len(prompts)
            / max(sum(r["rounds"] for r in std), 1),
            "per_prompt": std,
            "round_device_ms": spec_round_split(
                model, draft, torch.from_numpy(prompts[0][None]).cuda(),
                GPT2_NEW)}
        recs["standalone"]["device_idle_share_from_rounds"] = \
            idle_from_rounds({
                "spec_stats": {"rounds": sum(r["rounds"] for r in std)},
                "round_device_ms": recs["standalone"]["round_device_ms"],
                "wall_s": tot, "capture_s": cap})
        # the batcher
        traffic = [(p, GPT2_NEW) for p in prompts]
        plain, rep0 = spec_batcher_run(model, traffic, None,
                                       SPEC_GPT2_BATCHER)
        spec_check_batcher("C no draft", rep0, plain, traffic)
        spec, rep1 = spec_batcher_run(model, traffic, draft,
                                      SPEC_GPT2_BATCHER)
        spec_check_batcher("C draft", rep1, spec, traffic)
        recs["batcher no draft"], recs["batcher draft"] = rep0, rep1
        pairs["batcher"] = [(len(p), a, b) for (p, _), a, b in
                            zip(traffic, plain, spec)]
        # the gateway drill
        rng = np.random.RandomState(seed + 21)
        shared = rng.randint(0, vocab, 4 * GW_PAGED["block_size"])
        gw_prompts = [np.concatenate([shared, rng.randint(0, vocab, 16 + i)])
                      .astype(np.int64) for i in range(8)]

        def paged(d=draft):
            kw = dict(draft_model=d, draft_k=SPEC_K) if d is not None else {}
            return PagedContinuousBatcher(model, compile=True,
                                          prefix_cache=True, **GW_PAGED,
                                          **kw)
        gw = Gateway(policy="affinity")
        for i in range(GW_REPLICAS):
            gw.add_replica(f"r{i}", paged())
        gids = [gw.submit(p, GPT2_NEW) for p in gw_prompts]
        arm_scenario("seed=0; serving.step:transient_error:after=6,count=3")
        try:
            for _ in range(2000):
                gw.step()
                if any(not r.alive for r in gw.pool.replicas()):
                    break
        finally:
            disarm()
        survivor = next(r for r in gw.pool.replicas() if r.alive)
        hits = survivor.batcher.prefix_cache.hit_tokens
        for _ in range(5000):
            if not gw._has_work():
                break
            gw.step()
        gout = [gw.pop_result(g) for g in gids]
        recs["gateway"] = {
            "alive": {r.name: r.alive for r in gw.pool.replicas()},
            "stats": gw.stats(),
            "survivor_rehit_tokens": survivor.batcher.prefix_cache
            .hit_tokens - hits,
            "spec_stats": {r.name: dict(r.batcher.spec_stats)
                           for r in gw.pool.replicas()},
            "audit_pages": {r.name: r.batcher.audit_pages()
                            for r in gw.pool.replicas() if r.alive}}
        del gw
        lone = paged(None)
        lrids = [lone.submit(p, GPT2_NEW) for p in gw_prompts]
        louts = lone.run_until_done()
        pairs["gateway"] = [(len(p), louts[r], o) for p, r, o in
                            zip(gw_prompts, lrids, gout)]
        del lone
        # the tiers with a draft
        prefixes, tier_prompts = tier_stream(seed, vocab)
        tier_prompts = tier_prompts[:SPEC_TIER_PROMPTS]
        tb = PagedContinuousBatcher(model, compile=True, host_kv_gib=1.0,
                                    draft_model=draft, draft_k=SPEC_K,
                                    **SPEC_TIER_CFG)
        probes = {}
        spec_tier_probes(tb, probes)
        try:
            for p in prefixes:
                tb.submit(p, TIER_NEW)
            tb.run_until_done()
            trids = [tb.submit(p, TIER_NEW) for p in tier_prompts]
            touts = tb.run_until_done()
            recs["tiers"] = {"cache": tb.prefix_cache.stats(),
                             "spec_stats": dict(tb.spec_stats),
                             "probes": probes,
                             "audit_pages": tb.audit_pages(),
                             "tiers_audit": tb.prefix_cache.audit_tiers()}
            if any(len(touts[r]) != len(p) + TIER_NEW
                   for r, p in zip(trids, tier_prompts)):
                fail("spec C tiers: a request did not complete")
        finally:
            tb.close()
            del tb
        launches = launch_counts()
        seqs = [a for _, a, _ in pairs["standalone"]]
        spread, own, _ = bf16_spread(model, ref, seqs,
                                     [n for n, _, _ in pairs["standalone"]])
        diffs = {k: divergence(ref, v) for k, v in pairs.items()}
    del model, draft, ref
    gc.collect()
    torch.cuda.empty_cache()
    gwr, tr = recs["gateway"], recs["tiers"]
    emit({"phase": "spec", "part": "C", **recs, "bf16_spread": spread,
          "own_full_forward_gap": own,
          "vs_reference": {k: {"differing_tokens": d[0],
                               "first_differences": d[1]}
                           for k, d in diffs.items()},
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    if list(gwr["alive"].values()).count(False) != 1 or \
            gwr["stats"]["requeued"] < 1 or gwr["stats"]["failures"] or \
            any(gwr["audit_pages"].values()):
        fail(f"spec C gateway drill: {gwr}")
    if tr["cache"]["demotions"] < 1 or tr["cache"]["promotions"] < 1 or \
            not tr["probes"]["round_trips"] or \
            not all(all(t) for t in tr["probes"]["round_trips"]) or \
            tr["audit_pages"]:
        fail(f"spec C tiers: {tr}")
    over = [(k, r) for k, d in diffs.items() for r in d[1]
            if max(r["below_top"]) > 2 * spread]
    if over:
        fail(f"spec C: picks leave their references by more than twice "
             f"the bf16 spread {spread}: {over}")
    if launches != dict.fromkeys(KERNELS, 0):
        fail(f"spec C launched {launches}")
    return launches


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

    expect = dict.fromkeys(launches, 0)
    expect.update({"flash_attention": 2 * layers,
                   "flash_attention_bwd_dq": layers,
                   "flash_attention_bwd_dkv": layers,
                   "rms_norm": 4 * layers + 1,
                   "rms_norm_bwd": 2 * layers + 1,
                   "adamw": 9 * layers + 3})
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
    rms_vector_only(profile, "train", ["rms_norm_bwd_vec", "rms_norm_dw_sum",
                                       "rms_norm_fwd_vec"])
    # bf16 gradients go through the tensor-core builds, never the float32
    # FMA kernels (flash_bwd_dq_kernel, flash_bwd_dkv_kernel)
    if profile["flash_bwd_kernels"] != ["flash_bwd_dkv_wgmma",
                                        "flash_bwd_dq_wgmma"]:
        fail(f"train backward kernels {profile['flash_bwd_kernels']}, "
             "expected the wgmma builds only")
    # and the forward (twice a layer, with recompute) through the tensor-core
    # build, never the float32 FMA kernel (flash_fwd_kernel)
    if profile["flash_fwd_kernels"] != ["flash_fwd_wgmma"]:
        fail(f"train forward kernels {profile['flash_fwd_kernels']}, "
             "expected the wgmma build only")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    return launches, profile


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


# sessions the sparse phase's profile may take (see phase_sparse)
SPARSE_PROFILE_SESSIONS = 3


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
    # three calls in one session: the check rests on more than one trace
    # record, and the first calls' kernels lie well inside the window. A
    # session this late in the process may come back with no device
    # record at all (PERF.md); the calls have no side effects, so such a
    # session is run again, up to twice, its launches counted afresh
    for session in range(1, SPARSE_PROFILE_SESSIONS + 1):
        reset_launch_counts()
        with torch.no_grad():
            prof = profile_one(
                lambda: FE.sparse_attention(q, k, v, offs, cols), calls=3)
        if prof["device_ms"] != "not measured":
            break
    rec["profile_sessions"] = session
    if launch_counts()["block_sparse_attention"] != 3 or \
            prof["block_sparse_kernels"] != ["block_sparse_fwd_wgmma"]:
        fail(f"sparse kernels {prof['block_sparse_kernels']} over "
             f"{launch_counts()['block_sparse_attention']} launches, expected "
             f"the wgmma build; the profile: {prof}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec.update({
        "kernels": prof["block_sparse_kernels"],
        "profiled_kernels": sum(n for key, _, n in prof["top"]
                                if "block_sparse_fwd" in key),
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


# -- phase 7 -----------------------------------------------------------------

def gpt2_model(device, seed, weights_seed):
    """GPT-2 124M (gpt2_124m_config: dropout 0.1) on `device`, its weights
    from a generator there seeded with `weights_seed`, its dropout
    generators seeded with `seed`."""
    from paddle_tpu_torch.models import GPT2ForCausalLM, gpt2_124m_config
    return GPT2ForCausalLM(gpt2_124m_config(), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(weights_seed), seed=seed)


def phase_gpt2_width(seed):
    """GPT-2 124M at all 12 layers: loss and every parameter's grad of one
    4 x 512-token batch, on the card (bf16 O2, kernels: the flash dropout
    builds) against the CPU (float32, plain versions) from the same float32
    weights. Attention dropout is 0.1 on both sides, its mask the same
    hash of the same seeds (each model's CPU seed generator); the residual
    and embedding dropouts are set to 0 on both, since torch's CPU and CUDA
    generators draw different masks. Tolerances: the Llama train_width
    phase's, loss within 1e-3 relative and each grad within 6% in norm."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import Dropout
    from paddle_tpu_torch.ops.hopper import launch_counts, \
        reset_launch_counts
    card = gpt2_model("cuda", seed + 12, seed)
    ref = gpt2_model("cpu", seed + 12, seed)
    ref.load_state_dict(card.state_dict())      # float32 copies
    for m in (card, ref):
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
    amp.decorate(card, level="O2", dtype="bfloat16")
    cfg = card.config
    gen = torch.Generator().manual_seed(seed + 13)
    ids = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen)
    reset_launch_counts()
    _, loss = card(ids.cuda(), labels=labels.cuda())
    loss.backward()
    torch.cuda.synchronize()
    launches = {n: c for n, c in launch_counts().items() if c}
    t0 = time.perf_counter()
    _, ref_loss = ref(ids, labels=labels)
    ref_loss.backward()
    cpu_s = time.perf_counter() - t0
    rel, bad = {}, []
    for (name, p), (_, r) in zip(card.named_parameters(),
                                 ref.named_parameters()):
        if p.grad is None or not bool(p.grad.abs().sum() > 0):
            bad.append(name)
            continue
        rel[name] = float((p.grad.float().cpu() - r.grad).norm()
                          / r.grad.norm())
    layers = cfg.num_hidden_layers
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    rec = {"phase": "gpt2_width", "layers": layers, "batch": [4, 512],
           "attention_dropout": cfg.dropout, "loss": loss,
           "ref_loss": ref_loss, "cpu_s": cpu_s,
           "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
           "loss_tol_rel": 1e-3,
           "grad_tol_rel": 0.06, "params": len(rel) + len(bad),
           "missing_or_zero_grads": bad, "launches": launches,
           "worst_grad_rel_err": sorted(rel.items(), key=lambda t: -t[1])[:5]}
    emit(rec)
    expect = {"flash_attention_dropout": layers,
              "flash_attention_bwd_dq_dropout": layers,
              "flash_attention_bwd_dkv_dropout": layers}
    if bad or rec["loss_rel_err"] > 1e-3 or max(rel.values()) > 0.06 or \
            launches != expect:
        fail(f"gpt2 width: card and CPU disagree: {rec}")
    del card, ref
    torch.cuda.empty_cache()


def phase_gpt2_train(seed):
    """benchmarks/bench_gpt2.py's path at GPT-2 124M, nothing cut: batch 8 x
    512, dropout 0.1, AdamW lr 1e-4 (weight decay 0.01 on every parameter)
    with float32 masters, amp.decorate O2 bf16, TrainStep; 2 warm steps,
    then 10 timed. The launch counts of one step prove the dropout builds
    of the flash kernels ran (12 each) and AdamW's 148; the profile of one
    step that its attention ran the bf16 tensor-core dropout builds only."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.hopper import launch_counts, \
        reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    batch, seq, warm, steps = 8, 512, 2, 10
    t0 = time.perf_counter()
    model = gpt2_model("cuda", seed + 14, seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    cfg = model.config
    n_params = model.num_params()
    n_tensors = len(list(model.parameters()))
    step = TrainStep(lambda i, lab: model(i, labels=lab)[1], opt)
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = [], [], None
    for i in range(warm + steps):
        if i == warm:
            reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(ids, labels))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == warm:
            launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    profile = profile_one(lambda: step(ids, labels))
    layers = cfg.num_hidden_layers
    expect = dict.fromkeys(launches, 0)
    expect.update({"flash_attention_dropout": layers,
                   "flash_attention_bwd_dq_dropout": layers,
                   "flash_attention_bwd_dkv_dropout": layers,
                   "adamw": n_tensors})
    timed = step_ms[warm:]
    median_ms = sorted(timed)[len(timed) // 2]
    tokens_per_s = batch * seq / (median_ms / 1e3)
    # bench.py's model FLOPs: 6 P per token plus the attention terms
    flops_per_token = 6 * n_params + 12 * layers * cfg.hidden_size * seq
    idle = ("not measured" if profile["device_ms"] == "not measured"
            else 1 - profile["device_ms"] / median_ms)
    builds = profile["flash_builds"]
    emit({"phase": "gpt2_train", "layers": layers, "batch": batch,
          "seq": seq, "params": n_params, "param_tensors": n_tensors,
          "dropout": cfg.dropout, "init_s": init_s, "step_ms": step_ms,
          "median_step_ms": median_ms, "tokens_per_s": tokens_per_s,
          "mfu": tokens_per_s * flops_per_token / H100_BF16_FLOPS,
          "peak_memory_gib": peak_gib, "device_idle_share": idle,
          "losses": losses, "launches_per_step": launches,
          "profile_step": profile})
    if n_tensors != 148 or launches != expect:
        fail(f"gpt2 train: {n_tensors} parameter tensors, launch counts "
             f"{launches}, expected {expect}")
    # the bf16 tensor-core dropout builds, each over many records, and no
    # FMA build or build without dropout
    if profile["flash_fwd_kernels"] != ["flash_fwd_wgmma"] or \
            profile["flash_bwd_kernels"] != ["flash_bwd_dkv_wgmma",
                                             "flash_bwd_dq_wgmma"] or \
            len(builds) != 3 or not all(dropout_build(b) and n > 1
                                        for b, n in builds.items()):
        fail(f"gpt2 train attention builds {builds}, expected the three "
             "wgmma dropout builds only")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"gpt2 train losses not finite and falling: {losses}")
    del model, opt, step
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
    phase_routing(args.seed)
    phase_width(args.seed)
    phase_train_width(args.seed)
    phase_train_width(args.seed, masked=True)
    phase_gpt2_width(args.seed)
    serve = phase_serve(args.seed)
    model = serving_model(args.seed)
    batcher, dense_tokens = phase_batcher(args.seed, model)
    paged, spread, run_a = phase_paged(args.seed, model, dense_tokens)
    fused = phase_fused(args.seed, model, spread, run_a)
    quant = phase_quant(args.seed, model, spread)
    tiers = phase_tiers(args.seed, model, spread)
    spec, spec_rms = phase_spec(args.seed, model, spread)
    del model, dense_tokens, run_a
    torch.cuda.empty_cache()
    gpt2_serve = phase_gpt2_serve(args.seed)
    gateway = phase_gateway(args.seed)
    tiers["sessions and gateway"] = phase_tiers_sessions(args.seed)
    spec["C gpt2"] = phase_spec_gpt2(args.seed)
    train, train_profile = phase_train(args.seed)
    packed, _ = phase_train(args.seed, packed=True)
    gpt2 = phase_gpt2_train(args.seed)
    sparse = phase_sparse(args.seed)
    for k in kernels:
        # the forward kernels per generate (and per train step, beside);
        # the backward and AdamW kernels per train step; block-sparse per
        # sparse_attention call; the dropout builds per GPT-2 train step
        name = k["name"]
        if sparse[name]:
            k["launches"] = sparse[name]
        elif serve[name]:
            k["launches"] = serve[name]
            k["launches_per_train_step"] = train[name]
        elif gpt2[name] and not train[name]:
            k["launches"] = gpt2[name]
        else:
            k["launches"] = train[name]
        if packed[name]:
            k["launches_per_packed_train_step"] = packed[name]
        if batcher["eager"][name]:
            # per batcher run; graphed, the replays' launches included (the
            # wrapper counts at capture, not at replay: its count beside)
            k["launches_per_batcher_run"] = {m: batcher[m][name]
                                             for m in ("eager", "graphed")}
            k["wrapper_counts_graphed_batcher_run"] = \
                batcher["graphed_wrapper_counts"][name]
        if paged["A eager"][name]:
            # per paged batcher run (graphed: the replays' included) and
            # per generate_paged
            k["launches_per_paged_run"] = {
                m: paged[m][name] for m in ("A eager", "A graphed",
                                            "B graphed", "B plain",
                                            "generate_paged")}
            # per fused run (the replays' included)
            k["launches_per_fused_run"] = {m: c[name]
                                           for m, c in fused.items()}
        if gpt2[name] and train[name]:
            k["launches_per_gpt2_train_step"] = gpt2[name]
        if gpt2_serve["generate"][name]:
            # GPT-2 serving: per generate and per dense batcher run (the
            # paged runs launch no kernel)
            k["launches_per_gpt2_serving"] = {
                m: c[name] for m, c in gpt2_serve.items()}
        quant_runs = {f"{part} {run}": c[name]
                      for part, runs in quant.items()
                      for run, c in runs.items() if c[name]}
        if quant_runs:
            # int8 serving: GPT-2's calibration and generates (the flash
            # forward), Llama's calibration and int8-page Run A (graphed:
            # the replays' RMSNorm launches included)
            k["launches_per_quant_run"] = quant_runs
        # per tiers run: part A's three Llama-2-7B churns (graphed: the
        # replays' launches included), parts B and C on GPT-2
        k["launches_per_tier_run"] = {run: c[name]
                                      for run, c in tiers.items()}
        # per spec run: part A's generate_paged and speculative calls and
        # part B's batcher runs at Llama-2-7B (graphed: the replays'
        # launches included), part C on GPT-2
        k["launches_per_spec_run"] = {run: c[name]
                                      for run, c in spec.items()}
        if name == "rms_norm":
            # the verify's rows and the 68M draft's width, timed
            k["spec_shapes"] = spec_rms
        if any(gateway[name].values()):
            # per gateway window of 12 requests over two graphed dense
            # replicas, by policy, and in the failover run
            k["launches_per_gateway_run"] = gateway[name]
        if name == "rms_norm_bwd":
            # its two kernels apart: device ms per launch in the profiled
            # train step, whose norms are [8192, 4096] bf16
            apart = {b: ms / n for b, (ms, n)
                     in train_profile["rms_norm_builds"].items()
                     if "_bwd_" in b or "_dw_" in b}
            k["row_pass_ms"] = next((v for b, v in apart.items()
                                     if "_bwd_" in b), "not measured")
            k["column_sum_ms"] = next((v for b, v in apart.items()
                                       if "_dw_" in b), "not measured")
            k["apart_from"] = "the profiled train step"
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

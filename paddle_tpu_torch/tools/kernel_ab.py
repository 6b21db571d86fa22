"""Kernel times of two checkouts of the port, on one Hopper card.

    python3 -m paddle_tpu_torch.tools.kernel_ab --trees PARENT CHANGE \
        [--pairs 2] [--seed 0]

Two versions of a kernel are compared only within one call on one card
(cards differ in power limit and neighbours). This script starts one
process per run, the trees in turns (A B, then B A, ...), each importing
``paddle_tpu_torch`` from its own checkout and building its own kernels.
Each process times, with CUDA events around each call after an L2 flush,
median of 10 (``chip_smoke.time_ms``), at ``chip_smoke.py``'s shapes:

- the flash forward at the serve shape, q, k, v [4, 512, 32, 128] bf16
  causal (``fwd_serve``), and at the train shape [4, 2048, 32, 128] bf16
  causal (``fwd_causal``) and non-causal under a float32 packed-document
  mask [4, 1, 2048, 2048] (``fwd_masked``; documents of 256-1024 tokens
  from --seed);
- the dQ and the dK/dV kernels at the train shape, causal and masked;
- the block-sparse forward at q, k, v [4, 4096, 12, 64] bf16 under the
  BigBird-base tile pattern (``chip_smoke.bigbird_tiles``, from --seed);
- the RMSNorm forward at x [2048, 4096] (prefill), [8192, 4096] (a train
  step's rows) and [4, 1, 4096] (decode), bf16, and its backward (row pass
  and column sum, one counted launch) at [8192, 4096], and the two
  kernels of the backward apart: device ms per launch over 10 calls in one
  ``torch.profiler`` session (L2 not flushed; "not measured" when the
  session records no device activity);
- the RMSNorm backward's general build at [8192, 4096] bf16: x and g views
  two bytes into their buffers (``rms_bwd_general_ms``).

It prints one JSON line per run, then a summary: each tree's medians over
its runs and the ratio of the first tree's to the second's.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

B, S, H, D = 4, 2048, 32, 128


def time_ms(fn, iters=10):
    """Median device time of one call, L2 flushed before each (as
    ``chip_smoke.time_ms``)."""
    import torch
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def packed_doc_mask(seed):
    """The float32 additive mask [B, 1, S, S] of documents of 256-1024
    tokens packed into each row (as ``chip_smoke.packed_doc_mask``)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    doc = np.zeros((B, S), np.int64)
    for r in range(B):
        start, n_docs = 0, 0
        while start < S:
            n = min(int(rng.randint(256, 1025)), S - start)
            doc[r, start:start + n] = n_docs
            start, n_docs = start + n, n_docs + 1
    ids = torch.from_numpy(doc).cuda()
    keep = (ids[:, :, None] == ids[:, None, :]) & torch.ones(
        S, S, dtype=torch.bool, device="cuda").tril()
    mask = torch.zeros(B, 1, S, S, device="cuda")
    return mask.masked_fill_(~keep[:, None], -1e9)


def bigbird_tiles(nb, seed):
    """BigBird-base's tile pattern (as ``chip_smoke.bigbird_tiles``)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    bm = np.zeros((nb, nb), bool)
    bm[[0, -1], :] = True
    bm[:, [0, -1]] = True
    for r in range(1, nb - 1):
        bm[r, r - 1:r + 2] = True
        bm[r, rng.choice(np.flatnonzero(~bm[r]), 3, replace=False)] = True
    return bm


def worker(seed):
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.ops.hopper import (block_sparse_attention_fwd,
                                             flash_attention,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             rms_norm, rms_norm_bwd)
    from paddle_tpu_torch.ops.hopper.flash_attention import _delta
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rec = {"package": os.path.dirname(paddle_tpu_torch.__file__)}
    q, k, v = (torch.randn(B, 512, H, D, generator=gen, device="cuda")
               .to(bf16) for _ in range(3))
    rec["fwd_serve_ms"] = time_ms(lambda: flash_attention(q, k, v, True))
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                     .to(bf16) for _ in range(4))
    for label, causal, mask in (("causal", True, None),
                                ("masked", False, packed_doc_mask(seed))):
        rec[f"fwd_{label}_ms"] = time_ms(
            lambda: flash_attention(q, k, v, causal, mask))
        out, lse = flash_attention(q, k, v, causal, mask)
        delta = _delta(out, dout)
        rec[f"{label}_dq_ms"] = time_ms(lambda: flash_attention_bwd_dq(
            q, k, v, dout, lse, delta, causal, mask))
        rec[f"{label}_dkv_ms"] = time_ms(lambda: flash_attention_bwd_dkv(
            q, k, v, dout, lse, delta, causal, mask))
    del q, k, v, dout, out, lse, delta
    bm = bigbird_tiles(32, seed)
    q, k, v = (torch.randn(4, 4096, 12, 64, generator=gen, device="cuda")
               .to(bf16) for _ in range(3))
    rec["block_sparse_ms"] = time_ms(
        lambda: block_sparse_attention_fwd(q, k, v, bm))
    del q, k, v
    w = (1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")).to(bf16)
    for label, shape in (("prefill", (2048, 4096)), ("train", (8192, 4096)),
                         ("decode", (4, 1, 4096))):
        x = torch.randn(*shape, generator=gen, device="cuda").to(bf16)
        rec[f"rms_fwd_{label}_ms"] = time_ms(lambda: rms_norm(x, w, 1e-5))
    x, g = (torch.randn(8192, 4096, generator=gen, device="cuda").to(bf16)
            for _ in range(2))
    _, rstd = rms_norm(x, w, 1e-5)
    rec["rms_bwd_train_ms"] = time_ms(lambda: rms_norm_bwd(x, w, g, rstd))
    rec.update(rms_bwd_apart(lambda: rms_norm_bwd(x, w, g, rstd)))
    del x, g
    x, g = (torch.randn(8192 * 4096 + 1, generator=gen, device="cuda")
            .to(bf16)[1:].view(8192, 4096) for _ in range(2))
    _, rstd = rms_norm(x, w, 1e-5)
    rec["rms_bwd_general_ms"] = time_ms(lambda: rms_norm_bwd(x, w, g, rstd))
    print(json.dumps(rec), flush=True)


def rms_bwd_apart(fn, calls=10):
    """Device ms per launch of the RMSNorm backward's row pass and of its
    column sum (the kernel named ``rms_norm_dw_*``), from one profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"rms_bwd_row_pass_ms": "not measured",
           "rms_bwd_column_sum_ms": "not measured"}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "rms_norm_" in e.key and \
                e.self_device_time_total > 0:
            key = ("rms_bwd_column_sum_ms" if "rms_norm_dw_" in e.key
                   else "rms_bwd_row_pass_ms")
            out[key] = e.self_device_time_total / 1e3 / e.count
    return out


def run_tree(tree, seed):
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--seed", str(seed)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"kernel_ab: the run in {tree} failed")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    if not rec["package"].startswith(tree + os.sep):
        raise SystemExit(f"kernel_ab: {tree} imported {rec['package']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.seed)
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    trees = [os.path.abspath(t) for t in args.trees]
    runs = {t: [] for t in trees}
    for i in range(args.pairs):
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            rec = run_tree(tree, args.seed)
            runs[tree].append(rec)
            print(json.dumps({"tree": tree, **rec}), flush=True)
    keys = [k for k in runs[trees[0]][0] if k.endswith("_ms") and all(
        isinstance(r[k], float) for t in trees for r in runs[t])]
    med = {t: {k: statistics.median(r[k] for r in runs[t]) for k in keys}
           for t in trees}
    print(json.dumps({"medians": med, "ratio_first_over_second": {
        k: med[trees[0]][k] / med[trees[1]][k] for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

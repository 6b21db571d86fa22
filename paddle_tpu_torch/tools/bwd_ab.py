"""Flash attention backward kernel times of two checkouts of the port, on
one Hopper card.

    python3 -m paddle_tpu_torch.tools.bwd_ab --trees PARENT CHANGE \
        [--pairs 2] [--seed 0]

Two versions of a kernel are compared only within one call on one card
(cards differ in power limit and neighbours). This script starts one
process per run, the trees in turns (A B, then B A, ...), each importing
``paddle_tpu_torch`` from its own checkout and building its own kernels.
Each process times the dQ and the dK/dV kernel at the train phase's shape
of ``chip_smoke.py``, q, k, v [4, 2048, 32, 128] bf16, causal and then
non-causal under a float32 packed-document mask [4, 1, 2048, 2048]
(documents of 256-1024 tokens from --seed), with CUDA events around each
call after an L2 flush, median of 10 (``chip_smoke.time_ms``). It prints
one JSON line per run, then a summary: each tree's medians over its runs
and the ratio of the first tree's to the second's.
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


def worker(seed):
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq)
    from paddle_tpu_torch.ops.hopper.flash_attention import _delta
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))
    rec = {"package": os.path.dirname(paddle_tpu_torch.__file__)}
    for label, causal, mask in (("causal", True, None),
                                ("masked", False, packed_doc_mask(seed))):
        out, lse = flash_attention(q, k, v, causal, mask)
        delta = _delta(out, dout)
        rec[f"{label}_dq_ms"] = time_ms(lambda: flash_attention_bwd_dq(
            q, k, v, dout, lse, delta, causal, mask))
        rec[f"{label}_dkv_ms"] = time_ms(lambda: flash_attention_bwd_dkv(
            q, k, v, dout, lse, delta, causal, mask))
    print(json.dumps(rec), flush=True)


def run_tree(tree, seed):
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--seed", str(seed)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"bwd_ab: the run in {tree} failed")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    if not rec["package"].startswith(tree + os.sep):
        raise SystemExit(f"bwd_ab: {tree} imported {rec['package']}")
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
    keys = [k for k in runs[trees[0]][0] if k.endswith("_ms")]
    med = {t: {k: statistics.median(r[k] for r in runs[t]) for k in keys}
           for t in trees}
    print(json.dumps({"medians": med, "ratio_first_over_second": {
        k: med[trees[0]][k] / med[trees[1]][k] for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

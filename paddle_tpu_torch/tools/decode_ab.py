"""Decode step time of two checkouts of the port, on one Hopper card.

    python3 -m paddle_tpu_torch.tools.decode_ab --trees PARENT CHANGE \
        [--seed 0]

Decode is host-bound, and its host time moves between processes by more
than a change to the host path does, so one run of each tree tells
nothing. This script starts one process per run, 10 pairs of runs,
alternating the trees (A B, then B A, ...), each importing ``paddle_tpu_torch`` from its own
checkout. Each process builds Llama-2-7B (bf16, 32 layers, random weights
from --seed), prefills 4 prompts of 512 tokens and times 31 greedy decode
steps (host clock around synchronised steps, the serve phase of
``chip_smoke.py``), 3 times after one warm run. It prints one
JSON line per run, then a summary: each tree's run medians, and the paired
differences (second tree minus first) of the runs next to each other.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH, PROMPT, NEW = 4, 512, 32
PAIRS, REPEATS = 10, 3


def worker(seed):
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b_config
    cfg = llama2_7b_config(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(seed))
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                        generator=torch.Generator().manual_seed(seed + 1)
                        ).cuda()
    runs = []
    with torch.no_grad():
        for _ in range(REPEATS + 1):
            logits, caches, t = model.prefill(ids, PROMPT + NEW)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(NEW - 1):
                logits, caches, t = model.decode_step(tok, caches, t)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / (NEW - 1))
    print(json.dumps({"package": os.path.dirname(paddle_tpu_torch.__file__),
                      "decode_ms_per_step": runs[1:]}), flush=True)


def run_tree(tree, seed):
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--seed", str(seed)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"decode_ab: the run in {tree} failed")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    if not rec["package"].startswith(tree + os.sep):
        raise SystemExit(f"decode_ab: {tree} imported {rec['package']}")
    return rec["decode_ms_per_step"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.seed)
        return 0
    if args.trees is None:
        ap.error("--trees A B is required")
    trees = [os.path.realpath(t) for t in args.trees]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    medians = {0: [], 1: []}
    for i in range(PAIRS):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            runs = run_tree(trees[side], args.seed)
            medians[side].append(statistics.median(runs))
            print(json.dumps({"pair": i, "tree": args.trees[side],
                              "decode_ms_per_step": runs,
                              "median": medians[side][-1]}), flush=True)
    diffs = [b - a for a, b in zip(medians[0], medians[1])]
    print(json.dumps({
        "trees": args.trees, "pairs": PAIRS,
        "median_ms": [statistics.median(medians[s]) for s in (0, 1)],
        "min_ms": [min(medians[s]) for s in (0, 1)],
        "max_ms": [max(medians[s]) for s in (0, 1)],
        "paired_diff_ms": diffs,
        "paired_diff_median_ms": statistics.median(diffs),
        "second_slower_in": sum(d > 0 for d in diffs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

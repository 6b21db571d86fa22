"""The RMSNorm forward under explicit plans, on one Hopper card.

    python3 -m paddle_tpu_torch.tools.rms_variants [--seed 0]

``fused_ops.rms_fwd_plan`` picks a build per call; this script runs the
C entry point under other plans too, to see what the choice is worth: x
[2048, 4096], [8192, 4096] and [4, 1, 4096] bf16 under (vectors a thread,
threads a block) = (1, 512), (4, 128), (4, 256), (8, 64) and the general
build (0, 256). Each variant is first checked against the plain version
(one bf16 ulp at the largest magnitude, as ``chip_smoke.tolerance``), then
timed (``kernel_ab.time_ms``: CUDA events, L2 flushed, median of 10).

It prints one JSON line per shape, the wrapper's own plan under "plan".
"""
from __future__ import annotations

import argparse
import json
import sys

from .kernel_ab import time_ms

FWD = ((1, 512), (4, 128), (4, 256), (8, 64), (0, 256))


def ulp_tol(ref):
    return max(1.0, float(ref.float().abs().max())) * 2.0 ** -7


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    from ..ops.hopper import _build, fused_ops as fo
    lib = _build.load("rms_norm", fo._RMS_SIGNATURES)
    bf16, h = torch.bfloat16, 4096
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    sms = fo._sm_count(torch.cuda.current_device())
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(bf16)
    code = fo._DTYPE_CODES[bf16]
    bad = []

    for shape in ((2048, h), (8192, h), (4, 1, h)):
        x = torch.randn(*shape, generator=gen, device="cuda").to(bf16)
        rows = x.numel() // h
        y = torch.empty_like(x)
        r = torch.empty(rows, device="cuda")
        ref, _ = fo.rms_norm_plain(x, w, 1e-5)
        rec = {"forward": list(shape),
               "plan": list(fo.rms_fwd_plan(rows, h, bf16, True, sms))}
        for vpt, threads in FWD:
            def run(vpt=vpt, threads=threads):
                err = lib.rms_norm_fwd(x.data_ptr(), w.data_ptr(),
                                       y.data_ptr(), r.data_ptr(), rows, h,
                                       1e-5, code, vpt, threads, sms,
                                       fo._stream(x))
                _build.check(lib, err, "rms_norm_fwd")
            run()
            torch.cuda.synchronize()
            if float((y.float() - ref.float()).abs().max()) > ulp_tol(ref):
                bad.append(("forward", shape, vpt, threads))
            rec[f"{vpt}x{threads}_ms"] = time_ms(run)
        print(json.dumps(rec), flush=True)

    if bad:
        print(json.dumps({"disagree_with_plain": bad}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

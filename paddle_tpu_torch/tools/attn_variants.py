"""Time attention kernels built from several copies of their source, on one
Hopper card.

    python3 -m paddle_tpu_torch.tools.attn_variants A.cu B.cu [...] \
        [--seed 0]

Versions of a kernel are compared within one call on one card (cards
differ in power limit and neighbours). Each argument is a copy of one of
``paddle_tpu_torch/ops/hopper/csrc/flash_attention.cu`` (the forward),
``flash_attention_bwd.cu`` (dQ and dK/dV) or ``block_sparse_attention.cu``;
a copy includes the headers beside it first, then the package's. Every
copy is built with ``nvcc`` and the package's flags, all at once, into a
temporary directory; each build's ptxas notes (spills, serialised
``wgmma``) are printed. Then each copy's kernels are checked against their
plain versions (one bf16 ulp at the largest magnitude,
``chip_smoke.tolerance``) and timed (``kernel_ab.time_ms``), the copies in
turn, at ``kernel_ab.py``'s shapes: the forward at [4, 512, 32, 128] bf16
causal and at [4, 2048, 32, 128] causal, non-causal and non-causal under
the float32 packed-document mask; dQ and dK/dV at [4, 2048, 32, 128]
causal, non-causal and masked; block-sparse at [4, 4096, 12, 64] under
the BigBird pattern. One JSON line per copy.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile

from .kernel_ab import B, D, H, S, bigbird_tiles, packed_doc_mask, time_ms

KERNELS = r"(flash_fwd_wgmma|flash_bwd_\w+?_wgmma|block_sparse_fwd_wgmma)"
# the flash entry points' dropout arguments (flag, threshold, scale, seed)
# for the builds without dropout
NO_DROPOUT = (0, 0, 1.0, 0)


def ptxas_notes(log):
    """Spill and serialisation notes per tensor-core build, from nvcc's
    -Xptxas -v output."""
    notes, build = [], None
    for ln in log.splitlines():
        m = re.search(KERNELS + r"I((?:L[ib]\d+E)+)E", ln)
        name = m and "{}<{}>".format(
            m[1], ", ".join(re.findall(r"L[ib](\d+)E", m[2])))
        if "Compiling entry function" in ln:
            build = name
        elif "serialized" in ln and name:
            notes.append(f"{name}: " + ln.split(":", 1)[-1].strip())
        elif build and re.search(r"[1-9]\d* bytes spill stores", ln):
            notes.append(f"{build}: {ln.strip()}")
    return notes


def build_all(sources, out_dir):
    """{source: ctypes library} after building every copy at once."""
    from paddle_tpu_torch.ops.hopper import _build
    procs = {}
    for i, src in enumerate(sources):
        lib = os.path.join(out_dir, f"variant{i}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", lib, src]
        procs[src] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for src, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"attn_variants: {src} failed to build:\n"
                             f"{log[-4000:]}")
        print(json.dumps({"source": src, "ptxas": ptxas_notes(log)}),
              flush=True)
        libs[src] = ctypes.CDLL(path)
    return libs


def within(got, ref):
    """One bf16 ulp at the largest magnitude (``chip_smoke.tolerance``)."""
    return float((got.float() - ref.float()).abs().max()) <= \
        max(1.0, float(ref.float().abs().max())) * 2.0 ** -7


def forward_cases(libs, gen, seed, rec_of):
    import torch

    from paddle_tpu_torch.ops.hopper import flash_attention_plain
    from paddle_tpu_torch.ops.hopper.flash_attention import _SIGNATURES
    stream = torch.cuda.current_stream().cuda_stream
    for label, s, causal, mask in (
            ("serve", 512, True, None), ("causal", S, True, None),
            ("noncausal", S, False, None),
            ("masked", S, False, packed_doc_mask(seed))):
        q, k, v = (torch.randn(B, s, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        ref, ref_lse = flash_attention_plain(q, k, v, causal, mask)
        out = torch.empty_like(q)
        lse = torch.empty(B, H, s, device="cuda")
        mask_ptr, mask_code = (None, 0) if mask is None else \
            (mask.data_ptr(), 1)
        for src, lib in libs.items():
            fn = lib.flash_attention_fwd
            fn.argtypes = _SIGNATURES["flash_attention_fwd"]

            def run():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                          out.data_ptr(), lse.data_ptr(), B, s, H, H, 1, D,
                          int(causal), 1.0 / math.sqrt(D), 1, mask_code,
                          *NO_DROPOUT, stream)

            err = run()
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"attn_variants: {src} {label}: CUDA error "
                                 f"{err}")
            lse_ok = float((lse - ref_lse).abs().max()) <= \
                2e-5 * max(1.0, float(ref_lse.abs().max()))
            rec_of[src][f"fwd_{label}_within_tolerance"] = \
                within(out, ref) and lse_ok
            rec_of[src][f"fwd_{label}_ms"] = time_ms(run)
        del ref, ref_lse


def backward_cases(libs, gen, seed, rec_of):
    import torch

    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_bwd_plain)
    from paddle_tpu_torch.ops.hopper.flash_attention import (
        _BWD_SIGNATURES, _delta)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(D)
    for label, causal, mask in (("causal", True, None),
                                ("noncausal", False, None),
                                ("masked", False, packed_doc_mask(seed))):
        out, lse = flash_attention(q, k, v, causal, mask)
        delta = _delta(out, dout)
        ref = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal,
                                        mask)
        mask_ptr, mask_code = (None, 0) if mask is None else \
            (mask.data_ptr(), 1)
        ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta)]
        for src, lib in libs.items():
            for fn, argtypes in _BWD_SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            tail = (B, S, H, H, 1, D, int(causal), scale, 1, mask_code,
                    *NO_DROPOUT, stream)

            def run_dq():
                return lib.flash_attention_bwd_dq(
                    *ptrs, mask_ptr, dq.data_ptr(), *tail)

            def run_dkv():
                return lib.flash_attention_bwd_dkv(
                    *ptrs, mask_ptr, dk.data_ptr(), dv.data_ptr(), *tail)

            errs = run_dq(), run_dkv()
            torch.cuda.synchronize()
            if any(errs):
                raise SystemExit(f"attn_variants: {src} {label}: CUDA "
                                 f"errors {errs}")
            rec_of[src][f"{label}_within_tolerance"] = all(
                within(g, r) for g, r in zip((dq, dk, dv), ref))
            rec_of[src][f"{label}_dq_ms"] = time_ms(run_dq)
            rec_of[src][f"{label}_dkv_ms"] = time_ms(run_dkv)
        del ref


def block_sparse_cases(libs, gen, seed, rec_of):
    import torch

    from paddle_tpu_torch.ops.hopper import block_sparse_attention_plain
    from paddle_tpu_torch.ops.hopper.block_sparse_attention import (
        _SIGNATURES, _pattern_on)
    b, s, h, d = 4, 4096, 12, 64
    bm = bigbird_tiles(s // 128, seed)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ref = block_sparse_attention_plain(q, k, v, bm)
    kmap, counts, order = _pattern_on(q.device, bm)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for src, lib in libs.items():
        fn = lib.block_sparse_attention_fwd
        fn.argtypes = _SIGNATURES["block_sparse_attention_fwd"]

        def run():
            return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), kmap.data_ptr(), counts.data_ptr(),
                      order.data_ptr(), b, s, h, d, kmap.shape[1], 128, 128,
                      *q.stride()[:3], *out.stride()[:3], *k.stride()[:3],
                      1.0 / math.sqrt(d), 1, stream)

        err = run()
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"attn_variants: {src}: CUDA error {err}")
        rec_of[src]["block_sparse_within_tolerance"] = within(out, ref)
        rec_of[src]["block_sparse_ms"] = time_ms(run)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    cases = {"flash_attention_fwd": forward_cases,
             "flash_attention_bwd_dq": backward_cases,
             "block_sparse_attention_fwd": block_sparse_cases}
    with tempfile.TemporaryDirectory() as out_dir:
        libs = build_all(args.sources, out_dir)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        recs = {src: {"source": src} for src in libs}
        for entry, run_cases in cases.items():
            group = {src: lib for src, lib in libs.items()
                     if hasattr(lib, entry)}
            if group:
                run_cases(group, gen, args.seed, recs)
    for rec in recs.values():
        print(json.dumps(rec), flush=True)
    return 0 if all(v for rec in recs.values() for k, v in rec.items()
                    if k.endswith("_within_tolerance")) else 1


if __name__ == "__main__":
    sys.exit(main())

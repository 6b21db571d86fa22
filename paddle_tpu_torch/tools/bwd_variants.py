"""Time the flash attention backward kernels built from several copies of
their source, on one Hopper card.

    python3 -m paddle_tpu_torch.tools.bwd_variants A.cu B.cu [...] \
        [--seed 0]

Versions of a kernel are compared within one call on one card (cards
differ in power limit and neighbours). Each argument is a copy of
``paddle_tpu_torch/ops/hopper/csrc/flash_attention_bwd.cu`` (it includes
the headers beside the package's sources). Every copy is built with
``nvcc`` and the package's flags, all at once, into a temporary directory;
each build's ptxas notes (spills, serialised ``wgmma``) are printed. Then,
at q, k, v [4, 2048, 32, 128] bf16 causal, non-causal, and non-causal
under the float32 packed-document mask of ``bwd_ab.py``, each copy's dQ
and dK/dV are checked against ``flash_attention_bwd_plain`` (one bf16 ulp
at the largest magnitude, ``chip_smoke.bwd_tolerance``) and timed
(``bwd_ab.time_ms``), the copies in turn. One JSON line per copy.
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

from .bwd_ab import B, D, H, S, packed_doc_mask, time_ms


def ptxas_notes(log):
    """Spill and serialisation notes per backward build, from nvcc's
    -Xptxas -v output."""
    notes, build = [], None
    for ln in log.splitlines():
        m = re.search(r"(flash_bwd_\w+?)ILi(\d+)ELi(\d+)ELb(\d)E", ln)
        name = m and f"{m[1]}<{m[2]}, {m[3]}, {m[4]}>"
        if "Compiling entry function" in ln:
            build = name
        elif "serialized" in ln and name:
            notes.append(f"{name}: " + ln.split(":", 1)[-1].strip()[:60])
        elif build and re.search(r"[1-9]\d* bytes spill stores", ln):
            notes.append(f"{build}: {ln.strip()}")
    return notes


def build_all(sources, out_dir):
    """{source: ctypes library} after building every copy at once."""
    from paddle_tpu_torch.ops.hopper import _build
    from paddle_tpu_torch.ops.hopper.flash_attention import _BWD_SIGNATURES
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
            raise SystemExit(f"bwd_variants: {src} failed to build:\n"
                             f"{log[-4000:]}")
        print(json.dumps({"source": src, "ptxas": ptxas_notes(log)}),
              flush=True)
        lib = ctypes.CDLL(path)
        for fn, argtypes in _BWD_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[src] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             flash_attention_bwd_plain)
    from paddle_tpu_torch.ops.hopper.flash_attention import _delta
    with tempfile.TemporaryDirectory() as out_dir:
        libs = build_all(args.sources, out_dir)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        q, k, v, dout = (torch.randn(B, S, H, D, generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         for _ in range(4))
        stream = torch.cuda.current_stream().cuda_stream
        scale = 1.0 / math.sqrt(D)
        recs = {src: {"source": src} for src in libs}
        for label, causal, mask in (("causal", True, None),
                                    ("noncausal", False, None),
                                    ("masked", False,
                                     packed_doc_mask(args.seed))):
            out, lse = flash_attention(q, k, v, causal, mask)
            delta = _delta(out, dout)
            ref = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal,
                                            mask)
            mask_ptr, mask_code = (None, 0) if mask is None else \
                (mask.data_ptr(), 1)
            ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta)]
            for src, lib in libs.items():
                dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
                tail = (B, S, H, H, 1, D, int(causal), scale, 1, mask_code,
                        stream)

                def run_dq():
                    return lib.flash_attention_bwd_dq(
                        *ptrs, mask_ptr, dq.data_ptr(), *tail)

                def run_dkv():
                    return lib.flash_attention_bwd_dkv(
                        *ptrs, mask_ptr, dk.data_ptr(), dv.data_ptr(),
                        *tail)

                errs = run_dq(), run_dkv()
                torch.cuda.synchronize()
                if any(errs):
                    raise SystemExit(f"bwd_variants: {src} {label}: CUDA "
                                     f"errors {errs}")
                recs[src][f"{label}_within_tolerance"] = all(
                    float((g.float() - r.float()).abs().max())
                    <= max(1.0, float(r.float().abs().max())) * 2.0 ** -7
                    for g, r in zip((dq, dk, dv), ref))
                recs[src][f"{label}_dq_ms"] = time_ms(run_dq)
                recs[src][f"{label}_dkv_ms"] = time_ms(run_dkv)
            del ref
    for rec in recs.values():
        print(json.dumps(rec), flush=True)
    return 0 if all(v for rec in recs.values() for k, v in rec.items()
                    if k.endswith("_within_tolerance")) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Where a bf16 prefill's logits change with its batch and its padding.

    python3 -m paddle_tpu_torch.tools.prefill_spread [--seed 0] [--n 73]

At Llama-2-7B width (bf16, 32 layers, random weights from --seed, as
``chip_smoke.py``'s batcher phase builds it) the same prompt's last
logits can differ between an exact-length prefill at batch 1, the same
prefill at batch 2, and the batcher's prefill right-padded to its pow2
bucket (``n_valid``). This script says which operation makes them differ.
It prints one JSON line per part:

- ``spread``: the three prefills of one prompt of --n tokens (drawn from
  --seed), pairwise, relative to the batch-1 logits' largest magnitude;
  and the same at a few lengths around the RMSNorm plan's row boundary;
- ``first_split``: every linear layer, RMSNorm and attention call of the
  three prefills recorded in order; the first calls whose inputs agree bit
  for bit on the prompt's rows and whose outputs do not, for each pair;
- ``linear``, ``rms_norm``, ``flash``: each operation alone at the
  model's shapes, on random inputs from --seed: the row counts (M) at
  which a product's or a norm's first rows differ from the same rows at
  1024 rows, and the flash forward at one prompt of --n tokens against
  itself at batch 2 and padded to the bucket, and against its plain
  version.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _ranges(flags):
    """[[first, last, flag], ...] over 1-based row counts."""
    out = []
    for m, f in enumerate(flags, 1):
        if out and out[-1][2] == f:
            out[-1][1] = m
        else:
            out.append([m, m, f])
    return out


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _bucket(n):
    return max(64, 1 << (n - 1).bit_length())


def _prefills(model, p, s_max=1024):
    """The batch-1, batch-2 and bucketed prefills of prompt p."""
    b1, b2, bucketed = _inputs(model, p, s_max)
    return {"b1": model.prefill(*b1)[0], "b2": model.prefill(*b2)[0][:1],
            "bucketed": model.prefill(*bucketed)[0]}


def _inputs(model, p, s_max=1024):
    """prefill's arguments at batch 1, at batch 2 and padded to the
    bucket, on the model's device."""
    import torch
    dev = model.lm_head.weight.device
    ids = torch.from_numpy(p[None]).to(dev)
    padded = np.zeros(_bucket(len(p)), np.int64)
    padded[:len(p)] = p
    n_valid = torch.full((1, 1), len(p), dtype=torch.int32, device=dev)
    return ((ids, s_max), (ids.repeat(2, 1), s_max),
            (torch.from_numpy(padded[None]).to(dev), s_max, n_valid))


def _pairs(out):
    return {"b2_vs_b1": _rel(out["b2"], out["b1"]),
            "bucketed_vs_b1": _rel(out["bucketed"], out["b1"]),
            "bucketed_vs_b2": _rel(out["bucketed"], out["b2"])}


def _record(model, p):
    """Each linear, RMSNorm and attention call of the three prefills:
    [(name, inputs on the prompt's rows, output on them)]."""
    from ..nn import functional as F
    from ..nn.layers import Linear, RMSNorm
    n = len(p)
    calls = []

    def rows(t):
        return t[0, :n].detach().clone()

    def hook(name):
        return lambda mod, args, out: calls.append(
            (name, [rows(args[0])], rows(out)))

    handles = [mod.register_forward_hook(hook(name))
               for name, mod in model.named_modules()
               if isinstance(mod, (Linear, RMSNorm))]
    sdpa = F.scaled_dot_product_attention

    def recorded(q, k, v, *args, **kw):
        out = sdpa(q, k, v, *args, **kw)
        calls.append(("attention", [rows(q), rows(k), rows(v)], rows(out)))
        return out

    F.scaled_dot_product_attention = recorded
    runs = {}
    try:
        for key, args in zip(("b1", "b2", "bucketed"), _inputs(model, p)):
            calls.clear()
            model.prefill(*args)
            runs[key] = list(calls)
    finally:
        F.scaled_dot_product_attention = sdpa
        for h in handles:
            h.remove()
    return runs


def _first_splits(runs, a, b, keep=4):
    """The first calls whose inputs agree and outputs differ, and the
    first call whose output differs at all, between runs a and b."""
    import torch
    out, first_diff = [], None
    for i, ((name, ins_a, out_a), (_, ins_b, out_b)) in enumerate(
            zip(runs[a], runs[b])):
        same_out = torch.equal(out_a, out_b)
        if not same_out and first_diff is None:
            first_diff = [i, name]
        if not same_out and all(torch.equal(x, y)
                                for x, y in zip(ins_a, ins_b)):
            out.append({"call": i, "name": name,
                        "shape": list(out_a.shape),
                        "rel": _rel(out_b, out_a)})
            if len(out) == keep:
                break
    return {"calls": len(runs[a]), "first_output_diff": first_diff,
            "same_inputs_other_outputs": out}


def _linear_rows(gen):
    """For each of the model's product shapes: per row count M in 1..1024,
    whether x[:M] W^T equals the first M rows of x W^T at M = 1024."""
    import torch
    import torch.nn.functional as tF
    res = {}
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
        x = torch.randn(1024, k, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(n, k, generator=gen, device="cuda") * 0.02).bfloat16()
        ref = tF.linear(x, w)
        flags = [bool(torch.equal(tF.linear(x[:m], w), ref[:m]))
                 for m in range(1, 1025)]
        res[f"{k}x{n}"] = _ranges(flags)
    return res


def _rms_rows(gen):
    """Per row count 1..1024: the plan, and whether the rows equal the same
    rows normalised at 1024 rows."""
    import torch
    from ..ops.hopper.fused_ops import rms_fwd_plan, rms_norm
    x = torch.randn(1024, 4096, generator=gen, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")).bfloat16()
    ref = rms_norm(x, w, 1e-5)[0]
    flags = [bool(torch.equal(rms_norm(x[:m], w, 1e-5)[0], ref[:m]))
             for m in range(1, 1025)]
    plans = _ranges([str(rms_fwd_plan(m, 4096, torch.bfloat16, True))
                     for m in range(1, 1025)])
    return {"equal_to_1024_rows": _ranges(flags), "plans": plans}


def _flash(gen, n):
    import torch
    from ..ops.hopper import flash_attention, flash_attention_plain
    s = _bucket(n)
    q, k, v = (torch.randn(1, s, 32, 128, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    one = flash_attention(q[:, :n], k[:, :n], v[:, :n], causal=True)[0]
    two = flash_attention(*(t[:, :n].repeat(2, 1, 1, 1) for t in (q, k, v)),
                          causal=True)[0]
    pad = flash_attention(q, k, v, causal=True)[0]
    plain = flash_attention_plain(q[:, :n], k[:, :n], v[:, :n],
                                  causal=True)[0]
    return {"n": n, "bucket": s,
            "batch2_equal": bool(torch.equal(two[:1], one)),
            "bucket_equal": bool(torch.equal(pad[:, :n], one)),
            "max_abs_err_vs_plain": float((one.float() - plain.float())
                                          .abs().max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=73)
    args = ap.parse_args(argv)
    import torch
    from ..models import LlamaForCausalLM, llama2_7b_config
    cfg = llama2_7b_config(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(args.seed))
    rng = np.random.RandomState(args.seed)
    p = rng.randint(0, cfg.vocab_size, args.n).astype(np.int64)
    with torch.no_grad():
        spread = {"n": args.n, **_pairs(_prefills(model, p)), "around": {}}
        for n in (64, 100, 127, 128, 131, 132, 133, 140, 200, 300):
            q = rng.randint(0, cfg.vocab_size, n).astype(np.int64)
            spread["around"][n] = _pairs(_prefills(model, q))
        print(json.dumps({"part": "spread", **spread}), flush=True)
        runs = _record(model, p)
        print(json.dumps({"part": "first_split", "n": args.n, **{
            f"{a}_vs_{b}": _first_splits(runs, a, b)
            for a, b in (("b1", "b2"), ("b1", "bucketed"),
                         ("b2", "bucketed"))}}), flush=True)
        del runs
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        print(json.dumps({"part": "linear", **_linear_rows(gen)}), flush=True)
        print(json.dumps({"part": "rms_norm", **_rms_rows(gen)}), flush=True)
        print(json.dumps({"part": "flash", **_flash(gen, args.n)}),
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()

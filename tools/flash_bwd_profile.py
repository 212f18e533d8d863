#!/usr/bin/env python3
"""The f32 flash backward at the LM training shape, by kernel: where the
3xTF32 pair's time goes (each call's split, the dq kernel, the dk/dv
kernel), beside the SIMT pair named on the same inputs.

    python3 tools/flash_bwd_profile.py [--out build/flash_bwd_profile.json]

B=2, S=4,096, 40/8 heads of 128, causal, f32, seeded; o and lse from the
3xTF32 forward. ``torch.profiler`` over 3 calls of each route after 2
warm-ups: device ms a call by kernel name, and each kernel's share of
the route's device time; the 3xTF32 gradients are held to the SIMT
pair's first (1e-4 of each one's largest). It needs a GPU and nvcc;
results are printed and written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CALLS = 3


def by_kernel(torch, fn) -> dict:
    """Device ms a call of ``fn`` by kernel name (CUDA rows only)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            rows[name] = rows.get(name, 0.0) + us / 1e3 / CALLS
    total = sum(rows.values())
    return {"device_ms": total,
            "kernels": {n: {"ms": ms, "share": ms / total}
                        for n, ms in sorted(rows.items(),
                                            key=lambda kv: -kv[1])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "flash_bwd_profile.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, Hq, Hkv, D = 2, 4096, 40, 8, 128
    q, do = (torch.randn(B, S, Hq, D, generator=g, device=dev)
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev)
            for _ in range(2))
    o, lse = fa.flash_attention_cuda(q, k, v, True)
    got = fa._bwd_cuda_as_written(q, k, v, o, lse, do, True)
    ref = fa._bwd_cuda_as_written(q, k, v, o, lse, do, True,
                                  route=fa.BWD_SIMT)
    rel = {n: float((a - b).abs().max() / b.abs().max())
           for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    if max(rel.values()) > 1e-4:
        print(f"3xTF32 against SIMT: {rel}", file=sys.stderr)
        return 1
    out = {"card": card, "shape": [B, S, S, Hq, Hkv, D], "dtype": "float32",
           "causal": True, "tf32_vs_simt_rel": rel}
    for name, route in (("tf32", fa.BWD_TF32), ("simt", fa.BWD_SIMT)):
        out[name] = by_kernel(torch, lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, True, route=route))
        print(f"{name}: " + json.dumps(out[name]), flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

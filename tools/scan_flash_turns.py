#!/usr/bin/env python3
"""The PQ LUT scan's two kernels and the f32 flash forward's two kernels,
each pair timed in turns (A B B A) on the same inputs, beside a memory
yardstick and the bounds.

    python3 tools/scan_flash_turns.py [--out chiprun_out/scan_flash_turns.json]

PQ (B=16, M=8, K=32, seeded by ``launch.serve.pq_scan_inputs``): the
tiled scan (``pq_lut_scores``) against the general one
(``pq_lut_scores_general``, the first port's kernel) at nprobe 16 over
even lists of 16,384, 65,536 and 131,072 news (N = 4,096, 16,384 and
32,768; the smoke's served snapshot of 16,384 news has uneven k-means
lists and a larger cap), at PROD's corpus of 1,204,224 news (IVF: nlist
64, nprobe 16, cap 32,768, N = 524,288) and flat over that corpus (codes
shared by the batch). The yardstick is a device copy of the scan's code
bytes (read once, written once), the byte bound its inputs read once and
its output written once at 3.35 TB/s.

Flash (f32, B=1, S=4,096, 40/8 heads of 128, causal): the 3xTF32 kernel
(``flash_attention_tf32``) against the SIMT one named on the same call,
beside SDPA's f32 forward.

Each kernel is held to plain first (1e-5 PQ, 2e-4 / 1e-4 flash). It needs
a GPU and nvcc; results are printed and written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PROD_NEWS = 1_204_224


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "scan_flash_turns.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from chip_smoke import bound_ms, nbytes, time_ms
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_fwd_plain)
    from repro_torch.kernels.pq_scoring import (pq_lut_scores_cuda,
                                                pq_lut_scores_plain)
    from repro_torch.launch.serve import pq_scan_inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    logs = ops.build_all()
    for name in ("pq_scoring", "flash_attention_tf32", "bus_attention"):
        print(name, [ln.strip() for ln in logs[name].splitlines()
                     if "spill" in ln or "registers" in ln][:12], flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    report = {"card": card, "pq": {}, "flash": {}}
    for label, n, nprobe in (("ivf_n4096", 16_384, 16),
                             ("ivf_n16384", 65_536, 16),
                             ("ivf_n32768", 131_072, 16),
                             ("prod_ivf", PROD_NEWS, 16),
                             ("prod_flat", PROD_NEWS, None)):
        x = pq_scan_inputs(n, batch=16, n_subvec=8, n_codes=32,
                           nprobe=nprobe, gen=g, device=dev)
        lut, codes, valid = x["lut"], x["codes"], x["valid"]
        ref = pq_lut_scores_plain(lut, codes, valid)
        row = {"shape": list(codes.shape)}
        for route in ("pq_lut_scores", "pq_lut_scores_general"):
            out = pq_lut_scores_cuda(lut, codes, valid, route=route)
            fin = torch.isfinite(ref)
            ok = torch.equal(torch.isfinite(out), fin)
            row[route + "_err"] = float((out[fin] - ref[fin]).abs().max())
            assert ok and row[route + "_err"] <= 1e-5, (route, row)
        turns = []
        for route in ("pq_lut_scores_general", "pq_lut_scores",
                      "pq_lut_scores", "pq_lut_scores_general"):
            turns.append((route, time_ms(torch, lambda: pq_lut_scores_cuda(
                lut, codes, valid, route=route), iters=100)))
        row["turns_ms"] = turns
        row["copy_codes_ms"] = time_ms(torch, lambda: codes.clone(),
                                       iters=100)
        row["bound_ms"] = bound_ms(nbytes(lut, codes, ref)
                                   + (valid.numel() if valid is not None
                                      else 0), 0)[0]
        report["pq"][label] = row
        print(label, json.dumps(row), flush=True)
        del x, lut, codes, valid, ref
    q, k, v = (torch.randn(1, 4096, h, 128, generator=g, device=dev)
               for h in (40, 8, 8))
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, True)
    for route in ("flash_attention_tf32", "flash_attention"):
        o, lse = flash_attention_cuda(q, k, v, True, route=route)
        report["flash"][route + "_err"] = [
            float((o - o_p).abs().max()), float((lse - lse_p).abs().max())]
    turns = []
    for route in ("flash_attention", "flash_attention_tf32",
                  "flash_attention_tf32", "flash_attention"):
        turns.append((route, time_ms(torch, lambda: flash_attention_cuda(
            q, k, v, True, route=route), iters=20 if "tf32" in route else 3,
            warmup=1)))
    report["flash"]["turns_ms"] = turns
    qs = q.transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).repeat_interleave(5, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(5, dim=1).contiguous()
    report["flash"]["sdpa_ms"] = time_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), iters=10, warmup=2)
    print("flash", json.dumps(report["flash"]), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the bus attention kernels' time goes on the card: variants of
``src/repro_torch/kernels/csrc/bus_attention.cu`` built from patched
copies of it, each timed in f32 at the serve chunk (M=256, forward) and at
the train step's shape (M=4096, forward and backward), beside a copy of
the same q/k/v as a memory yardstick.

    python3 tools/bus_variants.py [--out chiprun_out/bus_variants.json]

Variants (each one library, built with the port's nvcc flags into
``build/variants/``):

  base            the source as it is
  loads_only      the cp.async ring alone: no products, no stores
  loads_stores    the ring and, in the backward, the dK/dV stores
  compute_stores  products and stores, no loads after the first stages
                  (the kernels compute on stale tiles)
  trunc_hi        hi = x with its low 13 bits cleared instead of
                  cvt.rna.tf32.f32 (a rounding the kernels do not use)

It also prints the SASS instruction mix (``cuobjdump -sass``) of the
base forward and backward at f32, D=64 and five 8-key tiles. It needs a
GPU and nvcc; the results are printed and written to ``--out``.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/bus_attention.cu"
OUT_DIR = ROOT / "build/variants"
# name -> (no loads after the prologue, no compute, no stores, trunc hi)
VARIANTS = {"base": (0, 0, 0, 0), "loads_only": (0, 1, 1, 0),
            "loads_stores": (0, 1, 0, 0), "compute_stores": (1, 0, 0, 0),
            "trunc_hi": (0, 0, 0, 1)}
# (text, replacement, times it occurs in the source)
PATCHES = [
    ("namespace {\n", "namespace {\nconstexpr bool kNoLoad = {nl}, "
     "kNoCompute = {nc}, kNoStore = {ns};\n", 1),
    ("    if (pre < n)\n", "    if (pre < n && !kNoLoad)\n", 2),
    ("    if (tt >= sh.tiles) continue;",
     "    if (tt >= sh.tiles || kNoCompute) continue;", 1),
    ("    const bool live = tt < sh.tiles;",
     "    const bool live = tt < sh.tiles && !kNoCompute;", 1),
    ("    if (rows > 0)\n      store_rows",
     "    if (rows > 0 && !kNoStore)\n      store_rows", 1),
    ("    for (int j = 0; j < sh.tps; ++j) {\n      const long long tj",
     "    for (int j = 0; j < (kNoStore ? 0 : sh.tps); ++j) {\n"
     "      const long long tj", 1),
    ("    hi = tf32(x);\n", "    hi = {trunc_hi};\n", 1),
]


def patched(nl, nc, ns, trunc) -> str:
    """The source with the variant's switches set."""
    src = SOURCE.read_text()
    for old, new, times in PATCHES:
        if src.count(old) != times:
            raise SystemExit(f"bus_variants: patch does not apply: {old!r}")
        new = new.replace("{nl}", str(nl)).replace("{nc}", str(nc)).replace(
            "{ns}", str(ns)).replace("{trunc_hi}", (
                "__float_as_uint(x) & 0xffffe000u" if trunc else "tf32(x)"))
        src = src.replace(old, new)
    return src


def sass_mix(cuobjdump: pathlib.Path, lib: pathlib.Path) -> dict:
    """Instruction counts by opcode of the f32, D=64, 5-tile kernels."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.search(r"bus_(fwd|bwd)_kernelIfLi64ELi5E", fn.split(None, 1)[0])
        if m:
            ops = re.findall(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", fn)
            out[m[1]] = {"instructions": len(ops), "by_opcode": dict(
                collections.Counter(ops).most_common(12))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/bus_variants.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bus_variants: needs a GPU")
    from repro_torch.kernels import bus_attention as bus
    from repro_torch.kernels._build import NVCC_FLAGS, find_nvcc

    torch.backends.cuda.matmul.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, flags in VARIANTS.items():
        src = OUT_DIR / f"bus_{name}.cu"
        src.write_text(patched(*flags))
        lib = OUT_DIR / f"bus_{name}.so"
        jobs[name] = (subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bus_variants: {name} failed to build:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for sym, argtypes in bus.KERNEL.functions.items():
            getattr(handle, sym).argtypes = argtypes
            getattr(handle, sym).restype = ctypes.c_int
        libs[name] = handle
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    report = {"card": card, "sass": sass_mix(
        pathlib.Path(find_nvcc()).parent / "cuobjdump", jobs["base"][1])}
    print(card)
    print(json.dumps(report["sass"]), flush=True)

    def time_ms(fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    K, S, H, D = 3, 32, 12, 64
    Sk = S + K
    for M in (256, 4096):
        q = torch.randn(M, K, S, H, D, generator=gen, device=dev)
        k = torch.randn(M, K, Sk, H, D, generator=gen, device=dev)
        v = torch.randn(M, K, Sk, H, D, generator=gen, device=dev)
        do = torch.randn(q.shape, generator=gen, device=dev)
        mask = torch.rand(M, K, Sk, generator=gen, device=dev) < 0.75
        o, dq = torch.empty_like(q), torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, lib in libs.items():
            def fwd():
                return lib.bus_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    mask.data_ptr(), o.data_ptr(), M, K, S, Sk, H, D, 0,
                    D ** -0.5, stream)

            def bwd():
                return lib.bus_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    mask.data_ptr(), do.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), M, K, S, Sk, H, D, 0,
                    D ** -0.5, stream)

            if fwd() or bwd():
                raise SystemExit(f"bus_variants: {name} launch failed")
            row = {"fwd_ms": time_ms(fwd)}
            if M == 4096:
                row["bwd_ms"] = time_ms(bwd)
            report[f"M={M} {name}"] = row
            print(f"M={M} {name}: {row}", flush=True)
        report[f"M={M} copy of q, k, v"] = {
            "ms": time_ms(lambda: (q.clone(), k.clone(), v.clone())),
            "bytes_moved": 2 * 4 * (q.numel() + k.numel() + v.numel())}
        print(f"M={M} copy: {report[f'M={M} copy of q, k, v']}", flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

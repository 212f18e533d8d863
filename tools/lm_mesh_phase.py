#!/usr/bin/env python3
"""The lm-mesh and flash-groups phases of ``chip_smoke.py`` alone, on one
card: the LM family on a (data=2, model=2) mesh of 4 gloo ranks sharing
the card (tensor parallelism and FSDP by ``lm_rules``, expert-parallel
MoE), ChatGLM3-6B on the ranks re-cut as (data=1, model=4) (each KV head
replicated over 2 ranks by the head plan), and, first, the flash pair at
the head plan's rank shapes (3 and 2 query heads over one KV head).

    python3 tools/lm_mesh_phase.py [--out chiprun_out/lm_mesh_phase.json]

Builds the kernel libraries, then holds the flash pair at the head
plan's rank shapes (``chip_smoke.flash_group_holds``: [2, 4,096, Hq, 1,
128], Hq 3 and 2, each route against plain) and runs
``chip_smoke.lm_mesh_phase`` with the smoke's checks (a failed check
exits non-zero): the f32 holds of Qwen3-14B and DBRX-132B against one
process on the card, ChatGLM3-6B's (with its control: the steps without
the KV heads' sum), and the bf16 runs at full width with their times,
each rank's peak memory and flash launches, and each run's first flash
calls held to plain at the run's shapes. Prints one JSON object with
the card's name and power limit and the phase's seconds, also written
to ``--out``. It needs a GPU and fails without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "lm_mesh_phase.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tools/lm_mesh_phase.py needs a GPU")
    import chip_smoke as cs
    from repro_torch.kernels import ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ops.build_all()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    groups, group_launches = cs.flash_group_holds(torch, dev)
    groups_s = time.perf_counter() - t0
    cs.gc_collect(torch)
    rep, launches, _ = cs.lm_mesh_phase(torch, np, dev, card)
    rep.update(build_s=build_s, launches_by_rank=launches,
               flash_groups=groups, flash_groups_launches=group_launches,
               flash_groups_s=groups_s)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=1))
    print(json.dumps({"card": card, "seconds": rep["seconds"],
                      "build_s": build_s,
                      "flash_groups_s": rep["flash_groups_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

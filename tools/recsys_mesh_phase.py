#!/usr/bin/env python3
"""The recsys-mesh phase of ``chip_smoke.py`` alone, on one card: the
recsys family on (data, model) meshes of 4 gloo ranks sharing the card
(the tables cut by rows over ``model`` by ``recsys_rules``, the
EmbeddingBag kernels on each rank's block, BERT4Rec's two-stage
``serve_sharded``).

    python3 tools/recsys_mesh_phase.py [--out PATH]

(``--out`` defaults to ``chiprun_out/recsys_mesh_phase.json``.)

Builds the kernel libraries, then runs ``chip_smoke.recsys_mesh_phase``
with the smoke's checks (a failed check exits non-zero): the four
configs at full width, serve, retrieval and the train holds against one
process on the card, each run's time and each rank's peak memory and
EmbeddingBag launches, and each rank's first EmbeddingBag forward and
backward held to plain at the rank's shapes. Prints one JSON object with
the card's name and power limit and the phase's seconds, also written to
``--out``. It needs a GPU and fails without one.
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
                                         / "recsys_mesh_phase.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tools/recsys_mesh_phase.py needs a GPU")
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
    rep, launches, _ = cs.recsys_mesh_phase(torch, np, dev, card)
    rep.update(build_s=build_s, launches_by_rank=launches)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=1))
    print(json.dumps({"card": card, "seconds": rep["seconds"],
                      "build_s": build_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

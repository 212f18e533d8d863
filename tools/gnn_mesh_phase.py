#!/usr/bin/env python3
"""The gnn-mesh phase of ``chip_smoke.py`` alone, on one card: DimeNet at
minibatch_lg, full width, on (4, 1) and (2, 2) meshes of 4 gloo ranks
sharing the card (the edges and triplets over every axis by
``gnn_batch_specs``, the parameters whole).

    python3 tools/gnn_mesh_phase.py [--out PATH]

(``--out`` defaults to ``chiprun_out/gnn_mesh_phase.json``.)

Runs ``chip_smoke.gnn_mesh_phase`` with the smoke's checks (a failed
check exits non-zero): one process on the card held to the port on the
CPU in f64, each mesh's loss, gradients and 2 train steps held to one
process on the card in f64, then 2 f32 steps timed, each rank's peak
memory, no kernel launched. DimeNet's path has no hand-written kernel,
so nothing is built. Prints one JSON object with the card's name and
power limit and the phase's seconds, also written to ``--out``. It needs
a GPU and fails without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "gnn_mesh_phase.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tools/gnn_mesh_phase.py needs a GPU")
    import chip_smoke as cs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep = cs.gnn_mesh_phase(torch, np, torch.device("cuda"), card)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=1))
    print(json.dumps({"card": card, "seconds": rep["seconds"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a PROD checkpoint's save and restore spend their time, stage by
stage, on one card.

    python3 tools/ckpt_breakdown.py [--dir build/ckpt_breakdown]
        [--out chiprun_out/ckpt_breakdown.json]

Builds the SpeedyFeed PROD train state on the card (``init_state(0)``:
parameters, both Adam moments and the 1,204,224 x 768 cache; no kernel
is built or launched), then times, each synchronised, the stages
``save_state`` runs (``to_ckpt_tree``'s stacking of the layers on the
card; the copies to the host; the manifest's crc32s; numpy's npz write)
and those ``restore_state`` runs (the npz read; the crc32s again; the
copies to the card), each whole call beside its stages, and a copy to
pinned host buffers as the yardstick for the device-to-host part. The
directory is removed at the end. Prints one JSON object with the card's
name and power limit, also written to ``--out``. It needs a GPU and fails
without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=str(ROOT / "build" / "ckpt_breakdown"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "ckpt_breakdown.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ckpt_breakdown: needs a GPU")
    from repro_torch import training
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import PROD

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    trainer = training.get_trainer("speedyfeed", cfg=PROD, device=dev)
    state = trainer.init_state(0)
    root = pathlib.Path(args.dir)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"card": card}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return r

    try:
        tree = timed("save.stack_layers_s",
                     lambda: training.to_ckpt_tree(state))
        host = timed("save.to_host_s", lambda: ckpt._flatten(tree))
        out["snapshot_bytes"] = sum(a.nbytes for a in host.values())
        on_card = {k: t for k, t in ckpt._walk(tree)
                   if isinstance(t, torch.Tensor) and t.is_cuda}
        pinned = {k: torch.empty_like(t, device="cpu", pin_memory=True)
                  for k, t in on_card.items()}
        timed("yardstick.to_pinned_host_s", lambda: [
            pinned[k].copy_(t) for k, t in on_card.items()])
        del pinned, on_card
        timed("save.crc32_s",
              lambda: [ckpt._checksum(a) for a in host.values()])
        timed("save.npz_write_s",
              lambda: np.savez(str(root / "arrays.npz"), **host))
        del host, tree
        timed("save_state_s", lambda: training.save_state(
            str(root / "ckpt"), state.step, state))
        def read():
            with np.load(str(root / "arrays.npz")) as z:
                return {k: z[k] for k in z.files}

        data = timed("restore.npz_read_s", read)
        timed("restore.crc32_s",
              lambda: [ckpt._checksum(a) for a in data.values()])
        timed("restore.to_card_s", lambda: [
            torch.from_numpy(a).to(dev) for a in data.values()])
        del data
        like = trainer.init_state(1)
        timed("restore.like_tree_s", lambda: training.to_ckpt_tree(like))
        timed("restore_state_s", lambda: training.restore_state(
            str(root / "ckpt"), like))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gb = out["snapshot_bytes"] / 1e9
    for k in [k for k in out if k.endswith("_s")]:
        out[k[:-2] + "_gb_per_s"] = gb / out[k]
    line = json.dumps(out)
    print(line, flush=True)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

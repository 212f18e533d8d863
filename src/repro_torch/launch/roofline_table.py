"""Roofline table from the dry-run's records (``launch/dryrun.py --out``):
the port's counterpart of the JAX package's
``benchmarks/roofline_table.py``.

Columns per (arch x shape): the roofline terms in ms, the dominant
bottleneck, MODEL_FLOPS / counted FLOPs (the useful-compute fraction),
the MFU upper bound implied by max(terms), the peak live GiB, whether it
fits one card, and, where the record was measured on the card
(``--measure``), the measured ms, ``achieved`` (the floor over the
measured time) and ``mfu``.

    python -m repro_torch.launch.roofline_table build/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun.jsonl"


def load(path=RESULTS) -> dict:
    """The ``ok`` records of ``path`` by (arch, shape, mesh). A later line
    of a cell replaces an earlier one, whatever its status: a cell that
    counted once and then failed or was skipped has no row."""
    recs = {}
    if not os.path.exists(path):
        return recs
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return {k: r for k, r in recs.items() if r.get("status") == "ok"}


def summary_table(path=RESULTS) -> str:
    """Markdown table of the records in ``path``."""
    recs = load(path)
    lines = ["| arch | shape | mesh | t_comp ms | t_mem ms | t_coll ms | "
             "bound | useful FLOPs | MFU ub | peak GiB | fits | "
             "measured ms | achieved | mfu |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in sorted(recs.items()):
        if "measured_s" in r:
            measured = (f"{r['measured_s'] * 1e3:.3f} | {r['achieved']:.1%} "
                        f"| {r['mfu']:.1%}")
        else:
            measured = "| |"
        lines.append(
            f"| {arch} | {shape} | {mesh} | {r['t_compute'] * 1e3:.2f} | "
            f"{r['t_memory'] * 1e3:.2f} | {r['t_collective'] * 1e3:.2f} | "
            f"{r['bottleneck']} | {r['useful_flops_fraction']:.1%} | "
            f"{r['mfu_upper_bound']:.1%} | "
            f"{r['peak_memory_per_chip'] / 2 ** 30:.2f} | "
            f"{'yes' if r['fits_one_card'] else 'no'} | {measured} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default=str(RESULTS))
    args = ap.parse_args(argv)
    print(summary_table(args.path))


if __name__ == "__main__":
    main()

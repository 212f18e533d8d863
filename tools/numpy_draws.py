#!/usr/bin/env python3
"""Fingerprints of the numpy draws behind the synthetic corpus and click
log, to tell whether two hosts build the same data from the same seed.

    python3 tools/numpy_draws.py

numpy does not hold ``Generator`` streams fixed from one version to the
next. The corpus (``data.make_corpus``) draws word ids with
``Generator.zipf``, a rejection sampler: where two versions draw other
values, they also consume another count of raw draws, and every later
draw (the popularity ranks, the click log, the ladder's users) differs.
Prints one JSON object: the numpy version, a hash of each stage's draws,
and the unique news of the speedup ladder's ``prod`` users. Needs no GPU.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def digest(a) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:12]


def main() -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import data
    from repro_torch.launch import speedup

    def fresh():
        return np.random.default_rng(0)

    corpus = data.make_corpus(fresh(), n_news=speedup.PROD_NEWS)
    text = "|".join(corpus.titles + corpus.abstracts + corpus.bodies)
    _, log, _, _, cuts = speedup.prod_setup()
    out = {
        "numpy": np.__version__,
        "integers": digest(fresh().integers(0, 16, 100_000)),
        "lognormal": digest(fresh().lognormal(6.0, 0.7, 100_000)),
        "permutation": digest(fresh().permutation(speedup.PROD_NEWS)),
        "zipf": digest(fresh().zipf(1.3, size=100_000)),
        "corpus_text": hashlib.sha1(text.encode()).hexdigest()[:12],
        "popularity_order": digest(np.argsort(-corpus.popularity,
                                              kind="stable")),
        "click_log": digest(np.concatenate(log.histories)),
        "prod_n_unique": cuts["n_unique"],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

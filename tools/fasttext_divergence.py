#!/usr/bin/env python3
"""bench.py --config fasttext's FastText in the JAX package, on the CPU,
with and without subsampling.

    JAX_PLATFORMS=cpu python3 tools/fasttext_divergence.py [--words N]

bench.py's ``bench_fasttext`` builds FastText with min frequency 5, layer
100, 5 negatives, 1 epoch, batch 8192 and seed 42 over its zipf corpus, and
sets no subsampling threshold. This script fits that model twice (cold,
then warm, as bench.py does) at subsampling 0 (bench.py's), 1e-4
(fastText's own default) and 1e-3 (bench.py's word2vec configuration), and
prints for each fit its last loss, the largest absolute value in syn0 and
whether the tables are finite. The port's chip_smoke.py phase 20 runs the
same configuration on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def zipf_sentences(n_words: int, vocab_size: int = 10_000,
                   sent_len: int = 20, seed: int = 123):
    """bench.py's ``_zipf_sentences``."""
    rng = np.random.default_rng(seed)
    n_sent = max(1, n_words // sent_len)
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    words = np.array([f"w{i}" for i in range(vocab_size)])
    ids = rng.choice(vocab_size, size=(n_sent, sent_len), p=p)
    return [" ".join(row) for row in words[ids]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--words", type=int, default=400_000,
                    help="corpus words (bench.py --config fasttext: 400,000)")
    args = ap.parse_args()
    from deeplearning4j_tpu.nlp import FastText

    sents = zipf_sentences(args.words)
    for sampling in (0.0, 1e-4, 1e-3):
        ft = (FastText.builder().min_word_frequency(5).layer_size(100)
              .negative_sample(5).epochs(1).batch_size(8192).seed(42)
              .iterate(sents).build())
        ft.sampling = sampling
        for fit in ("cold", "warm"):
            t0 = time.perf_counter()
            ft.fit()
            syn0 = np.asarray(ft.lookup_table.syn0)
            print(json.dumps({
                "sampling": sampling, "fit": fit, "vocab": len(ft.vocab),
                "last_loss": float(ft.last_loss),
                "syn0_max_abs": float(np.abs(syn0).max()),
                "finite": bool(np.isfinite(syn0).all()),
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CIDEr-D (tf-idf n-gram consensus, n = 1..4, sigma = 6, x10).

Scoring behavior of the vendored pycocoevalcap Cider
(reference: eval_func/cider/cider_scorer.py:106-193): document
frequencies from the reference corpus, idf = log(N) - log(max(1, df)); per-n
vectors of tf*idf; clipped cosine similarity with a Gaussian length penalty
exp(-(lh - lr)^2 / (2 sigma^2)); averaged over n and references, times 10.
Implemented from the CIDEr-D definition (Vedantam et al., 2015).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

N_MAX = 4
SIGMA = 6.0


def _ngram_counts(tokens: Sequence) -> List[Counter]:
    return [Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)) for n in range(1, N_MAX + 1)]


def _tfidf_vec(counts: List[Counter], doc_freq: Dict, log_n: float):
    vecs, norms = [], []
    length = sum(counts[0].values())
    for n in range(N_MAX):
        vec = {}
        norm = 0.0
        for gram, tf in counts[n].items():
            idf = log_n - math.log(max(1.0, doc_freq.get(gram, 0.0)))
            v = tf * idf
            vec[gram] = v
            norm += v * v
        vecs.append(vec)
        norms.append(math.sqrt(norm))
    return vecs, norms, length


def corpus_cider_d(references: List[List[Sequence]], hypotheses: List[Sequence]) -> float:
    assert len(references) == len(hypotheses)
    num_imgs = len(references)
    # Document frequency: number of images whose reference set contains the ngram.
    doc_freq: Dict[Tuple, float] = defaultdict(float)
    ref_counts_all = []
    for refs in references:
        counts = [_ngram_counts(r) for r in refs]
        ref_counts_all.append(counts)
        seen = set()
        for c in counts:
            for n in range(N_MAX):
                seen.update(c[n].keys())
        for gram in seen:
            doc_freq[gram] += 1.0

    log_n = math.log(max(num_imgs, 1))
    total = 0.0
    for refs_counts, hyp in zip(ref_counts_all, hypotheses):
        hyp_counts = _ngram_counts(hyp)
        hvec, hnorm, hlen = _tfidf_vec(hyp_counts, doc_freq, log_n)
        score_img = [0.0] * N_MAX
        for rc in refs_counts:
            rvec, rnorm, rlen = _tfidf_vec(rc, doc_freq, log_n)
            delta = float(hlen - rlen)
            for n in range(N_MAX):
                val = 0.0
                for gram, hv in hvec[n].items():
                    # CIDEr-D clips the hypothesis term at the reference term.
                    val += min(hv, rvec[n].get(gram, 0.0)) * rvec[n].get(gram, 0.0)
                if hnorm[n] > 0 and rnorm[n] > 0:
                    val /= hnorm[n] * rnorm[n]
                val *= math.exp(-(delta**2) / (2 * SIGMA**2))
                score_img[n] += val
        n_refs = len(refs_counts)
        total += 10.0 * sum(s / n_refs for s in score_img) / N_MAX
    return total / max(num_imgs, 1)

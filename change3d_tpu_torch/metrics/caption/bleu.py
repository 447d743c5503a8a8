"""Corpus BLEU-1..4 with closest-reference brevity penalty.

Matches the scoring behavior of the vendored pycocoevalcap Bleu the reference
evaluates with (reference: eval_func/bleu/bleu_scorer.py:198-263,
'closest' length option): clipped n-gram precision accumulated over the
corpus, brevity from the reference whose length is closest to the hypothesis
(ties broken toward the shorter), BP = e^(1 - r/c) when c <= r.

Implemented from the BLEU definition (Papineni et al., 2002) — not a port.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(references: List[List[Sequence]], hypotheses: List[Sequence], max_n: int = 4) -> List[float]:
    """references[i] = list of token sequences; hypotheses[i] = token sequence.
    Returns [BLEU-1, ..., BLEU-max_n]."""
    assert len(references) == len(hypotheses)
    correct = [0] * max_n
    total = [0] * max_n
    hyp_len = 0
    ref_len = 0

    for refs, hyp in zip(references, hypotheses):
        hyp_len += len(hyp)
        # Closest reference length; ties -> shorter reference.
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_counts = _ngrams(hyp, n)
            if not hyp_counts:
                continue
            max_ref = Counter()
            for r in refs:
                for gram, c in _ngrams(r, n).items():
                    if c > max_ref[gram]:
                        max_ref[gram] = c
            correct[n - 1] += sum(min(c, max_ref[gram]) for gram, c in hyp_counts.items())
            total[n - 1] += sum(hyp_counts.values())

    tiny, small = 1e-15, 1e-9  # guards as in standard corpus-BLEU implementations
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - float(ref_len) / (hyp_len + tiny))
    scores = []
    log_sum = 0.0
    for n in range(max_n):
        p = (correct[n] + tiny) / (total[n] + small)
        log_sum += math.log(p)
        scores.append(bp * math.exp(log_sum / (n + 1)))
    return scores

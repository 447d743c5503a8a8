"""ROUGE-L (longest-common-subsequence F-measure, beta = 1.2).

Scoring behavior of the vendored pycocoevalcap Rouge
(reference: eval_func/rouge/rouge.py:60-170): per example, the max
LCS precision and max LCS recall over references combine into
F = (1+b^2) P R / (R + b^2 P); corpus score is the mean. Implemented from the
ROUGE definition (Lin, 2004).
"""

from __future__ import annotations

from typing import List, Sequence

BETA = 1.2


def _lcs_len(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def sentence_rouge_l(refs: List[Sequence], hyp: Sequence, beta: float = BETA) -> float:
    prec, rec = [], []
    for r in refs:
        lcs = _lcs_len(r, hyp)
        prec.append(lcs / max(len(hyp), 1e-12))
        rec.append(lcs / max(len(r), 1e-12))
    p, r = max(prec), max(rec)
    if p == 0 or r == 0:
        return 0.0
    return (1 + beta**2) * p * r / (r + beta**2 * p)


def corpus_rouge_l(references: List[List[Sequence]], hypotheses: List[Sequence]) -> float:
    assert len(references) == len(hypotheses)
    scores = [sentence_rouge_l(refs, hyp) for refs, hyp in zip(references, hypotheses)]
    return sum(scores) / max(len(scores), 1)

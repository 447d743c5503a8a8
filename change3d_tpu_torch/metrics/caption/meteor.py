"""METEOR 1.5 (English, exact and stem stages) in pure Python (counterpart
of the pure-Python scorer of ``change3d_tpu/metrics/caption/meteor.py``).

- matcher stages exact (weight 1.0) then Porter stem (weight 0.6);
- content/function-word weighting (delta on content words);
- alignment resolution by the jar's beam search over non-conflicting
  matches: most covered words, then fewest chunks, then least summed
  |hyp_start - ref_start|, beam width 40;
- per segment the best-scoring reference's sufficient statistics are kept,
  and the corpus score is the formula over the statistics summed over
  segments (the jar's aggregate line), not a mean of sentence scores.

The caption eval scores stringified token ids, on which the stem stage and
the function-word distinction are no-ops. The JAX package's synonym and
paraphrase stages and its function-word file option, no-ops under that
protocol as well, are not copied; nor is its native library.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# Meteor 1.5 English parameters (task 'rank'): alpha, beta, gamma, delta.
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
W_STEM = 0.6  # stem-stage module weight (the exact stage's is 1.0)
BEAM_WIDTH = 40  # the jar's alignment-resolution beam size

FUNCTION_WORDS = frozenset(
    """a an the and or but nor so yet of in on at to from by with about as into
    like through after over between out against during without before under
    around among for is am are was were be been being have has had do does did
    will would shall should may might must can could i you he she it we they
    me him her us them my your his its our their mine yours hers ours theirs
    this that these those there here where when what which who whom whose why
    how not no if then than too very just also up down off some any all both
    each few more most other such only own same s t now while because until
    again""".split()
)


def _word_weight(w: str) -> float:
    return (1.0 - DELTA) if w in FUNCTION_WORDS else DELTA


def _simple_stem(w: str) -> str:
    for suf in ("ing", "ed", "es", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def _stemmer():
    try:
        from nltk.stem.porter import PorterStemmer

        return PorterStemmer().stem
    except Exception:
        return _simple_stem


def _collect_candidates(hyp: List[str], ref: List[str]):
    """Candidate word matches (hi, 1, ri, 1, stage, weight): exact (1.0),
    else stem (0.6)."""
    stem = _stemmer()
    hs, rs = [stem(x) for x in hyp], [stem(x) for x in ref]
    cands = []
    for j in range(len(ref)):
        for i in range(len(hyp)):
            if hyp[i] == ref[j]:
                cands.append((i, 1, j, 1, 0, 1.0))
            elif hs[i] == rs[j]:
                cands.append((i, 1, j, 1, 1, W_STEM))
    return cands


def _resolve_alignment(nh: int, nr: int, cands) -> list:
    """Beam search over ref positions: each partial alignment leaves ref
    word j unmatched or takes a candidate starting there whose spans are
    free, keeping the BEAM_WIDTH best under (max covered, min chunks, min
    summed distance). Returns the chosen candidates."""
    by_ref = [[] for _ in range(nr)]
    for ci, c in enumerate(cands):
        by_ref[c[2]].append(ci)
    # (covered, chunks, dist, h_used bitmask, prev_hend, prev_rend, next_free_ref, chosen)
    beam = [(0, 0, 0, 0, -1, -1, 0, ())]
    for j in range(nr):
        if not by_ref[j]:
            continue
        nxt = list(beam)
        for covered, chunks, dist, h_used, ph, pr, free, chosen in beam:
            if free > j:
                continue
            for ci in by_ref[j]:
                hi, hl, ri, rl, _stage, _w = cands[ci]
                if ri + rl > nr:
                    continue
                hmask = ((1 << hl) - 1) << hi
                if h_used & hmask:
                    continue
                nxt.append((covered + hl + rl, chunks + (0 if (hi == ph and ri == pr) else 1),
                            dist + abs(hi - ri), h_used | hmask, hi + hl, ri + rl, ri + rl,
                            chosen + (ci,)))
        if len(nxt) > BEAM_WIDTH:
            nxt.sort(key=lambda s: (-s[0], s[1], s[2]))
            del nxt[BEAM_WIDTH:]
        beam = nxt
    best = min(beam, key=lambda s: (-s[0], s[1], s[2]))
    return [cands[ci] for ci in best[7]]


def _align(hyp: List[str], ref: List[str]) -> Tuple[float, ...]:
    """(wm_h, wm_r, wlen_h, wlen_r, matches, chunks) sufficient statistics."""
    records = sorted((hi, hl, ri, rl, w)
                     for hi, hl, ri, rl, _s, w in _resolve_alignment(len(hyp), len(ref),
                                                                     _collect_candidates(hyp, ref)))
    wm_h = wm_r = matches = 0.0
    chunks = 0
    prev_hend, prev_rend = -1, -1
    for hi, lh, ri, lr, w in records:
        matches += (lh + lr) / 2.0
        if hi != prev_hend or ri != prev_rend:  # a chunk needs adjacency in both
            chunks += 1
        prev_hend, prev_rend = hi + lh, ri + lr
        wm_h += w * sum(_word_weight(x) for x in hyp[hi:hi + lh])
        wm_r += w * sum(_word_weight(x) for x in ref[ri:ri + lr])
    return (wm_h, wm_r, sum(_word_weight(w) for w in hyp), sum(_word_weight(w) for w in ref),
            matches, chunks)


def score_from_stats(wm_h: float, wm_r: float, wlen_h: float, wlen_r: float, matches: float,
                     chunks: float) -> float:
    """The Meteor 1.5 formula over (possibly summed) statistics."""
    if matches == 0 or wlen_h <= 0 or wlen_r <= 0:
        return 0.0
    p, r = wm_h / wlen_h, wm_r / wlen_r
    if p + r == 0:
        return 0.0
    fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
    return (1 - GAMMA * (chunks / matches) ** BETA) * fmean


def segment_stats(refs: Sequence[str], hyp: str) -> Tuple[float, ...]:
    """The best reference's statistics for one segment."""
    best, best_score = None, -1.0
    for ref in refs:
        stats = _align(hyp.lower().split(), ref.lower().split())
        score = score_from_stats(*stats)
        if score > best_score:
            best, best_score = stats, score
    return best or (0.0, 0.0, 0.0, 0.0, 0, 0)


def corpus_meteor(references: List[List[str]], hypotheses: List[str]) -> float:
    """references[i]: reference strings; hypotheses[i]: a string. The
    formula over segment statistics summed corpus-wide."""
    assert len(references) == len(hypotheses)
    if not hypotheses:
        return 0.0
    totals = [0.0] * 6
    for refs, hyp in zip(references, hypotheses):
        for k, v in enumerate(segment_stats(refs, hyp)):
            totals[k] += v
    return score_from_stats(*totals)

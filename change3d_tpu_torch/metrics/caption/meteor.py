"""METEOR 1.5 for English (counterpart of
``change3d_tpu/metrics/caption/meteor.py``, whose semantics it keeps).

Scoring goes through the native library built from ``csrc/meteor.cpp`` (the
port's copy of the JAX package's ``native/meteor.cpp``, ABI version 4) by
the host C++ compiler (``ops/cuda_build.py``) at first use. A failed build
or an ABI mismatch raises; nothing falls back. ``backend="python"`` asks
for the pure-Python scorer below, which follows the C++ step for step
(its Porter stemmer included), so both give the same scores.

- matcher stages exact (weight 1.0), Porter stem (0.6), synonym (0.8,
  ``synonym_table=``) and paraphrase (0.6, ``paraphrase_table=``); the
  tables are plain text or .gz with lines ``a ||| b`` or the jar's
  ``prob ||| a ||| b``, made symmetric;
- content/function-word weighting (delta on content words), with a
  built-in common-English function-word list that ``function_words=`` (the
  jar's one-word-per-line ``function.words`` format, .gz accepted)
  replaces;
- alignment resolution by the jar's beam search over non-conflicting
  matches: most covered words, then fewest chunks, then least summed
  |hyp_start - ref_start|, beam width 40;
- per segment the best-scoring reference's sufficient statistics are kept,
  and the corpus score is the formula over the statistics summed over
  segments (the jar's aggregate line), not a mean of sentence scores.

The caption eval scores stringified token ids, on which the stem, synonym
and paraphrase stages and the function-word distinction are no-ops.

The native library keeps its tables in process-wide state. ``_NATIVE``
tracks which table paths are loaded there, sets them again when a call
asks for others, and holds a lock over each call's setting and scoring.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from change3d_tpu_torch.ops import cuda_build

# Meteor 1.5 English parameters (task 'rank'): alpha, beta, gamma, delta.
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
W_STEM = 0.6  # stem-stage module weight (the exact stage's is 1.0)
W_SYNONYM = 0.8  # synonym-stage module weight
W_PARAPHRASE = 0.6  # paraphrase-stage module weight
MAX_PHRASE_LEN = 6  # longest span the paraphrase matcher considers
BEAM_WIDTH = 40  # the jar's alignment-resolution beam size
NATIVE_ABI_VERSION = 4  # meteor_abi_version() of csrc/meteor.cpp
BACKENDS = ("native", "python")

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


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def _open_text(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    return opener(path, "rt", encoding="utf-8", errors="replace")


_FUNCTION_WORD_CACHE: Dict[str, frozenset] = {}
_TABLE_CACHE: Dict[str, Dict[str, List[str]]] = {}


def load_function_words(path: str) -> frozenset:
    """A function-word list (memoized by path) in the jar's function.words
    format: words split on whitespace, one per line, lowercased; .gz
    accepted. It replaces the built-in list."""
    if path not in _FUNCTION_WORD_CACHE:
        with _open_text(path) as f:
            _FUNCTION_WORD_CACHE[path] = frozenset(w.lower() for line in f for w in line.split())
    return _FUNCTION_WORD_CACHE[path]


def load_paraphrase_table(path: str) -> Dict[str, List[str]]:
    """A paraphrase (or synonym) table, memoized by path: plain text or .gz,
    lines ``phrase1 ||| phrase2`` or ``prob ||| phrase1 ||| phrase2``,
    lowercased, made symmetric; each phrase's targets in file order."""
    if path in _TABLE_CACHE:
        return _TABLE_CACHE[path]
    table: Dict[str, List[str]] = {}
    with _open_text(path) as f:
        for line in f:
            parts = [p.strip().lower() for p in line.split("|||")]
            if len(parts) == 2:
                a, b = parts
            elif len(parts) == 3:
                a, b = parts[1], parts[2]
            else:
                continue
            if not a or not b or a == b:
                continue
            for src, dst in ((a, b), (b, a)):
                targets = table.setdefault(src, [])
                if dst not in targets:
                    targets.append(dst)
    _TABLE_CACHE[path] = table
    return table


# ---------------------------------------------------------------------------
# The native scorer
# ---------------------------------------------------------------------------


class _NativeTables:
    """The table paths loaded into the native library's process-wide state
    (None: the built-in function words, no synonym or paraphrase stage)."""

    SETTERS = {"paraphrase": "meteor_set_paraphrase_table", "synonym": "meteor_set_synonym_table",
               "function_words": "meteor_set_function_words"}

    def __init__(self):
        self.lock = threading.Lock()
        self.loaded: Dict[str, Optional[str]] = {k: None for k in self.SETTERS}

    def set(self, lib, kind: str, path: Optional[str]) -> None:
        """Load ``path`` (None clears) unless it is loaded already; a .gz
        file goes through a decompressed temporary copy (the library reads
        plain text and keeps nothing of the file)."""
        if self.loaded[kind] == path:
            return
        self.loaded[kind] = None  # the setter clears before it loads
        setter = getattr(lib, self.SETTERS[kind])
        if path is None:
            setter(None)
            return
        if not path.endswith(".gz"):
            n = setter(os.fsencode(path))
        else:
            with _open_text(path) as src, tempfile.NamedTemporaryFile(
                    "w", suffix=".meteor.txt", encoding="utf-8") as tmp:
                tmp.write(src.read())
                tmp.flush()
                n = setter(os.fsencode(tmp.name))
        if n < 0:
            raise FileNotFoundError(f"METEOR {kind} file cannot be read: {path}")
        self.loaded[kind] = path


_NATIVE = _NativeTables()


def native_library():
    """The native scorer (built at first use), its ABI version checked;
    raises if it cannot be built or loaded, or its version differs."""
    lib = cuda_build.load("meteor")
    version = lib.meteor_abi_version()
    if version != NATIVE_ABI_VERSION:
        raise RuntimeError(f"{cuda_build.library_path('meteor')}: METEOR ABI version "
                           f"{version}, expected {NATIVE_ABI_VERSION}")
    return lib


def _native_stats(lib, refs: Sequence[str], hyp: str) -> Tuple[float, ...]:
    out = (ctypes.c_double * 7)()
    lib.meteor_segment_stats(hyp.encode(), "\n".join(refs).encode(), ALPHA, BETA, GAMMA, DELTA,
                             W_STEM, out)
    return tuple(out[:6])


# ---------------------------------------------------------------------------
# The Python scorer (csrc/meteor.cpp step for step)
# ---------------------------------------------------------------------------


class _Porter:
    """The classic 1980 Porter stemmer, as ``PorterStemmer`` of
    ``csrc/meteor.cpp`` implements it."""

    STEP2 = (("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
             ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"), ("eli", "e"),
             ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
             ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
             ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"))
    STEP3 = (("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
             ("ful", ""), ("ness", ""))
    STEP4 = ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent",
             "ou", "ism", "ate", "iti", "ous", "ive", "ize")

    def __init__(self, word: str):
        self.b = word

    def cons(self, i: int) -> bool:
        c = self.b[i]
        if c in "aeiou":
            return False
        if c == "y":
            return True if i == 0 else not self.cons(i - 1)
        return True

    def measure(self, j: int) -> int:
        """The m of [C](VC)^m[V] over b[0..j]."""
        n = i = 0
        while True:
            if i > j:
                return n
            if not self.cons(i):
                break
            i += 1
        i += 1
        while True:
            while True:
                if i > j:
                    return n
                if self.cons(i):
                    break
                i += 1
            i += 1
            n += 1
            while True:
                if i > j:
                    return n
                if not self.cons(i):
                    break
                i += 1
            i += 1

    def vowel_in_stem(self, j: int) -> bool:
        return any(not self.cons(i) for i in range(j + 1))

    def double_cons(self, j: int) -> bool:
        return j >= 1 and self.b[j] == self.b[j - 1] and self.cons(j)

    def cvc(self, i: int) -> bool:
        if i < 2 or not self.cons(i) or self.cons(i - 1) or not self.cons(i - 2):
            return False
        return self.b[i] not in "wxy"

    def ends(self, s: str) -> Optional[int]:
        """j (the index before the suffix) if b ends with s, else None."""
        return len(self.b) - len(s) - 1 if len(s) <= len(self.b) and self.b.endswith(s) else None

    def set_to(self, s: str, j: int) -> None:
        self.b = self.b[:j + 1] + s

    def stem(self) -> str:
        b = self.b
        if len(b) <= 2:
            return b
        # Step 1a
        if (j := self.ends("sses")) is not None:
            self.set_to("ss", j)
        elif (j := self.ends("ies")) is not None:
            self.set_to("i", j)
        elif self.ends("ss") is not None:
            pass
        elif self.ends("s") is not None:
            self.b = self.b[:-1]
        # Step 1b
        extra = False
        if (j := self.ends("eed")) is not None:
            if self.measure(j) > 0:
                self.b = self.b[:-1]
        elif (j := self.ends("ed")) is not None and self.vowel_in_stem(j):
            self.b, extra = self.b[:j + 1], True
        elif (j := self.ends("ing")) is not None and self.vowel_in_stem(j):
            self.b, extra = self.b[:j + 1], True
        if extra:
            k = len(self.b) - 1
            if any(self.ends(s) is not None for s in ("at", "bl", "iz")):
                self.b += "e"
            elif self.double_cons(k):
                if self.b[k] not in "lsz":
                    self.b = self.b[:-1]
            elif self.measure(k) == 1 and self.cvc(k):
                self.b += "e"
        # Step 1c
        if (j := self.ends("y")) is not None and self.vowel_in_stem(j):
            self.b = self.b[:-1] + "i"
        # Steps 2 and 3: the first suffix that matches decides
        for table in (self.STEP2, self.STEP3):
            for suffix, repl in table:
                if (j := self.ends(suffix)) is not None:
                    if self.measure(j) > 0:
                        self.set_to(repl, j)
                    break
        # Step 4
        for suffix in self.STEP4:
            if (j := self.ends(suffix)) is not None:
                if self.measure(j) > 1:
                    self.b = self.b[:j + 1]
                break
        if ((j := self.ends("ion")) is not None and j >= 0 and self.b[j] in "st"
                and self.measure(j) > 1):
            self.b = self.b[:j + 1]
        # Step 5a
        if (j := self.ends("e")) is not None:
            m = self.measure(j)
            if m > 1 or (m == 1 and not self.cvc(j)):
                self.b = self.b[:-1]
        # Step 5b
        k = len(self.b) - 1
        if k > 0 and self.double_cons(k) and self.b[k] == "l" and self.measure(k - 1) > 1:
            self.b = self.b[:-1]
        return self.b


def porter_stem(word: str) -> str:
    return _Porter(word).stem()


def _collect_candidates(hyp: List[str], ref: List[str], para, syn):
    """Candidate matches (hi, hl, ri, rl, stage, weight) of the four stages;
    each span pair once, from its earliest stage."""
    hs, rs = [porter_stem(x) for x in hyp], [porter_stem(x) for x in ref]
    cands, word_pairs = [], set()
    for j in range(len(ref)):
        for i in range(len(hyp)):
            if hyp[i] == ref[j]:
                cands.append((i, 1, j, 1, 0, 1.0))
            elif hs[i] == rs[j]:
                cands.append((i, 1, j, 1, 1, W_STEM))
            elif syn and ref[j] in syn.get(hyp[i], ()):
                cands.append((i, 1, j, 1, 2, W_SYNONYM))
            else:
                continue
            word_pairs.add((i, j))
    if para:
        seen = set()
        for i in range(len(hyp)):
            for lh in range(1, min(MAX_PHRASE_LEN, len(hyp) - i) + 1):
                for tgt in para.get(" ".join(hyp[i:i + lh]), ()):
                    tw = tgt.split()
                    lr = len(tw)
                    if lr == 0 or lr > len(ref):
                        continue
                    for j in range(len(ref) - lr + 1):
                        if ref[j:j + lr] != tw or (lh == lr == 1 and (i, j) in word_pairs):
                            continue
                        if (i, lh, j, lr) not in seen:
                            seen.add((i, lh, j, lr))
                            cands.append((i, lh, j, lr, 3, W_PARAPHRASE))
    return cands


def _resolve_alignment(nr: int, cands) -> list:
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


def _align(hyp: List[str], ref: List[str], para, syn, fw) -> Tuple[float, ...]:
    """(wm_h, wm_r, wlen_h, wlen_r, matches, chunks) sufficient statistics,
    summed in the C++ order."""
    weight = lambda w: (1.0 - DELTA) if w in fw else DELTA
    records = sorted((hi, ri, hl, rl, w) for hi, hl, ri, rl, _s, w
                     in _resolve_alignment(len(ref), _collect_candidates(hyp, ref, para, syn)))
    wlen_h = wlen_r = wm_h = wm_r = matches = 0.0
    for w in hyp:
        wlen_h += weight(w)
    for w in ref:
        wlen_r += weight(w)
    chunks, prev_hend, prev_rend = 0, -1, -1
    for hi, ri, hl, rl, w in records:
        matches += (hl + rl) / 2.0
        if hi != prev_hend or ri != prev_rend:  # a chunk needs adjacency in both
            chunks += 1
        prev_hend, prev_rend = hi + hl, ri + rl
        for x in hyp[hi:hi + hl]:
            wm_h += w * weight(x)
        for x in ref[ri:ri + rl]:
            wm_r += w * weight(x)
    return wm_h, wm_r, wlen_h, wlen_r, matches, chunks


def _python_stats(refs: Sequence[str], hyp: str, para, syn, fw) -> Tuple[float, ...]:
    best, best_score = (0.0,) * 6, None
    for ref in refs:
        if not ref:  # the C++ skips empty reference lines
            continue
        stats = _align(hyp.lower().split(), ref.lower().split(), para, syn, fw)
        score = score_from_stats(*stats)
        if best_score is None or score > best_score:
            best, best_score = stats, score
    return best


# ---------------------------------------------------------------------------
# Scores
# ---------------------------------------------------------------------------


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


def _segments(pairs, paraphrase_table, synonym_table, function_words, backend):
    """Each (refs, hyp) pair's best-reference statistics, one backend's."""
    if backend == "python":
        para = load_paraphrase_table(paraphrase_table) if paraphrase_table else None
        syn = load_paraphrase_table(synonym_table) if synonym_table else None
        fw = load_function_words(function_words) if function_words else FUNCTION_WORDS
        return [_python_stats(refs, hyp, para, syn, fw) for refs, hyp in pairs]
    if backend != "native":
        raise ValueError(f"METEOR backend {backend!r}: one of {BACKENDS}")
    lib = native_library()
    with _NATIVE.lock:
        for kind, path in (("paraphrase", paraphrase_table), ("synonym", synonym_table),
                           ("function_words", function_words)):
            _NATIVE.set(lib, kind, path)
        return [_native_stats(lib, refs, hyp) for refs, hyp in pairs]


def segment_stats(refs: Sequence[str], hyp: str, paraphrase_table: Optional[str] = None,
                  synonym_table: Optional[str] = None, function_words: Optional[str] = None,
                  backend: str = "native") -> Tuple[float, ...]:
    """The best reference's (wm_h, wm_r, wlen_h, wlen_r, matches, chunks)
    for one segment."""
    return _segments([(refs, hyp)], paraphrase_table, synonym_table, function_words,
                     backend)[0]


def sentence_meteor(refs: Sequence[str], hyp: str, paraphrase_table: Optional[str] = None,
                    synonym_table: Optional[str] = None, function_words: Optional[str] = None,
                    backend: str = "native") -> float:
    """The best single-reference Meteor 1.5 score of one hypothesis."""
    return score_from_stats(*segment_stats(refs, hyp, paraphrase_table, synonym_table,
                                           function_words, backend))


def corpus_meteor(references: List[List[str]], hypotheses: List[str],
                  paraphrase_table: Optional[str] = None, synonym_table: Optional[str] = None,
                  function_words: Optional[str] = None, backend: str = "native") -> float:
    """references[i]: reference strings; hypotheses[i]: a string. The
    formula over segment statistics summed corpus-wide."""
    if len(references) != len(hypotheses):
        raise ValueError(f"{len(references)} reference sets for {len(hypotheses)} hypotheses")
    if not hypotheses:
        return 0.0
    totals = [0.0] * 6
    for stats in _segments(list(zip(references, hypotheses)), paraphrase_table, synonym_table,
                           function_words, backend):
        for k, v in enumerate(stats):
            totals[k] += v
    return score_from_stats(*totals)

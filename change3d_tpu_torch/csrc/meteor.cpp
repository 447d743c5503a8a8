// METEOR scorer (exact + Porter-stem matching stages), C++ native core.
//
// change3d_tpu_torch's copy of the JAX package's native/meteor.cpp (same
// scoring, same ABI version 4); the port builds it with the host compiler
// (ops/cuda_build.py) and loads it from metrics/caption/meteor.py.
//
// Replaces the reference's one non-Python component — the meteor-1.5.jar JVM
// subprocess (the reference's eval_func/meteor/meteor.py:22-29) — with an
// in-process native library exposed through a C ABI for ctypes.
//
// Scoring follows Meteor 1.5 (Denkowski & Lavie 2014) for English:
//   - matcher stages exact (weight 1.0) then Porter-stem (weight 0.6);
//   - content/function-word weighting: each token weighs delta if it is a
//     content word and (1-delta) if it is a function word;
//   - P = weighted_matches_hyp / weighted_len_hyp,
//     R = weighted_matches_ref / weighted_len_ref,
//     Fmean = P*R / (alpha*P + (1-alpha)*R),
//     frag = chunks / ((m_hyp + m_ref)/2),
//     score = (1 - gamma * frag^beta) * Fmean;
//   - per segment the best-scoring reference's statistics are kept, and the
//     corpus ("final") score is computed from the *summed* statistics, the
//     way the jar's aggregate EVAL line works
//     (the reference's eval_func/meteor/meteor.py:33-56).
// Default parameters are the Meteor 1.5 English set: alpha=0.85, beta=0.2,
// gamma=0.6, delta=0.75.
//
// All four Meteor 1.5 matcher stages are implemented: exact (1.0),
// Porter-stem (0.6), synonym (0.8, via meteor_set_synonym_table) and
// paraphrase (0.6, via meteor_set_paraphrase_table) — the synonym/paraphrase
// data files are missing blobs in the reference repo, so those stages sit
// behind optional table loads. Alignment resolution is the jar's beam search
// over non-conflicting match subsets (maximize covered words, then minimize
// chunks, then minimize total |hyp_start - ref_start|; beam width 40), not a
// greedy first-match sweep. The function-word list defaults to a built-in
// common-English approximation of the jar's corpus-frequency list; supply
// the jar's own function.words via meteor_set_function_words for exact
// fidelity (no remaining divergence given the jar's data files).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <tuple>
#include <fstream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Porter stemmer (classic 1980 algorithm).
// ---------------------------------------------------------------------------

struct PorterStemmer {
  std::string b;

  bool is_consonant(int i) const {
    char c = b[i];
    if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u') return false;
    if (c == 'y') return i == 0 ? true : !is_consonant(i - 1);
    return true;
  }

  // Measure of the word between 0..j: [C](VC)^m[V]
  int measure(int j) const {
    int n = 0, i = 0;
    while (true) {
      if (i > j) return n;
      if (!is_consonant(i)) break;
      i++;
    }
    i++;
    while (true) {
      while (true) {
        if (i > j) return n;
        if (is_consonant(i)) break;
        i++;
      }
      i++;
      n++;
      while (true) {
        if (i > j) return n;
        if (!is_consonant(i)) break;
        i++;
      }
      i++;
    }
  }

  bool vowel_in_stem(int j) const {
    for (int i = 0; i <= j; i++)
      if (!is_consonant(i)) return true;
    return false;
  }

  bool double_consonant(int j) const {
    if (j < 1) return false;
    if (b[j] != b[j - 1]) return false;
    return is_consonant(j);
  }

  bool cvc(int i) const {
    if (i < 2 || !is_consonant(i) || is_consonant(i - 1) || !is_consonant(i - 2)) return false;
    char c = b[i];
    return c != 'w' && c != 'x' && c != 'y';
  }

  bool ends(const char* s, int* j) {
    size_t l = strlen(s);
    if (l > b.size()) return false;
    if (b.compare(b.size() - l, l, s) != 0) return false;
    *j = static_cast<int>(b.size() - l) - 1;
    return true;
  }

  void set_to(const char* s, int j) { b = b.substr(0, j + 1) + s; }

  std::string stem(const std::string& word) {
    if (word.size() <= 2) return word;
    b = word;
    int j;
    // Step 1a
    if (ends("sses", &j)) set_to("ss", j);
    else if (ends("ies", &j)) set_to("i", j);
    else if (ends("ss", &j)) { }
    else if (ends("s", &j)) b.pop_back();
    // Step 1b
    bool step1b_extra = false;
    if (ends("eed", &j)) {
      if (measure(j) > 0) b.pop_back();
    } else if (ends("ed", &j) && vowel_in_stem(j)) {
      b = b.substr(0, j + 1);
      step1b_extra = true;
    } else if (ends("ing", &j) && vowel_in_stem(j)) {
      b = b.substr(0, j + 1);
      step1b_extra = true;
    }
    if (step1b_extra) {
      int k = static_cast<int>(b.size()) - 1;
      int dummy;
      if (ends("at", &dummy) || ends("bl", &dummy) || ends("iz", &dummy)) b += "e";
      else if (double_consonant(k)) {
        char c = b[k];
        if (c != 'l' && c != 's' && c != 'z') b.pop_back();
      } else if (measure(k) == 1 && cvc(k)) b += "e";
    }
    // Step 1c
    if (ends("y", &j) && vowel_in_stem(j)) b[b.size() - 1] = 'i';
    // Step 2
    static const std::pair<const char*, const char*> step2[] = {
        {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"}, {"anci", "ance"},
        {"izer", "ize"}, {"abli", "able"}, {"alli", "al"}, {"entli", "ent"},
        {"eli", "e"}, {"ousli", "ous"}, {"ization", "ize"}, {"ation", "ate"},
        {"ator", "ate"}, {"alism", "al"}, {"iveness", "ive"}, {"fulness", "ful"},
        {"ousness", "ous"}, {"aliti", "al"}, {"iviti", "ive"}, {"biliti", "ble"}};
    for (auto& p : step2)
      if (ends(p.first, &j)) {
        if (measure(j) > 0) set_to(p.second, j);
        break;
      }
    // Step 3
    static const std::pair<const char*, const char*> step3[] = {
        {"icate", "ic"}, {"ative", ""}, {"alize", "al"}, {"iciti", "ic"},
        {"ical", "ic"}, {"ful", ""}, {"ness", ""}};
    for (auto& p : step3)
      if (ends(p.first, &j)) {
        if (measure(j) > 0) set_to(p.second, j);
        break;
      }
    // Step 4
    static const char* step4[] = {"al", "ance", "ence", "er", "ic", "able", "ible",
                                  "ant", "ement", "ment", "ent", "ou", "ism", "ate",
                                  "iti", "ous", "ive", "ize"};
    for (auto* s : step4)
      if (ends(s, &j)) {
        if (measure(j) > 1) b = b.substr(0, j + 1);
        break;
      }
    if (ends("ion", &j) && j >= 0 && (b[j] == 's' || b[j] == 't') && measure(j) > 1)
      b = b.substr(0, j + 1);
    // Step 5a
    if (ends("e", &j)) {
      int m = measure(j);
      if (m > 1 || (m == 1 && !cvc(j))) b.pop_back();
    }
    // Step 5b
    {
      int k = static_cast<int>(b.size()) - 1;
      if (k > 0 && double_consonant(k) && b[k] == 'l' && measure(k - 1) > 1) b.pop_back();
    }
    return b;
  }
};

std::vector<std::string> tokenize(const char* s) {
  std::vector<std::string> out;
  std::istringstream ss(s);
  std::string tok;
  while (ss >> tok) {
    std::string lower;
    for (char c : tok) lower += static_cast<char>(::tolower(static_cast<unsigned char>(c)));
    out.push_back(lower);
  }
  return out;
}

// Common-English function words (articles, pronouns, prepositions,
// conjunctions, auxiliaries, common adverbial particles). Approximates the
// jar's corpus-frequency-derived function.words list.
const std::set<std::string>& function_words() {
  static const std::set<std::string> words = {
      "a",     "an",    "the",   "and",  "or",    "but",   "nor",   "so",
      "yet",   "of",    "in",    "on",   "at",    "to",    "from",  "by",
      "with",  "about", "as",    "into", "like",  "through", "after", "over",
      "between", "out", "against", "during", "without", "before", "under",
      "around", "among", "for",  "is",   "am",    "are",   "was",   "were",
      "be",    "been",  "being", "have", "has",   "had",   "do",    "does",
      "did",   "will",  "would", "shall", "should", "may", "might", "must",
      "can",   "could", "i",     "you",  "he",    "she",   "it",    "we",
      "they",  "me",    "him",   "her",  "us",    "them",  "my",    "your",
      "his",   "its",   "our",   "their", "mine", "yours", "hers",  "ours",
      "theirs", "this", "that",  "these", "those", "there", "here", "where",
      "when",  "what",  "which", "who",  "whom",  "whose", "why",   "how",
      "not",   "no",    "if",    "then", "than",  "too",   "very",  "just",
      "also",  "up",    "down",  "off",  "some",  "any",   "all",   "both",
      "each",  "few",   "more",  "most", "other", "such",  "only",  "own",
      "same",  "s",     "t",     "now",  "while", "because", "until", "again",
  };
  return words;
}

// Custom function-word list (meteor_set_function_words): when loaded it
// REPLACES the built-in list, so the jar's own function.words file can be
// supplied verbatim for exact fidelity.
std::set<std::string>& custom_function_words() {
  static std::set<std::string> words;
  return words;
}
bool g_has_custom_function_words = false;

inline double word_weight(const std::string& w, double delta) {
  const std::set<std::string>& fw =
      g_has_custom_function_words ? custom_function_words() : function_words();
  return fw.count(w) ? (1.0 - delta) : delta;
}

// Paraphrase table (optional, meteor_set_paraphrase_table): phrase ->
// candidate target phrases (tokenized), in file order for determinism.
std::map<std::string, std::vector<std::vector<std::string>>>& paraphrase_table() {
  static std::map<std::string, std::vector<std::vector<std::string>>> table;
  return table;
}
bool g_has_paraphrases = false;
constexpr int kMaxPhraseLen = 6;
constexpr double kWParaphrase = 0.6;  // Meteor 1.5 English paraphrase weight
constexpr double kWSynonym = 0.8;     // Meteor 1.5 English synonym weight

// Synonym table (optional, meteor_set_synonym_table): word -> synonyms.
std::map<std::string, std::set<std::string>>& synonym_table() {
  static std::map<std::string, std::set<std::string>> table;
  return table;
}
bool g_has_synonyms = false;

// Sufficient statistics of one segment's alignment (Meteor 1.5 MeteorStats).
struct Stats {
  double wm_hyp = 0.0;   // stage- and delta-weighted matches, hypothesis side
  double wm_ref = 0.0;   // same, reference side
  double wlen_hyp = 0.0; // delta-weighted hypothesis length
  double wlen_ref = 0.0; // delta-weighted reference length
  double matches = 0.0;  // (m_hyp + m_ref)/2 — integral for 1-1 word stages
  int chunks = 0;
  double score = 0.0;    // segment score (used only to pick the best reference)
};

// One alignment block: hyp span [hi, hi+hl) matched to ref span [ri, ri+rl).
struct MatchRec {
  int hi, hl, ri, rl;
  double w;
  bool operator<(const MatchRec& o) const {
    return hi != o.hi ? hi < o.hi : ri < o.ri;
  }
};

double score_from(const Stats& s, double alpha, double beta, double gamma) {
  if (s.matches == 0 || s.wlen_hyp <= 0.0 || s.wlen_ref <= 0.0) return 0.0;
  double p = s.wm_hyp / s.wlen_hyp;
  double r = s.wm_ref / s.wlen_ref;
  if (p + r == 0.0) return 0.0;
  double fmean = p * r / (alpha * p + (1.0 - alpha) * r);
  double frag = static_cast<double>(s.chunks) / s.matches;  // matches = (m_h+m_r)/2
  double penalty = gamma * std::pow(frag, beta);
  return (1.0 - penalty) * fmean;
}

// One candidate match: hyp span [hi, hi+hl) vs ref span [ri, ri+rl), from
// matcher stage `stage` (0 exact, 1 stem, 2 synonym, 3 paraphrase) with the
// stage's module weight `w`. Unlike the final MatchRec set, candidates may
// conflict; the beam search below resolves them one-to-one.
struct Cand {
  int hi, hl, ri, rl, stage;
  double w;
};

// Dynamic bitset over hypothesis word indices (captions are ≤52 tokens, but
// real text has no bound, so no fixed width).
struct HypMask {
  std::vector<uint64_t> w;
  explicit HypMask(size_t n) : w((n + 63) / 64, 0) {}
  bool any(int start, int len) const {
    for (int k = start; k < start + len; k++)
      if (w[k >> 6] & (1ull << (k & 63))) return true;
    return false;
  }
  void set(int start, int len) {
    for (int k = start; k < start + len; k++) w[k >> 6] |= 1ull << (k & 63);
  }
};

// A partial alignment in the beam search: matches chosen so far (indices
// into the candidate list, in ref order), hypothesis coverage, and the
// running objective (covered words, chunks, total start distance).
struct Partial {
  HypMask h_used;
  int covered = 0, chunks = 0, dist = 0;
  int prev_hend = -1, prev_rend = -1;
  int next_free_ref = 0;  // first ref index not consumed by a chosen match
  std::vector<int> chosen;
  explicit Partial(size_t nh) : h_used(nh) {}
};

// Lexicographic objective of Meteor 1.5's alignment resolution: maximize
// covered words, then minimize chunks, then minimize the summed distance
// between matched start positions.
inline bool partial_better(const Partial& a, const Partial& b) {
  if (a.covered != b.covered) return a.covered > b.covered;
  if (a.chunks != b.chunks) return a.chunks < b.chunks;
  return a.dist < b.dist;
}

constexpr int kBeamWidth = 40;  // the jar's beam size

// Collect all candidate matches across the four stages. Each (hyp, ref) span
// pair appears at most once, attributed to its earliest matching stage (the
// jar's matchers skip pairs already matched by a prior stage).
std::vector<Cand> collect_candidates(const std::vector<std::string>& hyp,
                                     const std::vector<std::string>& ref,
                                     double w_stem) {
  PorterStemmer stemmer;
  size_t nh = hyp.size(), nr = ref.size();
  std::vector<Cand> cands;

  std::vector<std::string> hs(nh), rs(nr);
  for (size_t i = 0; i < nh; i++) hs[i] = stemmer.stem(hyp[i]);
  for (size_t j = 0; j < nr; j++) rs[j] = stemmer.stem(ref[j]);
  const auto& syn = synonym_table();

  // Word stages (1-1): earliest stage wins per pair. Generated ref-major so
  // the per-ref candidate lists the search consumes are naturally grouped.
  std::set<std::pair<int, int>> word_pairs;
  for (size_t j = 0; j < nr; j++)
    for (size_t i = 0; i < nh; i++) {
      if (hyp[i] == ref[j])
        cands.push_back({(int)i, 1, (int)j, 1, 0, 1.0});
      else if (hs[i] == rs[j])
        cands.push_back({(int)i, 1, (int)j, 1, 1, w_stem});
      else if (g_has_synonyms) {
        auto it = syn.find(hyp[i]);
        if (it != syn.end() && it->second.count(ref[j]))
          cands.push_back({(int)i, 1, (int)j, 1, 2, kWSynonym});
        else
          continue;
      } else {
        continue;
      }
      word_pairs.insert({(int)i, (int)j});
    }

  // Paraphrase stage: every table-backed span pair, both sides tokenized
  // (the table is symmetric by construction). 1-1 span pairs already
  // matched by a word stage are skipped.
  if (g_has_paraphrases) {
    const auto& table = paraphrase_table();
    std::set<std::tuple<int, int, int, int>> seen;
    for (size_t i = 0; i < nh; i++) {
      int max_lh = static_cast<int>(std::min<size_t>(kMaxPhraseLen, nh - i));
      std::string phrase;
      for (int lh = 1; lh <= max_lh; lh++) {
        if (lh > 1) phrase += " ";
        phrase += hyp[i + lh - 1];
        auto it = table.find(phrase);
        if (it == table.end()) continue;
        for (const auto& tw : it->second) {
          int lr = static_cast<int>(tw.size());
          if (lr == 0 || static_cast<size_t>(lr) > nr) continue;
          for (size_t j = 0; j + lr <= nr; j++) {
            bool ok = true;
            for (int k = 0; k < lr && ok; k++) ok = ref[j + k] == tw[k];
            if (!ok) continue;
            if (lh == 1 && lr == 1 && word_pairs.count({(int)i, (int)j})) continue;
            if (!seen.insert({(int)i, lh, (int)j, lr}).second) continue;
            cands.push_back({(int)i, lh, (int)j, lr, 3, kWParaphrase});
          }
        }
      }
    }
  }
  return cands;
}

// Meteor 1.5 alignment: resolve the candidate matches one-to-one with a beam
// search over ref positions — at each position a partial alignment either
// leaves the word unmatched or takes a candidate starting there whose spans
// are still free — keeping the kBeamWidth best partials under
// partial_better. This finds the max-covered / min-chunk alignment the jar's
// resolver finds, where a greedy first-match sweep can mis-chunk segments
// with repeated tokens.
Stats align(const std::vector<std::string>& hyp, const std::vector<std::string>& ref,
            double alpha, double beta, double gamma, double delta, double w_stem) {
  size_t nh = hyp.size(), nr = ref.size();
  std::vector<Cand> cands = collect_candidates(hyp, ref, w_stem);

  std::vector<std::vector<int>> by_ref(nr);
  for (size_t c = 0; c < cands.size(); c++) by_ref[cands[c].ri].push_back((int)c);

  std::vector<Partial> beam;
  beam.emplace_back(nh);
  for (size_t j = 0; j < nr; j++) {
    if (by_ref[j].empty()) continue;  // skip-only position: beam unchanged
    std::vector<Partial> next = beam;  // every partial may leave ref j unmatched
    for (const Partial& s : beam) {
      if (s.next_free_ref > (int)j) continue;  // ref j consumed by a phrase match
      for (int ci : by_ref[j]) {
        const Cand& c = cands[ci];
        if ((size_t)(c.ri + c.rl) > nr || s.h_used.any(c.hi, c.hl)) continue;
        Partial t = s;
        t.h_used.set(c.hi, c.hl);
        t.covered += c.hl + c.rl;
        if (c.hi != t.prev_hend || c.ri != t.prev_rend) t.chunks++;
        t.dist += std::abs(c.hi - c.ri);
        t.prev_hend = c.hi + c.hl;
        t.prev_rend = c.ri + c.rl;
        t.next_free_ref = c.ri + c.rl;
        t.chosen.push_back(ci);
        next.push_back(std::move(t));
      }
    }
    if (next.size() > kBeamWidth) {
      std::stable_sort(next.begin(), next.end(),
                       [](const Partial& a, const Partial& b) { return partial_better(a, b); });
      next.erase(next.begin() + kBeamWidth, next.end());
    }
    beam = std::move(next);
  }
  const Partial* best = &beam[0];
  for (const Partial& s : beam)
    if (partial_better(s, *best)) best = &s;

  std::vector<MatchRec> records;
  for (int ci : best->chosen) {
    const Cand& c = cands[ci];
    records.push_back({c.hi, c.hl, c.ri, c.rl, c.w});
  }
  std::sort(records.begin(), records.end());
  Stats s;
  for (size_t i = 0; i < nh; i++) s.wlen_hyp += word_weight(hyp[i], delta);
  for (size_t j = 0; j < nr; j++) s.wlen_ref += word_weight(ref[j], delta);
  // A chunk extends only while match blocks are adjacent in BOTH sentences
  // (Meteor 1.5 definition).
  int prev_hend = -1, prev_rend = -1;
  for (const auto& r : records) {
    s.matches += (r.hl + r.rl) / 2.0;
    if (r.hi != prev_hend || r.ri != prev_rend) s.chunks++;
    prev_hend = r.hi + r.hl;
    prev_rend = r.ri + r.rl;
    for (int k = 0; k < r.hl; k++) s.wm_hyp += r.w * word_weight(hyp[r.hi + k], delta);
    for (int k = 0; k < r.rl; k++) s.wm_ref += r.w * word_weight(ref[r.ri + k], delta);
  }
  s.score = score_from(s, alpha, beta, gamma);
  return s;
}

Stats best_reference_stats(const char* hypothesis, const char* references_nl,
                           double alpha, double beta, double gamma, double delta,
                           double w_stem) {
  auto hyp = tokenize(hypothesis);
  Stats best;
  bool first = true;
  std::istringstream ss(references_nl);
  std::string line;
  while (std::getline(ss, line)) {
    if (line.empty()) continue;
    auto ref = tokenize(line.c_str());
    Stats s = align(hyp, ref, alpha, beta, gamma, delta, w_stem);
    if (first || s.score > best.score) {
      best = s;
      first = false;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// Semantics/ABI version of this library. metrics/caption/meteor.py raises
// on a library whose version differs from its expected constant, so a
// stale binary can never silently score with outdated alignment rules. Bump
// BOTH sides when scoring semantics change.
int meteor_abi_version() { return 4; }

// Load (or clear, with path == nullptr) a custom function-word list in the
// jar's function.words format — one word per line (blank lines and
// whitespace ignored; words lowercased). While loaded it REPLACES the
// built-in common-English list, so supplying the jar's own file reproduces
// its content/function weighting exactly. Returns the word count, or -1 if
// the file cannot be read. An empty file is valid (all words content-
// weighted) and returns 0 with the custom (empty) list active.
int meteor_set_function_words(const char* path) {
  auto& words = custom_function_words();
  words.clear();
  g_has_custom_function_words = false;
  if (path == nullptr) return 0;
  std::ifstream f(path);
  if (!f) return -1;
  std::string line;
  while (std::getline(f, line)) {
    for (const std::string& tok : tokenize(line.c_str())) words.insert(tok);
  }
  g_has_custom_function_words = true;
  return static_cast<int>(words.size());
}

// Load (or clear, with path == nullptr) the paraphrase table used by the
// optional phrase-matching stage. Lines: "phrase1 ||| phrase2" or the jar's
// "prob ||| phrase1 ||| phrase2" (plain text; Python decompresses .gz).
// Returns the number of table entries, or -1 if the file cannot be read.
int meteor_set_paraphrase_table(const char* path) {
  auto& table = paraphrase_table();
  table.clear();
  g_has_paraphrases = false;
  if (path == nullptr) return 0;
  std::ifstream f(path);
  if (!f) return -1;

  auto lower_strip = [](std::string s) {
    size_t a = s.find_first_not_of(" \t\r\n");
    size_t b = s.find_last_not_of(" \t\r\n");
    if (a == std::string::npos) return std::string();
    s = s.substr(a, b - a + 1);
    for (char& c : s) c = static_cast<char>(::tolower(static_cast<unsigned char>(c)));
    return s;
  };

  std::string line;
  while (std::getline(f, line)) {
    std::vector<std::string> parts;
    size_t pos = 0;
    while (true) {
      size_t sep = line.find("|||", pos);
      parts.push_back(line.substr(pos, sep == std::string::npos ? sep : sep - pos));
      if (sep == std::string::npos) break;
      pos = sep + 3;
    }
    std::string a, b;
    if (parts.size() == 2) {
      a = lower_strip(parts[0]);
      b = lower_strip(parts[1]);
    } else if (parts.size() == 3) {
      a = lower_strip(parts[1]);
      b = lower_strip(parts[2]);
    } else {
      continue;
    }
    if (a.empty() || b.empty() || a == b) continue;
    for (auto& [src, dst] : {std::pair(a, b), std::pair(b, a)}) {
      auto toks = tokenize(dst.c_str());
      auto& cands = table[src];
      if (std::find(cands.begin(), cands.end(), toks) == cands.end())
        cands.push_back(toks);
    }
  }
  g_has_paraphrases = !table.empty();
  return static_cast<int>(table.size());
}

// Load (or clear, with path == nullptr) the word-level synonym table for the
// optional synonym stage (w=0.8). Same line formats as the paraphrase table;
// the mapping is made symmetric. Returns entry count or -1 on read failure.
int meteor_set_synonym_table(const char* path) {
  auto& table = synonym_table();
  table.clear();
  g_has_synonyms = false;
  if (path == nullptr) return 0;
  std::ifstream f(path);
  if (!f) return -1;

  auto lower_strip = [](std::string s) {
    size_t a = s.find_first_not_of(" \t\r\n");
    size_t b = s.find_last_not_of(" \t\r\n");
    if (a == std::string::npos) return std::string();
    s = s.substr(a, b - a + 1);
    for (char& c : s) c = static_cast<char>(::tolower(static_cast<unsigned char>(c)));
    return s;
  };

  std::string line;
  while (std::getline(f, line)) {
    std::vector<std::string> parts;
    size_t pos = 0;
    while (true) {
      size_t sep = line.find("|||", pos);
      parts.push_back(line.substr(pos, sep == std::string::npos ? sep : sep - pos));
      if (sep == std::string::npos) break;
      pos = sep + 3;
    }
    std::string a, b;
    if (parts.size() == 2) {
      a = lower_strip(parts[0]);
      b = lower_strip(parts[1]);
    } else if (parts.size() == 3) {
      a = lower_strip(parts[1]);
      b = lower_strip(parts[2]);
    } else {
      continue;
    }
    if (a.empty() || b.empty() || a == b) continue;
    table[a].insert(b);
    table[b].insert(a);
  }
  g_has_synonyms = !table.empty();
  return static_cast<int>(table.size());
}

// Best score over the (newline-separated) references for one hypothesis.
double meteor_sentence(const char* hypothesis, const char* references_nl,
                       double alpha, double beta, double gamma) {
  // delta / stem weight fixed at the Meteor 1.5 English values.
  return best_reference_stats(hypothesis, references_nl, alpha, beta, gamma, 0.75, 0.6)
      .score;
}

// Best-reference sufficient statistics for one segment, written into out[7]:
// [wm_hyp, wm_ref, wlen_hyp, wlen_ref, matches, chunks, segment_score].
// Aggregating these across segments and applying score_from gives the jar's
// corpus-level final score.
void meteor_segment_stats(const char* hypothesis, const char* references_nl,
                          double alpha, double beta, double gamma, double delta,
                          double w_stem, double* out) {
  Stats s = best_reference_stats(hypothesis, references_nl, alpha, beta, gamma,
                                 delta, w_stem);
  out[0] = s.wm_hyp;
  out[1] = s.wm_ref;
  out[2] = s.wlen_hyp;
  out[3] = s.wlen_ref;
  out[4] = static_cast<double>(s.matches);
  out[5] = static_cast<double>(s.chunks);
  out[6] = s.score;
}

// (Corpus aggregation of the per-segment statistics and the final-score
// formula live in Python — metrics/caption/meteor.py:score_from_stats — so
// the formula has a single owner; out[6] above ties the native per-segment
// score to it in the parity tests.)

// Porter stem into caller buffer (for tests); returns written length.
int meteor_stem(const char* word, char* out, int out_len) {
  PorterStemmer st;
  std::string s = st.stem(word);
  int n = static_cast<int>(s.size());
  if (n + 1 > out_len) return -1;
  memcpy(out, s.c_str(), n + 1);
  return n;
}
}

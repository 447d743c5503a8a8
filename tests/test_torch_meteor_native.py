"""The port's native METEOR (``csrc/meteor.cpp`` built by ``ops/cuda_build``)
against the JAX package's native scorer and against the port's Python
scorer: on stringified ids and on English text with synonym, paraphrase
(plain and .gz) and function-word files; tables set, switched and cleared
between calls; build and ABI failures raise."""

import gzip

import numpy as np
import pytest

from change3d_tpu.metrics.caption import meteor as jmeteor
from change3d_tpu.metrics.caption import score as jscore
from change3d_tpu_torch.metrics.caption import meteor
from change3d_tpu_torch.metrics.caption.score import eval_caption_scores
from change3d_tpu_torch.ops import cuda_build

REL = 1e-12

TEXT_REFS = [
    ["the buildings appeared beside the road", "many new houses were built near the street",
     "a parking lot was built in the empty field"],
    ["nothing has changed in the scene", "the scene is the same as before"],
    ["some trees were removed and a car park appeared", "the road was widened",
     "houses appeared along the roads"],
    ["a large building replaced the trees", "the forest was cleared for a factory"],
]
TEXT_HYPS = [
    "new homes appear near the road", "there is no change",
    "trees removed and a parking lot appeared", "a big factory replaced the forest",
]


def _ids(seed, n=40):
    rs = np.random.RandomState(seed)
    refs = [[" ".join(map(str, rs.randint(4, 30, rs.randint(1, 14)))) for _ in range(5)]
            for _ in range(n)]
    hyps = [" ".join(map(str, rs.randint(4, 30, rs.randint(0, 14)))) for _ in range(n)]
    return refs, hyps


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("meteor_tables")
    syn = "road ||| street\nhouses ||| homes\nlarge ||| big\nbuilt ||| constructed\n"
    para = ("0.5 ||| parking lot ||| car park\nno change ||| nothing has changed\n"
            "were removed ||| removed\nthe forest was cleared ||| the trees were cut\n")
    fw = "\n".join(["the", "a", "an", "of", "and", "near", "in", "was", "were", "is"]) + "\n"
    (d / "syn.txt").write_text(syn)
    (d / "para.txt").write_text(para)
    with gzip.open(d / "para.txt.gz", "wt") as f:
        f.write(para)
    with gzip.open(d / "syn.txt.gz", "wt") as f:
        f.write(syn)
    (d / "function.words").write_text(fw)
    return {"syn": str(d / "syn.txt"), "syn_gz": str(d / "syn.txt.gz"),
            "para": str(d / "para.txt"), "para_gz": str(d / "para.txt.gz"),
            "fw": str(d / "function.words")}


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package scores natively here (it builds native/ with make)."""
    assert jmeteor._load_native() is not None, "the JAX package's native METEOR did not load"


@pytest.mark.parametrize("seed", [0, 1])
def test_ids_equal_the_jax_native_scorer(seed):
    refs, hyps = _ids(seed)
    got = meteor.corpus_meteor(refs, hyps)
    assert got == pytest.approx(jmeteor.corpus_meteor(refs, hyps), rel=REL)
    assert got == pytest.approx(meteor.corpus_meteor(refs, hyps, backend="python"), rel=REL)
    for r, h in zip(refs[:10], hyps[:10]):
        want = jmeteor.sentence_meteor(r, h)
        assert meteor.sentence_meteor(r, h) == pytest.approx(want, rel=REL, abs=1e-15)
        assert meteor.sentence_meteor(r, h, backend="python") == pytest.approx(
            want, rel=REL, abs=1e-15)
        assert meteor.segment_stats(r, h) == pytest.approx(jmeteor.segment_stats(r, h), rel=REL)


TABLE_CASES = [
    {},
    {"synonym_table": "syn"},
    {"paraphrase_table": "para"},
    {"paraphrase_table": "para_gz"},
    {"synonym_table": "syn_gz", "function_words": "fw"},
    {"paraphrase_table": "para", "synonym_table": "syn", "function_words": "fw"},
    {},  # every table cleared again
]


def test_text_with_tables_equals_jax_and_the_python_scorer(tables):
    """Each case after the last, so the tables are switched and cleared in
    the library between calls."""
    scores = []
    for case in TABLE_CASES:
        kw = {k: tables[v] for k, v in case.items()}
        got = meteor.corpus_meteor(TEXT_REFS, TEXT_HYPS, **kw)
        assert got == pytest.approx(jmeteor.corpus_meteor(TEXT_REFS, TEXT_HYPS, **kw),
                                    rel=REL), case
        assert got == pytest.approx(
            meteor.corpus_meteor(TEXT_REFS, TEXT_HYPS, backend="python", **kw), rel=REL), case
        for r, h in zip(TEXT_REFS, TEXT_HYPS):
            want = jmeteor.sentence_meteor(r, h, **kw)
            assert meteor.sentence_meteor(r, h, **kw) == pytest.approx(want, rel=REL), case
            assert meteor.sentence_meteor(r, h, backend="python", **kw) == pytest.approx(
                want, rel=REL), case
        scores.append(got)
    none, syn, para, para_gz, syn_gz_fw, every, cleared = scores
    assert none == cleared and para == para_gz
    assert len({none, syn, para, syn_gz_fw, every}) == 5  # every table moves the score


def test_stemmer_equals_the_native_one():
    import ctypes

    lib = meteor.native_library()
    buf = ctypes.create_string_buffer(64)
    rs = np.random.RandomState(3)
    words = ["caresses", "ponies", "agreed", "motoring", "hopping", "falling", "relational",
             "generalizations", "oscillators", "adjustable", "homologou", "controll", "eds"]
    words += ["".join(rs.choice(list("aeiouybcdlmnrstgz"), rs.randint(1, 12)))
              for _ in range(3000)]
    for w in words:
        assert lib.meteor_stem(w.encode(), buf, 64) >= 0
        assert meteor.porter_stem(w) == buf.value.decode(), w


def test_eval_caption_scores_equal_jax_with_and_without_tables(tables):
    refs = [[r.split() for r in rr] for rr in TEXT_REFS]
    hyps = [h.split() for h in TEXT_HYPS]
    id_refs, id_hyps = _ids(5, n=12)
    for r, h, kw in ((refs, hyps, {}),
                     (refs, hyps, {"meteor_paraphrase_table": tables["para_gz"],
                                   "meteor_synonym_table": tables["syn"],
                                   "meteor_function_words": tables["fw"]}),
                     ([[x.split() for x in rr] for rr in id_refs],
                      [x.split() for x in id_hyps], {})):
        got, want = eval_caption_scores(r, h, **kw), jscore.eval_caption_scores(r, h, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=REL, abs=1e-15), (k, kw)


def test_a_missing_table_raises(tmp_path):
    for backend in meteor.BACKENDS:
        with pytest.raises(FileNotFoundError):
            meteor.corpus_meteor([["a b"]], ["a b"], synonym_table=str(tmp_path / "none.txt"),
                                 backend=backend)
    # The library is left without the table, and the next call works.
    assert meteor.corpus_meteor([["a b"]], ["a b"]) == pytest.approx(
        jmeteor.corpus_meteor([["a b"]], ["a b"]), rel=REL)
    with pytest.raises(ValueError, match="backend"):
        meteor.corpus_meteor([["a"]], ["a"], backend="jar")


def test_a_failing_compiler_raises(tmp_path, monkeypatch):
    """No fallback: with a compiler that fails and no library built, the
    score raises."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match=r"build failed:\s+meteor\.cpp \(exit 1\)"):
        meteor.corpus_meteor([["1 2 3"]], ["1 2"])
    assert not list(tmp_path.glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot start"):
        meteor.native_library()


def test_an_abi_mismatch_raises(monkeypatch):
    class _Stale:
        def meteor_abi_version(self):
            return 3

    monkeypatch.setattr(cuda_build, "load", lambda name: _Stale())
    with pytest.raises(RuntimeError, match="ABI version 3, expected 4"):
        meteor.corpus_meteor([["1 2 3"]], ["1 2"])

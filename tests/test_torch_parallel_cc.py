"""CC evaluation in two gloo processes (``evaluate_captions`` over the
process-sharded loader: 5 test images at an evaluation batch of 4, so the
second batch is padded, beam 2, a seeded TINY CC model) against one
process: both processes score exactly what one process scores, the gathered
hypotheses come back in the one-process order, and only process 0 writes
res.json / gts.json (equal to the one-process files)."""

import json
import os

import pytest

from change3d_tpu_torch.train.caption_loop import _allgather_caption_results

from tests import _torch_parallel as tp
from tests._torch_parallel import few_threads  # noqa: F401 (autouse)
from tests._tiny_cc import write_caption_dataset


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cc_eval")
    root, two, one = str(tmp / "data"), str(tmp / "two"), str(tmp / "one")
    write_caption_dataset(root, n_imgs=5)
    os.makedirs(two)
    procs = tp.start_ranks(tp.caption_eval_worker, 2, root, two)
    want = tp.caption_eval(root, one)
    tp.join_ok(procs, timeout=120)
    got = []
    for r in range(2):
        with open(os.path.join(two, f"scores-{r}.json")) as f:
            got.append(json.load(f))
    return want, got, one, two


def test_both_processes_score_the_one_process_set(runs):
    want, got, _, _ = runs
    assert got[0] == got[1] == want
    assert 0.0 <= want["Bleu_4"] <= 1.0


def test_process_zero_writes_the_one_process_files(runs):
    _, _, one, two = runs
    for name in ("res.json", "gts.json"):
        with open(os.path.join(one, name)) as f:
            want = json.load(f)
        with open(os.path.join(two, name)) as f:
            assert json.load(f) == want
    assert len(want) == 5
    assert sorted(os.listdir(two)) == ["gts.json", "res.json", "scores-0.json", "scores-1.json"]


def test_gather_alone_returns_the_lists():
    hyp, refs = [[4, 5]], [[[4], [5, 6]]]
    assert _allgather_caption_results(hyp, refs, [0]) == (hyp, refs)

"""tests/test_torch_export_cc.py at beam 2 (a file of its own keeps each
file's run short): the port's caption artifact against JAX's and the live
search, at batch 4 and 3."""

from tests.test_torch_export_cc import check_beam, pair  # noqa: F401


def test_caption_artifact_matches_jax_and_the_live_search_at_beam_2(pair):
    check_beam(pair, 2)

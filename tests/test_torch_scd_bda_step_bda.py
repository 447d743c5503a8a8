"""The checks of tests/test_torch_scd_bda_step.py on one fp32 BDA train
step and eval step, with the same limits."""

import pytest

from tests.test_torch_scd_bda_step import (  # noqa: F401 (collected here for BDA)
    make_run,
    test_eval_step_with_padded_batch_matches_jax,
    test_train_step_gradients_match_jax,
    test_train_step_loss_and_metrics_match_jax,
    test_train_step_state_matches_jax,
)


@pytest.fixture(scope="module")
def run():
    return make_run("bda")

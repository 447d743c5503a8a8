"""The fp32 CC train step of tests/test_torch_cc_step.py with the two other
optimizers of the CC loop: a separate encoder learning rate
(``per_subtree_lr``, encoder 3e-4 against 1e-3) and a frozen encoder
(``freeze_subtree``: no gradient into it, its parameters unchanged, its BN
running statistics still updated, as in JAX). Same checks and limits."""

import pytest

from tests.test_torch_cc_step import (  # noqa: F401  (collected here with this run)
    make_run,
    test_cc_step_gradients_match_jax,
    test_cc_step_loss_and_top1_match_jax,
    test_cc_step_state_matches_jax,
)


@pytest.fixture(scope="module", params=["encoder_lr", "frozen"])
def run(request):
    return make_run(request.param)

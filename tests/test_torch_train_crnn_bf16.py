"""The port's CRNN train step in bf16 against the JAX package's.

The CRNN (hidden 16) from the same parameters in both packages, one bf16
step of each package's own ``make_recognition_train_step`` under
``adam(1e-3)`` on a batch made with numpy from a seed, the JAX side on the
CPU; and two steps of the port's that lower the loss on a fixed batch. The bounds are bf16's, as
tests/test_torch_train_step.py states them (loss 1e-2 relative, gradients
0.1 by relative norm, parameters within 2 * lr + 1e-6). One file per
architecture keeps each under 30 s on the CPU (JAX compiles each step).
"""

import pytest

from tests.test_torch_train_step import check_recognition_bf16_step, check_two_steps_lower_the_loss


@pytest.mark.parametrize("arch", ["crnn"])
def test_recognition_bf16_steps_match_jax_train_step(arch):
    check_recognition_bf16_step(arch)


@pytest.mark.parametrize("arch", ["crnn"])
def test_two_steps_lower_the_loss_on_a_fixed_batch(arch):
    # As tests/test_parallel.py::test_recognition_train_step_sharded asserts
    # for the JAX step: one step of progress on a fixed batch.
    check_two_steps_lower_the_loss(arch)

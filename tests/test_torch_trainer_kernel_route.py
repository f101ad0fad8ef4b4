"""The port's training step on the attention kernel's route:
``attention_impl="auto"`` (the attention Function: the kernel's plain
version on CPU tensors, its backward a recompute of the plain version)
against the JAX trainer with ``attention_impl="fused_interpret"`` (the
Pallas kernel in interpret mode, with its custom VJP), at
tests/test_training.py's TINY configuration from JAX's initial parameters:
tolerances in _torch_train_parity.
"""

import pytest

from _torch_train_parity import assert_step_matches, jax_start, jax_tiny, torch_tiny
from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward


@pytest.fixture(scope="module")
def start():
    return jax_start()


def test_loss_and_grads_match_fused_interpret(start):
    tree, batch = start
    n = attention_forward.launches
    assert_step_matches(tree, batch, jax_tiny("fused_interpret"), torch_tiny("auto"))
    assert attention_forward.launches == n  # CPU tensors: the plain version

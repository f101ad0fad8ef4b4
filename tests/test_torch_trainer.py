"""The port's training step (forest_slam_tpu_torch.train.trainer.loss_fn and
its gradients) against train/trainer.py at tests/test_training.py's TINY
configuration on the dense attention route (``attention_impl="xla"`` on
both sides), with the zoomed-view descriptor term on (``w_zoom=1``,
trainer.py:178-210), from JAX's initial parameters carried over by
``params_from_jax``: tolerances in _torch_train_parity. The kernel's route
is in test_torch_trainer_kernel_route.py, the optimizer and checkpoints in
test_torch_train_state.py.
"""

import pytest

from _torch_train_parity import assert_step_matches, jax_start, jax_tiny, torch_tiny
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def start():
    return jax_start()


def test_loss_and_grads_match_jax(start):
    tree, batch = start
    jm, tm = assert_step_matches(tree, batch, jax_tiny("xla", w_zoom=1.0), torch_tiny("xla", w_zoom=1.0))
    assert jm["zoom"] > 0.5

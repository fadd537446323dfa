"""One train step of the port's Swin sim against JAX's, as
``tests/test_torch_port_train.py`` holds the ViT's (a file of its own: the
JAX side's compile and eager calibration take most of a minute).

Swin at 56 px, patch 4, embed 32, one stage of 2 blocks (the second
shifted: the stage's 14 x 14 grid is larger than the 7 x 7 window), drop
rates 0: the gradients within ``GRAD_RTOL`` of each tensor's largest, the
quant_stats bitwise equal to an eager JAX calibration step on the same
params and batch, the params within ``2 * lr`` of JAX's, and within
``1e-3 * lr`` where the gradient is clear of 0.
"""

import pytest
import torch

from test_torch_port_train import check_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards (Tier-1 runs six
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_swin_train_step_matches_jax():
    check_train_step("swin")

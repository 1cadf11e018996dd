"""Training mamba2-130m (the ssm family: a stack of Mamba-2 blocks, the
chunked SSD under autograd) in the port against the JAX package, on the
CPU.

Reduced mamba2 (2 layers, chunk 32) in fp32 at S = 64, two chunks, through
`tests/_torch_train_check.py`'s checks: loss, ce and every gradient leaf
against `jax.grad` of the JAX package's `loss_fn` within 1e-5 (no
attention: no call of row 12); remat "none" against "block"; two steps of
`make_train_step` (AdamW, 2 micro-batches) against the JAX package's.
"""

import pytest
import torch

import _torch_train_check as tc

ARCH = "mamba2-130m"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_and_every_gradient_leaf_match_jax():
    calls = tc.check_loss_and_grads(ARCH)
    assert calls["flash_attention"] == 0 and calls["flash_attention_backward"] == 0


def test_remat_none_and_block_give_the_same_gradients():
    tc.check_remat(ARCH)


def test_two_train_steps_match_reference():
    tc.check_train_steps(ARCH)

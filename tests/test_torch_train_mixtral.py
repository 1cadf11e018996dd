"""Training mixtral-8x7b (the moe family: top-2 MoE over 8 experts, a
sliding window) in the port against the JAX package, on the CPU.

Reduced mixtral (2 layers, 4 experts top 2, window 64) in fp32 at S = 96,
past its window, through `tests/_torch_train_check.py`'s checks: loss, ce,
aux and every gradient leaf against `jax.grad` of the JAX package's
`loss_fn` within 1e-5 (attention through `FlashAttentionFn` with the
window, its plain version here: twice a layer under remat "block", the
plain backward once); remat "none" against "block"; three steps of
`make_train_step` (AdamW, fp32 moments, 2 micro-batches) against the JAX
package's.
"""

import pytest
import torch

import _torch_train_check as mt

ARCH = "mixtral-8x7b"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_and_every_gradient_leaf_match_jax():
    calls = mt.check_loss_and_grads(ARCH)
    L = mt.cfgs(ARCH)[1].num_layers
    assert calls["flash_attention"] == 2 * L and calls["flash_attention_backward"] == L


def test_remat_none_and_block_give_the_same_gradients():
    mt.check_remat(ARCH)


def test_three_train_steps_match_reference():
    mt.check_train_steps(ARCH)

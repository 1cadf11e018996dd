"""Training pixtral-12b (the vlm family: patch embeddings prepended to the
tokens, the loss over the tokens alone) in the port against the JAX
package, on the CPU.

Reduced pixtral (2 layers, 16 patches) in fp32 at 16 + 32 positions,
through `tests/_torch_train_check.py`'s checks: loss, ce and every
gradient leaf against `jax.grad` of the JAX package's `loss_fn`, which
drops the patch positions' hidden states before the cross-entropy, within
1e-5 (attention through `FlashAttentionFn` over all 48 positions, its
plain version here); remat "none" against "block"; two steps of
`make_train_step` (AdamW, 2 micro-batches, the patches cut with the
tokens) against the JAX package's.
"""

import pytest
import torch

import _torch_train_check as tc

ARCH = "pixtral-12b"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_and_every_gradient_leaf_match_jax():
    calls = tc.check_loss_and_grads(ARCH)
    L = tc.cfgs(ARCH)[1].num_layers
    assert calls["flash_attention"] == 2 * L and calls["flash_attention_backward"] == L


def test_remat_none_and_block_give_the_same_gradients():
    tc.check_remat(ARCH)


def test_two_train_steps_match_reference():
    tc.check_train_steps(ARCH)

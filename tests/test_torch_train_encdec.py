"""Training whisper-medium (the encdec family: a non-causal encoder over the
frames, a decoder with cross attention) in the port against the JAX
package, on the CPU.

Reduced whisper (2 + 2 layers, 32 frames) in fp32 at S = 40 tokens,
through `tests/_torch_train_check.py`'s checks: loss, ce and every
gradient leaf, the encoder's included (its gradients reach it through
each decoder block's cross attention), against `jax.grad` of the JAX
package's `loss_fn` within 1e-5 (the encoder's and the decoder's
self-attention through `FlashAttentionFn`, its plain version here, twice
a layer under remat "block", the plain backward once; the cross attention
plain, Sq != Sk); remat "none" against "block"; two steps of
`make_train_step` (AdamW, 2 micro-batches, the frames cut with the
tokens) against the JAX package's.
"""

import pytest
import torch

import _torch_train_check as tc

ARCH = "whisper-medium"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_and_every_gradient_leaf_match_jax():
    calls = tc.check_loss_and_grads(ARCH)
    cfg = tc.cfgs(ARCH)[1]
    n = cfg.encoder_layers + cfg.num_layers
    assert calls["flash_attention"] == 2 * n and calls["flash_attention_backward"] == n


def test_remat_none_and_block_give_the_same_gradients():
    tc.check_remat(ARCH)


def test_two_train_steps_match_reference():
    tc.check_train_steps(ARCH)

"""Training recurrentgemma-9b (the hybrid family: super-blocks of (rec,
rec, attn), the RG-LRU's log-depth scan and local attention under
autograd, and a tail of rec blocks) in the port against the JAX package,
on the CPU.

Reduced recurrentgemma (two super-blocks, window 64) in fp32 at S = 96,
past its window, and with a tail (5 layers: one super-block and 2 rec
blocks, as the full config's 38 = 12 x 3 + 2) at S = 40, through
`tests/_torch_train_check.py`'s checks: loss, ce and every gradient leaf
against `jax.grad` of the JAX package's `loss_fn` within 1e-5 (attention
through `FlashAttentionFn`, its plain version here: twice an attention
layer under remat "block", the plain backward once); remat "none" against
"block"; two steps of `make_train_step` (AdamW, 2 micro-batches) against
the JAX package's, the optimizer state through `convert` over the
stacked roots `super` and `tail`.
"""

import pytest
import torch

import _torch_train_check as tc

CASES = ["recurrentgemma-9b", "recurrentgemma-9b tail"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_every_gradient_leaf_match_jax(case):
    calls = tc.check_loss_and_grads(case)
    cfg = tc.cfgs(case)[1]
    attn = cfg.num_layers // len(cfg.rglru.pattern) * cfg.rglru.pattern.count("attn")
    assert calls["flash_attention"] == 2 * attn and calls["flash_attention_backward"] == attn


def test_remat_none_and_block_give_the_same_gradients():
    tc.check_remat(CASES[0])


@pytest.mark.parametrize("case", CASES)
def test_two_train_steps_match_reference(case):
    tc.check_train_steps(case)

"""Training deepseek-v3-671b (the moe family: MLA, a shared expert beside
top-k routed ones, the multi-token-prediction head, Adafactor with bf16
states and bf16 gradient accumulation) in the port against the JAX
package, on the CPU.

Reduced deepseek-v3 (2 layers, MLA, 4 routed experts top 2 and a shared
one, the MTP head) in fp32 through `tests/_torch_train_check.py`'s checks:
loss, ce, aux, mtp and every gradient leaf (the MTP head's included)
against `jax.grad` of the JAX package's `loss_fn` within 1e-5 (MLA's
expanded form attends with `_plain_attention`: no call of row 12); remat
"none" against "block"; three steps of `make_train_step` at the config's
own Adafactor with bf16 states, bf16 accumulation and 4 micro-batches
against the JAX package's, its state in the JAX package's stacked shapes
and dtypes.
"""

import pytest
import torch

import _torch_train_check as mt

ARCH = "deepseek-v3-671b"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_and_every_gradient_leaf_match_jax():
    calls = mt.check_loss_and_grads(ARCH)
    assert calls["flash_attention"] == 0 and calls["flash_attention_backward"] == 0


def test_remat_none_and_block_give_the_same_gradients():
    mt.check_remat(ARCH)


def test_three_train_steps_match_reference():
    cfg = mt.cfgs(ARCH)[1]
    assert (cfg.optimizer, cfg.opt_state_dtype, cfg.grad_acc_dtype, cfg.num_micro_override) == \
        ("adafactor", "bfloat16", "bfloat16", mt.CASES[ARCH].step[2])
    mt.check_train_steps(ARCH)

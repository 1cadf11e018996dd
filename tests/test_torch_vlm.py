"""The port's VLM family (pixtral-12b reduced: 2 layers, 16 patch
embeddings) against the JAX package's, on the CPU.

`batch["patches"]` (B, 16, D) is prepended to the token embeddings, at
positions 0 ... 16 + S - 1; a prefill of the patches and 21 tokens writes
16 + 21 cache positions, and decode continues after the prefix (position
16 + k for token k, as the JAX package's `tests/models/test_smoke.py`
drives it).  The model (`tests/_torch_family.py`): forward hidden states
(the patch positions included), prefill logits and cache, 3 decode steps,
in fp32 within 2e-4 and in bf16 within 2e-2 of the reference's max
|value|.  The parameters' round trip through `convert`; `loss_fn` (which
drops the patch positions' hidden states) and a train step on the reduced
config.
"""

import pytest

from _torch_family import Case, check_model, check_round_trip, check_training_runs

ARCH = "pixtral-12b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_prefill_and_decode_match_reference(dtype):
    cfg, _params, cache = check_model(Case(ARCH, dtype, n_fwd=24, n_pre=21, n_dec=3,
                                           cache_len=48))
    assert cfg.num_patches == 16
    # the prefix and the tokens were written: 16 + 21 + 3 positions
    k = cache["layers"]["k"]
    assert k[:, :, :40].abs().amax(dim=(0, 1, 3, 4)).gt(0).all()
    assert not k[:, :, 40:].any()


def test_convert_round_trips_the_reference_tree():
    check_round_trip(ARCH)


def test_training_runs_on_the_cpu():
    check_training_runs(ARCH)

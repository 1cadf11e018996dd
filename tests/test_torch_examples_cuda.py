"""The examples' twins (`repro_torch.examples`) on the card.

Marked `cuda`: without a card these tests skip.  Each twin's `main()` on
the card must print the lines it prints on the CPU (as `untimed` leaves
them) and the JAX example's recorded lines (`sfc_expert_placement`'s only
under the numpy they were recorded with: its `rng.zipf` draws differ
between versions), launch the kernels of its path and call no plain
version.  `serve_lm` serves the same weights on both sides: its tokens and
each decode step's logits on the card must equal the CPU's, the logits
within 2e-4 (`_torch_serve_check`, near ties included).  This file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_examples_cuda.py
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import torch

from _torch_example_lines import EXAMPLE_LINES, RECORDED_NUMPY
from _torch_serve_check import assert_served_alike, per_request, recorded_logits
from repro_torch.examples import untimed
from repro_torch.kernels import ops as kops, ref as kref

PATH3 = ("morton_key", "decode", "parent", "children", "face_sweep", "eval_route",
         "inside_root", "owner_rank")
# the kernels each twin must launch on the card
MUST_LAUNCH = {
    "quickstart": PATH3 + ("face_neighbor",),
    "amr_fractal": ("morton_key", "decode", "children"),
    "multitree_cube": PATH3 + ("tree_transform",),
    "fem_diffusion": ("morton_key", "decode", "children", "face_sweep"),
    "sfc_expert_placement": (),
    "serve_lm": ("flash_attention",),
}


SERVE_TOL = 2e-4


def _printed(name: str, device: str):
    """The twin's lines as `untimed` leaves them, the dict `main` returns and,
    for `serve_lm`, each decode step's logits in call order."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf, calls = io.StringIO(), []
    guard = recorded_logits(mod, calls) if name == "serve_lm" else contextlib.nullcontext()
    with contextlib.redirect_stdout(buf), guard:
        r = mod.main(device=device)
    return untimed(buf.getvalue()), r, calls


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MUST_LAUNCH))
def test_twin_on_the_card_prints_the_cpu_lines_through_the_kernels(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want, want_r, want_calls = _printed(name, "cpu")
    kops.reset_launch_counts()
    kref.reset_call_counts()
    got, r, calls = _printed(name, "cuda")
    launches, plain = dict(kops.launch_counts), dict(kref.call_counts)
    assert got == want
    if name != "sfc_expert_placement" or np.__version__ == RECORDED_NUMPY:
        assert got == EXAMPLE_LINES[name]
    assert not any(plain.values()), plain
    assert all(launches[k] > 0 for k in MUST_LAUNCH[name]), launches
    if name == "serve_lm":        # 2 layers x 10 prefills, fp32 at hd 32
        assert launches["flash_attention"] == 20
        n, b, m = r["requests"], r["B"], len(r["tokens"][0])
        assert_served_alike(r["tokens"], per_request(calls, n, b, m), want_r["tokens"],
                            per_request(want_calls, n, b, m), SERVE_TOL)

"""Twins of the JAX package's examples (`examples/*.py`), on the port.

Each module runs as `python -m repro_torch.examples.<name>` on the card, or
on the CPU with `--device cpu`, and prints the JAX example's lines with its
wording and numbers.  Each keeps the example's constants as the defaults of
a function that returns what its `main` prints, as a dict:

  quickstart            New, Adapt, Balance, weighted Partition, Ghost, and
                        the element kernels called directly
  amr_fractal           the paper's Fig. 12 fractal count and Fig. 11's New
  multitree_cube        Balance and Ghost across the glued trees of a cube
  fem_diffusion         finite-volume diffusion over Iterate's face pairs
  sfc_expert_placement  the Partition rule on MoE loads and documents
  serve_lm              prefill and continuous batched decode of a reduced LM
  train_lm              the trainer with async checkpoints on a reduced or
                        a ~100M-parameter LM (its own flags besides --device)

`untimed` gives the lines a twin's output and its JAX example's share: times
and rates, the device named in a heading, and the conservation error's
digits (which depend on the order of a sum) left out.
"""

from __future__ import annotations

import argparse
import re

import torch

__all__ = ["untimed", "where", "sync", "cli"]

_DROPS = (
    (re.compile(r"\s+\S+s\s+\S+ ns/element$"), ""),                 # amr_fractal's Fig. 11
    (re.compile(r" in \S+s \(.*tok/s on .*\)$"), ""),                # serve_lm's wall and rate
)
_CONSERVATION = re.compile(r"conservation error = (\S+)")


def untimed(text: str) -> list[str]:
    """`text`'s lines with times and rates left out, a heading that names
    the kernels' device as "== kernels ==", and a conservation error below
    1e-12 as "conservation error < 1e-12"."""
    out = []
    for line in text.splitlines():
        if line.startswith("== ") and "kernels" in line:
            line = "== kernels =="
        for pat, rep in _DROPS:
            line = pat.sub(rep, line)
        line = _CONSERVATION.sub(
            lambda m: "conservation error < 1e-12" if float(m[1]) < 1e-12 else m[0], line)
        out.append(line)
    return out


def where(device: torch.device) -> str:
    """The device a twin ran on: the card's name, or "the CPU"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "the CPU"


def sync(device: torch.device) -> None:
    """Wait for the card's queued work, so that a host clock read after it
    counts that work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cli(main) -> None:
    """Run `main(device)` with the `--device` the command line gives (the
    card by default)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(device=ap.parse_args().device)

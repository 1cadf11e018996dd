"""End-to-end training with fault tolerance.

    python -m repro_torch.examples.train_lm --preset tiny --steps 40      # on the card
    python -m repro_torch.examples.train_lm --preset 100m --steps 300
    python -m repro_torch.examples.train_lm --device cpu

tiny  — a reduced qwen3 in fp32, seq 64, batch 8.
100m  — a ~100M-parameter qwen3-style model, seq 512.

Kill the process (Ctrl-C / SIGTERM) at any point and re-run: it resumes
from the latest checkpoint with an identical loss trajectory (the seekable
data pipeline and atomic checkpoints).  The weights are drawn from seed 0
by the port's generator (the JAX example draws its own from PRNGKey(0);
`train` also takes initial weights, to start both from the same ones).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from dataclasses import replace

from repro_torch.configs import get_config, reduced
from repro_torch.core.types import resolve_device
from repro_torch.launch.train import make_train_step
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime import Trainer, TrainerConfig

PRESETS = ("tiny", "100m")


def preset(name: str):
    base = get_config("qwen3-1.7b")
    if name == "tiny":
        cfg = replace(reduced(base), dtype="float32")
        shape = ShapeConfig("tiny", seq_len=64, global_batch=8, mode="train")
    elif name == "100m":
        cfg = replace(
            base, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32768, tie_embeddings=True,
        )  # ~100M params
        shape = ShapeConfig("100m", seq_len=512, global_batch=8, mode="train")
    else:
        raise SystemExit(f"unknown preset {name}")
    return cfg, shape


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def train(preset_name: str = "tiny", steps: int = 40, ckpt_dir: str | None = None,
          ckpt_every: int = 20, lr: float = 3e-4, device=None, params=None) -> dict:
    """Train `preset_name` for `steps` steps (resuming from
    `<ckpt_dir>_<preset>` if it holds a checkpoint); returns the config,
    the shape, the metrics log, the trained model and its optimizer state."""
    cfg, shape = preset(preset_name)
    step_fn = make_train_step(cfg, num_micro=1, lr=lr, warmup=20, total_steps=steps)
    trainer = Trainer(
        cfg, shape,
        TrainerConfig(ckpt_dir=f"{ckpt_dir or default_ckpt_dir()}_{preset_name}",
                      ckpt_every=ckpt_every, max_steps=steps),
        step_fn=step_fn, seed=0, device=resolve_device(device),
    )
    model, opt, log = trainer.run(0, params)
    return {"cfg": cfg, "shape": shape, "log": log, "params": model, "opt": opt,
            "device": trainer.device}


def lines(r: dict) -> list[str]:
    """The lines the JAX example prints for a run."""
    cfg, shape, log = r["cfg"], r["shape"], r["log"]
    out = [f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
           f"seq={shape.seq_len} batch={shape.global_batch}"]
    if log:
        out.append(f"steps {log[0]['step']}..{log[-1]['step']}  "
                   f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")
    return out


def main(device=None, preset_name: str = "tiny", steps: int = 40, ckpt_dir: str | None = None,
         ckpt_every: int = 20, lr: float = 3e-4) -> dict:
    cfg, shape = preset(preset_name)
    print(lines({"cfg": cfg, "shape": shape, "log": []})[0], flush=True)
    r = train(preset_name, steps, ckpt_dir, ckpt_every, lr, device)
    for line in lines(r)[1:]:
        print(line)
    return r


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=None, help="default: <tmp>/repro_torch_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args()
    main(a.device, a.preset, a.steps, a.ckpt_dir, a.ckpt_every, a.lr)

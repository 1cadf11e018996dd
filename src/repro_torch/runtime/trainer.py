"""Fault-tolerant training runtime (counterpart of the JAX package's
`repro.runtime.trainer`).

  * checkpoint/restart: async checkpoints every k steps; a restart resumes
    from the latest complete step with an identical data stream (the
    pipeline is a pure function of the step, `data.pipeline`);
  * preemption: SIGTERM/SIGINT set a "save at the next step boundary" flag;
  * elastic re-scaling: gathered checkpoints restore onto any layout;
    `DataPipeline.reshard` re-derives each rank's slice;
  * stragglers: a step-time watchdog flags slow steps, and
    `rebalance_weights` re-balances load with the paper's weighted
    Partition rule (`core.placement.target_ranks`);
  * determinism: losses depend only on (seed, step).

The trainer checkpoints `(params, opt)` in the JAX package's tree and
layout (layers stacked, keys sorted; `convert.lm_params_to_reference`,
`convert.opt_state_to_reference`; AdamW's moments, or Adafactor's
factored ones of each stacked leaf, in the state dtype), so a checkpoint
written by either package's trainer restores in the other's.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..core.placement import target_ranks
from ..core.types import resolve_device, to_numpy
from ..data import DataPipeline
from ..models.lm import LM, init_params
from ..optim import init_opt_state

__all__ = ["TrainerConfig", "StepWatchdog", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_steps: int = 200
    lr: float = 3e-4
    straggler_factor: float = 2.0   # step slower than factor*median => flagged
    log_path: Optional[str] = None


class StepWatchdog:
    def __init__(self, factor: float):
        self.factor = factor
        self.times: list[float] = []
        self.flagged: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        """Record a step's wall; True (and the step flagged) if it took more
        than `factor` times the median of the last 50, after 5 steps."""
        self.times.append(dt)
        med = float(np.median(self.times[-50:]))
        if len(self.times) > 5 and dt > self.factor * med:
            self.flagged.append(step)
            return True
        return False

    def rebalance_weights(self, per_rank_times: np.ndarray, device=None) -> np.ndarray:
        """Partition targets for straggler-aware re-balancing: ranks that
        run slow get proportionally less work on the next partition pass
        (the Partition rule over 8 items a rank weighted by 1 / time,
        computed on `device`, the card unless given)."""
        inv = 1.0 / np.maximum(per_rank_times, 1e-9)
        return to_numpy(target_ranks(np.repeat(inv, 8), len(per_rank_times), device=device))


class Trainer:
    """Runs `step_fn` (`launch.train.make_train_step`'s step) from step 0 or
    the latest checkpoint to `tcfg.max_steps`, on `device` (the card unless
    given)."""

    def __init__(self, cfg_model, shape, tcfg: TrainerConfig, *, step_fn, seed: int = 0,
                 dp_size: int = 1, device=None):
        self.cfg = cfg_model
        self.shape = shape
        self.tcfg = tcfg
        self.step_fn = step_fn
        self.device = resolve_device(device)
        self.pipeline = DataPipeline(cfg_model, shape, seed=seed, dp_size=dp_size,
                                     device=self.device)
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir)
        self.watchdog = StepWatchdog(tcfg.straggler_factor)
        self._preempted = False
        self.metrics_log: list[dict] = []

    def _install_signals(self) -> dict:
        """Installs the preemption handlers; returns the handlers they
        replace, for `_restore_signals`."""
        def handler(signum, frame):
            self._preempted = True
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # non-main thread (tests)
        return previous

    @staticmethod
    def _restore_signals(previous: dict) -> None:
        for sig, old in previous.items():
            # None: the old handler was not installed from Python
            signal.signal(sig, signal.SIG_DFL if old is None else old)

    def init_or_restore(self, seed: int = 0, params=None):
        """(params, opt, first step): the model drawn from `seed`, or the
        given initial `params` (an `LM`, used in place, or the JAX tree of
        weights), with fresh optimizer state; then both overwritten by the
        latest checkpoint under `ckpt_dir`, if there is one."""
        if params is None:
            model = init_params(self.cfg, seed, self.device)
        elif isinstance(params, LM):
            model = params
        else:
            model = convert.lm_params_from_reference(self.cfg, params, self.device)
        opt = init_opt_state(model, self.cfg.optimizer, self.cfg.opt_state_dtype)
        start = 0
        if latest_step(self.tcfg.ckpt_dir) is not None:
            shapes = init_params(self.cfg, device=torch.device("meta"))     # no memory
            like = (convert.lm_params_to_reference(shapes),
                    convert.opt_state_to_reference(shapes, init_opt_state(
                        shapes, self.cfg.optimizer, self.cfg.opt_state_dtype)))
            (p_tree, o_tree), manifest = restore_checkpoint(self.tcfg.ckpt_dir, like)
            convert.load_lm_params(model, p_tree)
            opt = convert.opt_state_from_reference(model, o_tree)
            start = manifest["step"] + 1
        return model, opt, start

    def run(self, seed: int = 0, params=None):
        """Train to `max_steps`; returns (params, opt, the metrics log: a
        dict a step with its step, loss, wall and straggler flag)."""
        previous = self._install_signals()
        log_f = None
        try:
            params, opt, start = self.init_or_restore(seed, params)
            log_f = open(self.tcfg.log_path, "a") if self.tcfg.log_path else None
            for step in range(start, self.tcfg.max_steps):
                t0 = time.time()
                batch = self.pipeline.batch(step)
                params, opt, metrics = self.step_fn(params, opt, batch, step)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                slow = self.watchdog.record(step, dt)
                rec = {"step": step, "loss": loss, "dt": dt, "straggler": slow}
                self.metrics_log.append(rec)
                if log_f:
                    log_f.write(json.dumps(rec) + "\n")
                    log_f.flush()
                if (step + 1) % self.tcfg.ckpt_every == 0 or self._preempted \
                        or step + 1 == self.tcfg.max_steps:
                    self.ckpt.save((convert.lm_params_to_reference(params),
                                    convert.opt_state_to_reference(params, opt)), step=step)
                if self._preempted:
                    break
            self.ckpt.wait()
        finally:
            if log_f:
                log_f.close()
            self._restore_signals(previous)
        return params, opt, self.metrics_log

"""Training checkpoints and the trainer of the port against the JAX package's,
on the CPU.

`(params, opt)` in the JAX package's tree: the same state saved by both
packages gives the same manifest and every `.npy` byte for byte, bf16
parameters included.  Restarts: the port's trainer killed at step 5 and
resumed equals its uninterrupted run (the reference's own test, rtol 1e-5);
across packages, JAX trains 5 steps and saves, the port restores and trains
to 10, and the reverse, each within 1e-4 of the JAX package's
uninterrupted losses.  The `train_lm` twin prints the JAX example's first
line, and its loss line from the example's weights within 1e-4.  The JAX
side is computed once a case.
"""

import contextlib
import functools
import importlib.util
import io
import json
import re
import signal
import sys
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import save_checkpoint as j_save
from repro.launch.train import make_train_step as j_make_step
from repro.models import init_params as j_init_params
from repro.models.config import ShapeConfig as JShape
from repro.optim import init_opt_state as j_init_opt
from repro.runtime import Trainer as JTrainer, TrainerConfig as JTrainerConfig
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.examples import train_lm
from repro_torch.launch.train import make_train_step
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
ARCH = "olmo-1b"        # the reference's trainer test model
SEQ, GB, SEED, LR = 32, 8, 3, 1e-3
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_files(a: Path, b: Path) -> None:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("arch,dtype", [("qwen3-1.7b", "bfloat16"), ("olmo-1b", "float32"),
                                        ("phi3-mini-3.8b", "float32")])
def test_params_and_opt_checkpoint_is_the_references_byte_for_byte(arch, dtype, tmp_path):
    """After two JAX steps (nonzero moments), the state carried into the
    port and saved there equals the JAX package's save; the port restores
    either and gets its own state back (bf16 leaves as bf16 tensors)."""
    jcfg = replace(jconfigs.reduced(jconfigs.get_config(arch)), dtype=dtype)
    params = j_init_params(jcfg, jax.random.PRNGKey(2))
    opt = j_init_opt(params, jcfg.optimizer, jcfg.opt_state_dtype)
    step = jax.jit(j_make_step(jcfg, num_micro=1, lr=1e-2))
    for i in range(2):
        toks = np.random.default_rng(i).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
        params, opt, _ = step(params, opt, {"tokens": jax.numpy.asarray(toks)}, jax.numpy.int32(i))
    j_save(tmp_path / "jax", (params, opt), step=1, sharded=True)
    cfg = replace(tconfigs.reduced(tconfigs.get_config(arch)), dtype=dtype)
    to_np = lambda t: jax.tree.map(np.asarray, t)       # noqa: E731
    model = convert.lm_params_from_reference(cfg, to_np(params), device="cpu")
    topt = convert.opt_state_from_reference(model, to_np(opt))
    tree = (convert.lm_params_to_reference(model), convert.opt_state_to_reference(model, topt))
    save_checkpoint(tmp_path / "port", tree, step=1, sharded=True)
    _same_files(tmp_path / "port" / "step_1", tmp_path / "jax" / "step_1")
    manifest = json.loads((tmp_path / "port" / "step_1" / "manifest.json").read_text())
    assert manifest["sharded"] and ("bfloat16" in {e["dtype"] for e in manifest["leaves"]}) == \
        (dtype == "bfloat16")
    for d in ("port", "jax"):
        got, _ = restore_checkpoint(tmp_path / d, tree)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            if isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16:
                assert isinstance(a, torch.Tensor) and torch.equal(a, b)
            else:
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------- restarts
def _cfgs():
    return (replace(tconfigs.reduced(tconfigs.get_config(ARCH)), dtype="float32"),
            replace(jconfigs.reduced(jconfigs.get_config(ARCH)), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_step():
    return jax.jit(j_make_step(_cfgs()[1], num_micro=1, lr=LR))


def _jax_trainer(ckpt: Path, max_steps: int):
    return JTrainer(_cfgs()[1], JShape("test", SEQ, GB, "train"),
                    JTrainerConfig(ckpt_dir=str(ckpt), ckpt_every=5, max_steps=max_steps),
                    step_fn=_jax_step(), seed=SEED)


def _port_trainer(ckpt: Path, max_steps: int):
    cfg = _cfgs()[0]
    return Trainer(cfg, ShapeConfig("test", SEQ, GB, "train"),
                   TrainerConfig(ckpt_dir=str(ckpt), ckpt_every=5, max_steps=max_steps),
                   step_fn=make_train_step(cfg, num_micro=1, lr=LR), seed=SEED, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_uninterrupted(tmp: str):
    _, _, log = _jax_trainer(Path(tmp) / "jax_full", 10).run(jax.random.PRNGKey(1))
    return {r["step"]: r["loss"] for r in log}


def _initial_weights():
    return jax.tree.map(np.asarray, j_init_params(_cfgs()[1], jax.random.PRNGKey(1)))


def _assert_losses(log: list, want: dict, steps: list, rtol: float) -> None:
    assert [r["step"] for r in log] == steps
    for r in log:
        assert abs(r["loss"] - want[r["step"]]) <= rtol * abs(want[r["step"]]), r


def test_port_trainer_restart_is_identical(tmp_path):
    """The reference's `test_trainer_checkpoint_restart_identical` on the
    port: 10 uninterrupted steps, against 5, a restart, and 5 more; the
    log file holds a JSON line a step."""
    tr = _port_trainer(tmp_path / "full", 10)
    tr.tcfg.log_path = str(tmp_path / "log.jsonl")
    _, _, full = tr.run(seed=1)
    logged = [json.loads(x) for x in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert logged == full and [r["step"] for r in full] == list(range(10))
    _port_trainer(tmp_path / "resume", 5).run(seed=1)
    _, _, log = _port_trainer(tmp_path / "resume", 10).run(seed=1)
    _assert_losses(log, {r["step"]: r["loss"] for r in full}, [5, 6, 7, 8, 9], 1e-5)


def test_trainer_saves_on_sigterm_and_restores_the_handlers(tmp_path):
    """SIGTERM mid-run saves at the step boundary and stops; after `run`,
    SIGTERM and SIGINT have the handlers they had before it."""
    def before(signum, frame):
        raise AssertionError("the trainer's handler should have taken the signal")

    tr = _port_trainer(tmp_path, 10)
    step_fn = tr.step_fn

    def step(params, opt, batch, i):
        if i == 2:
            signal.raise_signal(signal.SIGTERM)
        return step_fn(params, opt, batch, i)

    tr.step_fn = step
    old = {sig: signal.signal(sig, before) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        _, _, log = tr.run(seed=1)
        after = {sig: signal.getsignal(sig) for sig in old}
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)
    assert [r["step"] for r in log] == [0, 1, 2]
    assert latest_step(str(tmp_path)) == 2
    assert after == {signal.SIGTERM: before, signal.SIGINT: before}


def test_jax_checkpoint_resumes_in_the_port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_to_port")
    want = _jax_uninterrupted(str(tmp_path_factory.getbasetemp()))
    _jax_trainer(tmp, 5).run(jax.random.PRNGKey(1))
    _, _, log = _port_trainer(tmp, 10).run()
    _assert_losses(log, want, [5, 6, 7, 8, 9], TOL)


def test_port_checkpoint_resumes_in_jax(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_to_jax")
    want = _jax_uninterrupted(str(tmp_path_factory.getbasetemp()))
    _, _, first = _port_trainer(tmp, 5).run(params=_initial_weights())
    _assert_losses(first, want, [0, 1, 2, 3, 4], TOL)
    _, _, log = _jax_trainer(tmp, 10).run(jax.random.PRNGKey(7))     # weights from the file
    _assert_losses(log, want, [5, 6, 7, 8, 9], TOL)


def test_step_watchdog_matches_reference():
    """The reference's watchdog test on the port's, and the straggler
    re-balancing targets equal to the JAX package's."""
    from repro.runtime.trainer import StepWatchdog as JWatchdog
    from repro_torch.runtime import StepWatchdog

    w, jw = StepWatchdog(2.0), JWatchdog(2.0)
    times = [0.1] * 10 + [0.5, 0.1, 0.25]
    assert [w.record(i, t) for i, t in enumerate(times)] == \
        [jw.record(i, t) for i, t in enumerate(times)]
    assert w.flagged == jw.flagged == [10, 12]
    per_rank = np.array([1.0, 1.0, 3.0, 0.5])
    got = w.rebalance_weights(per_rank, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jw.rebalance_weights(per_rank)))
    assert got.dtype == np.int32 and got.shape == (32,)


# ----------------------------------------------------------- the twin
def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _jax_example_lines(ckpt: str) -> list:
    mod = _jax_example()
    argv = sys.argv
    sys.argv = ["train_lm.py", "--steps", "4", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = argv
    return out.getvalue().splitlines()


def test_train_lm_twin_prints_the_examples_lines(tmp_path_factory):
    want = _jax_example_lines(str(tmp_path_factory.mktemp("jax_example") / "ckpt"))
    mod = _jax_example()
    cfg, _shape = mod.preset("tiny")
    weights = jax.tree.map(np.asarray, j_init_params(cfg, jax.random.PRNGKey(0)))
    r = train_lm.train("tiny", steps=4, ckpt_dir=str(tmp_path_factory.mktemp("port") / "ckpt"),
                       ckpt_every=2, device="cpu", params=weights)
    got = train_lm.lines(r)
    assert len(got) == len(want) == 2 and got[0] == want[0]
    num = re.compile(r"steps (\d+)\.\.(\d+)  loss (\S+) -> (\S+)")
    g, w = num.fullmatch(got[1]).groups(), num.fullmatch(want[1]).groups()
    assert g[:2] == w[:2] == ("0", "3")
    for a, b in zip(g[2:], w[2:]):      # printed to 3 decimals
        assert abs(float(a) - float(b)) <= 1e-3 + TOL * abs(float(b))
    jlog = [r["loss"] for r in r["log"]]
    assert len(jlog) == 4 and all(np.isfinite(jlog))


def test_train_lm_twin_main_prints_on_the_cpu(tmp_path, capsys):
    train_lm.main(device="cpu", steps=2, ckpt_dir=str(tmp_path / "c"), ckpt_every=1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == train_lm.lines({"cfg": train_lm.preset("tiny")[0],
                                       "shape": train_lm.preset("tiny")[1], "log": []})[0]
    assert lines[1].startswith("steps 0..1  loss ")
    with pytest.raises(SystemExit):
        train_lm.preset("1b")

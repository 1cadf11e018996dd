"""The port's train step (`repro_torch.launch.train`) against the JAX
package's, on the CPU.

Reduced qwen3 and olmo in fp32 from the same weights and batches: five
steps of `make_train_step` at `num_micro` 1 and 2 (warm-up, then the
cosine decay; the clip active), each step's loss, ce, grad_norm and lr, and
every parameter and moment after the fifth step within 1e-4 (relative; the
fp32 sums in another order, over five AdamW steps).  In the configs' own
bf16, each step's loss within 2^-7 and grad_norm within 2^-6, relative.  `default_num_micro`
equals the reference's rule on one device, `abstract_train_state` holds no
memory.  The JAX side of each case is computed once.
"""

import functools
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch.train import make_train_step as j_make_step
from repro.models import init_params as j_init_params
from repro.models.config import ShapeConfig as JShape
from repro.optim import init_opt_state as j_init_opt
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.launch.train import abstract_train_state, default_num_micro, make_train_step
from repro_torch.models import init_params
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import init_opt_state

TOL = 1e-4
BF16_ULP = 2.0 ** -7
STEPS, B, S = 5, 4, 32
KW = dict(lr=1e-2, warmup=2, total_steps=6, clip_norm=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(vocab: int) -> list:
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, (B, S)).astype(np.int32) for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, num_micro: int, dtype: str = "float32"):
    cfg = replace(jconfigs.reduced(jconfigs.get_config(arch)), dtype=dtype)
    params = j_init_params(cfg, jax.random.PRNGKey(5))
    start = jax.tree.map(np.asarray, params)
    opt = j_init_opt(params, cfg.optimizer, cfg.opt_state_dtype)
    step = jax.jit(j_make_step(cfg, num_micro=num_micro, **KW))
    metrics = []
    for i, toks in enumerate(_batches(cfg.vocab_size)):
        params, opt, m = step(params, opt, {"tokens": jax.numpy.asarray(toks)},
                              jax.numpy.int32(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return start, metrics, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmo-1b"])
@pytest.mark.parametrize("num_micro", [1, 2])
def test_five_train_steps_match_reference(arch, num_micro):
    start, want_metrics, want_params, want_opt = _jax_run(arch, num_micro)
    cfg = replace(tconfigs.reduced(tconfigs.get_config(arch)), dtype="float32")
    model = convert.lm_params_from_reference(cfg, start, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())     # serving default
    opt = init_opt_state(model, cfg.optimizer, cfg.opt_state_dtype)
    step = make_train_step(cfg, num_micro=num_micro, **KW)
    for i, toks in enumerate(_batches(cfg.vocab_size)):
        model, opt, m = step(model, opt, {"tokens": torch.from_numpy(toks)}, i)
        want = want_metrics[i]
        assert set(m) == set(want) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(float(m[k]) - want[k]) <= TOL * abs(want[k]), (i, k, float(m[k]), want[k])
    assert all(p.grad is None and p.requires_grad for p in model.parameters())
    got_opt = convert.opt_state_to_reference(model, opt)
    assert int(got_opt.step) == int(want_opt.step) == STEPS
    for got, want in ((convert.lm_params_to_reference(model), want_params),
                      (got_opt.mu, want_opt.mu), (got_opt.nu, want_opt.nu)):
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                        jax.tree.leaves(want)):
            assert a.shape == b.shape and _rel(torch.from_numpy(a), b) <= TOL


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmo-1b"])
@pytest.mark.parametrize("num_micro", [1, 2])
def test_five_bf16_train_steps_track_the_reference(arch, num_micro):
    """The configs' own bf16 (matrices, activations and gradients bf16;
    norm scales, moments and accumulation fp32), as phase 8a of `chip_smoke.py` trains
    on the card: each step's loss within one bf16 ulp at 1 (2^-7), relative,
    and grad_norm within two, of the JAX package's bf16 step from the same
    weights.  Both round every bf16 op; they differ in the order of sums
    and in XLA's fusions, which keep some intermediates in fp32."""
    start, want_metrics, _, _ = _jax_run(arch, num_micro, "bfloat16")
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    assert cfg.dtype == "bfloat16"
    model = convert.lm_params_from_reference(cfg, start, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters() if p.dim() > 1)
    opt = init_opt_state(model, cfg.optimizer, cfg.opt_state_dtype)
    step = make_train_step(cfg, num_micro=num_micro, **KW)
    for i, toks in enumerate(_batches(cfg.vocab_size)):
        model, opt, m = step(model, opt, {"tokens": torch.from_numpy(toks)}, i)
        want = want_metrics[i]
        for k, tol in (("loss", BF16_ULP), ("ce", BF16_ULP), ("grad_norm", 2 * BF16_ULP)):
            assert abs(float(m[k]) - want[k]) <= tol * abs(want[k]), (i, k, float(m[k]), want[k])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmo-1b", "phi3-mini-3.8b",
                                  "deepseek-coder-33b", "deepseek-v3-671b"])
@pytest.mark.parametrize("shape", [("train_4k", 4096, 256), ("small", 64, 8), ("odd", 32, 6),
                                   ("one", 16, 1)])
def test_default_num_micro_matches_the_reference_rule_on_one_device(arch, shape):
    """The reference's rule with every data-parallel axis of size 1 (its
    mesh enters only through the product of those axes)."""
    from repro.launch.train import default_num_micro as j_default

    class OneDevice:
        shape = {"data": 1, "model": 1}
        axis_names = ("data", "model")

    name, seq, gb = shape
    want = j_default(jconfigs.get_config(arch), JShape(name, seq, gb, "train"), OneDevice())
    assert default_num_micro(tconfigs.get_config(arch), ShapeConfig(name, seq, gb, "train")) \
        == want
    # and with a mesh: the data-parallel axes that divide the batch share it
    from repro_torch.launch.mesh import MeshShape

    class Mesh:
        shape = {"data": 4, "model": 2}
        axis_names = ("data", "model")

    free = replace(tconfigs.get_config(arch), num_micro_override=None)
    jfree = replace(jconfigs.get_config(arch), num_micro_override=None)
    for ours, theirs in ((MeshShape(("data", "model"), (1, 1)), OneDevice()),
                         (MeshShape(("data", "model"), (4, 2)), Mesh())):
        assert default_num_micro(free, ShapeConfig(name, seq, gb, "train"), mesh=ours) == \
            j_default(jfree, JShape(name, seq, gb, "train"), theirs)


def test_qwen3_train_4k_cut_to_batch_8_takes_two_micro_batches():
    cfg = tconfigs.get_config("qwen3-1.7b")
    assert default_num_micro(cfg, ShapeConfig("train_4k", 4096, 8, "train")) == 2


def test_abstract_train_state_holds_no_memory_and_refuses_adafactor():
    cfg = tconfigs.get_config("qwen3-1.7b")
    params, opt = abstract_train_state(cfg)
    assert all(p.device.type == "meta" for p in params.parameters())
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count() + \
        (2 * cfg.num_layers + 1) * cfg.d_model + 2 * cfg.num_layers * cfg.resolved_head_dim
    assert opt.mu["tok_embed"].device.type == "meta" and opt.mu["tok_embed"].dtype == torch.float32
    # Adafactor trains now (tests/test_torch_adafactor.py), and so do the
    # ssm, hybrid, encdec and vlm families: one Adafactor step of each,
    # reduced, its state grouped over their stacked roots (layers; super and
    # tail; enc and dec)
    make_train_step(replace(cfg, optimizer="adafactor"))
    for arch in ("mamba2-130m", "recurrentgemma-9b", "whisper-medium", "pixtral-12b"):
        small = replace(tconfigs.reduced(tconfigs.get_config(arch)), optimizer="adafactor")
        if small.family == "hybrid":
            small = replace(small, num_layers=5)                # a super-block and a tail
        model = init_params(small, seed=0, device="cpu")
        opt = init_opt_state(model, "adafactor")
        roots = {k.split(".")[0] for k in opt.nu if ".*." in k}
        assert roots == {"mamba2-130m": {"layers"}, "recurrentgemma-9b": {"super", "tail"},
                         "whisper-medium": {"enc", "dec"}, "pixtral-12b": {"layers"}}[arch]
        batch = {"tokens": torch.zeros((2, 32), dtype=torch.int64)}
        if small.family == "encdec":
            batch["frames"] = torch.zeros((2, small.encoder_seq, small.d_model))
        if small.family == "vlm":
            batch["patches"] = torch.zeros((2, small.num_patches, small.d_model))
        _m, _o, metrics = make_train_step(small, num_micro=2)(model, opt, batch, 0)
        assert all(torch.isfinite(v) for v in metrics.values()), (arch, metrics)

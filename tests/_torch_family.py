"""The whole-model checks the four family test files share: the port's LM
against the JAX package's on the same weights and inputs, on the CPU.

`reference(case)` runs the JAX package once per case (`functools.lru_cache`):
its parameters (numpy), the forward's hidden states and logits over
`n_fwd` tokens, a prefill of `n_pre` tokens into a cache of `cache_len`
(its last logits and the returned cache), then `n_dec` greedy-free decode
steps on the next tokens (their logits).  `check_model(case)` runs the
port on those parameters (`convert.lm_params_from_reference`) and holds each
result against the reference: fp32 within 2e-4 (rtol and atol, the JAX
package's own prefill/decode tolerance: the same fp32 function, the sums in
another order), bf16 with max |difference| within 2e-2 of the reference's
max |value| (both round every matmul to bf16 at the same places and sum in
another order; see `tests/test_torch_lm.py`).  The cache after the prefill
is compared entry by entry (the ring's `pos` exactly).  Inputs come from
numpy with fixed seeds: tokens, and for encdec frames (B, encoder_seq, D),
for vlm patches (B, num_patches, D), each 0.1 times a standard normal, as
the JAX package's `tests/models/test_smoke.py` draws them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.models import decode_step as j_decode, forward as j_forward
from repro.models import init_cache as j_init_cache, init_params as j_init_params
from repro.models.lm import unembed as j_unembed
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.launch.train import make_train_step
from repro_torch.models import decode_step, forward, init_cache, init_params, loss_fn
from repro_torch.models.lm import unembed
from repro_torch.optim import init_opt_state

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
B = 2


@dataclass(frozen=True)
class Case:
    """One model run: the reduced config of `arch` in `dtype` (with
    `num_layers` where given), a forward over n_fwd tokens, a prefill of
    n_pre tokens into a cache of cache_len, n_dec decode steps after it."""
    arch: str
    dtype: str
    n_fwd: int
    n_pre: int
    n_dec: int
    cache_len: int
    num_layers: int | None = None

    def cfg(self, pkg):
        cfg = replace(pkg.reduced(pkg.get_config(self.arch)), dtype=self.dtype)
        return cfg if self.num_layers is None else replace(cfg, num_layers=self.num_layers)


def _np(x):
    return np.asarray(x, np.float32)


def inputs(cfg, n: int) -> dict:
    """The batch of n tokens (numpy), with the family's frames or patches."""
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * rng.standard_normal((B, cfg.encoder_seq, cfg.d_model),
                                                    dtype=np.float32)
    if cfg.family == "vlm":
        batch["patches"] = 0.1 * rng.standard_normal((B, cfg.num_patches, cfg.d_model),
                                                     dtype=np.float32)
    return batch


def _prefix(cfg) -> int:
    return cfg.num_patches if cfg.family == "vlm" else 0


@functools.lru_cache(maxsize=None)
def reference(case: Case) -> dict:
    cfg = case.cfg(jconfigs)
    n = max(case.n_fwd, case.n_pre + case.n_dec)
    batch = {k: jnp.asarray(v) for k, v in inputs(cfg, n).items()}
    P = _prefix(cfg)
    params = j_init_params(cfg, jax.random.PRNGKey(7))
    fwd = dict(batch, tokens=batch["tokens"][:, :case.n_fwd])
    hidden, _, _ = jax.jit(lambda p, b: j_forward(cfg, p, b))(params, fwd)
    pre = dict(batch, tokens=batch["tokens"][:, :case.n_pre])
    h, _, cache = jax.jit(lambda p, b, c: j_forward(cfg, p, b, cache=c, cache_pos=0))(
        params, pre, j_init_cache(cfg, B, case.cache_len))
    out = {"hidden": _np(hidden),
           "logits": _np(j_unembed(cfg, params, hidden).astype(jnp.float32)),
           "prefill": _np(j_unembed(cfg, params, h[:, -1]).astype(jnp.float32)),
           "cache": jax.tree.map(np.asarray, cache), "decode": []}
    step = jax.jit(lambda p, c, t, k: j_decode(cfg, p, c, t, k))
    for k in range(case.n_pre, case.n_pre + case.n_dec):
        lg, cache = step(params, cache, batch["tokens"][:, k:k + 1], jnp.int32(k + P))
        out["decode"].append(_np(lg))
    out["params"] = jax.tree.map(np.asarray, params)
    return out


def close(got: torch.Tensor, want, dtype: str):
    """fp32: elementwise within 2e-4; bf16: max |difference| within 2e-2 of
    the reference's max |value|."""
    want = _np(want)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    else:
        err = float(np.abs(got - want).max())
        assert err <= TOL[dtype] * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _close_tree(got, want, dtype: str, path: str = "cache"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _close_tree(got[k], want[k], dtype, f"{path}/{k}")
        return
    assert tuple(got.shape) == tuple(want.shape), (path, tuple(got.shape), want.shape)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (path, got.dtype, want.dtype)
    if path.endswith("/pos"):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
    else:
        close(got, want, dtype)


def port_params(case: Case):
    cfg = case.cfg(tconfigs)
    return cfg, convert.lm_params_from_reference(cfg, reference(case)["params"], device="cpu")


def _torch_batch(batch: dict, n: int) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"][:, :n].long()
    return out


def check_model(case: Case):
    """The port's forward, prefill (logits and cache) and decode steps
    against the reference's."""
    ref = reference(case)
    cfg, params = port_params(case)
    n = max(case.n_fwd, case.n_pre + case.n_dec)
    batch = inputs(cfg, n)
    hidden, aux, none = forward(cfg, params, _torch_batch(batch, case.n_fwd))
    assert none is None and float(aux) == 0.0
    close(hidden, ref["hidden"], case.dtype)
    close(unembed(cfg, params, hidden), ref["logits"], case.dtype)
    cache = init_cache(cfg, B, case.cache_len, device="cpu")
    h, _, same = forward(cfg, params, _torch_batch(batch, case.n_pre), cache=cache)
    assert same is cache
    close(unembed(cfg, params, h[:, -1]), ref["prefill"], case.dtype)
    _close_tree(cache, ref["cache"], case.dtype)
    tok = torch.from_numpy(batch["tokens"]).long()
    P = _prefix(cfg)
    for i, k in enumerate(range(case.n_pre, case.n_pre + case.n_dec)):
        logits, cache = decode_step(cfg, params, cache, tok[:, k:k + 1], k + P)
        assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab_size)
        close(logits, ref["decode"][i], case.dtype)
    return cfg, params, cache


def check_round_trip(arch: str, num_layers: int | None = None):
    """The JAX package's bf16 parameters into the port and back give the
    same tree, structure, dtypes and every leaf bit for bit; the port's own
    parameters have the JAX tree's structure, shapes and dtypes."""
    case = Case(arch, "bfloat16", 0, 0, 0, 0, num_layers)
    cfg = case.cfg(jconfigs)
    jtree = j_init_params(cfg, jax.random.PRNGKey(1))
    back = convert.lm_params_to_reference(
        convert.lm_params_from_reference(case.cfg(tconfigs), jtree, device="cpu"))
    jflat, jdef = jax.tree_util.tree_flatten(jtree)
    flat, tdef = jax.tree_util.tree_flatten(back)
    assert tdef == jdef
    for got, want in zip(flat, jflat, strict=True):
        want = np.asarray(want)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    own = convert.lm_params_to_reference(init_params(case.cfg(tconfigs), seed=0, device="cpu"))
    flat, tdef = jax.tree_util.tree_flatten(own)
    assert tdef == jdef
    for got, want in zip(flat, jflat, strict=True):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)


def check_training_runs(arch: str):
    """The reduced config in its own bf16 on the CPU: `loss_fn` gives a
    finite loss and ce, and one step of `make_train_step` (2 micro-batches,
    the frames or patches cut with the tokens) finite metrics and finite,
    changed parameters (the parity with the JAX package is held in
    `tests/test_torch_train_<family>.py`)."""
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    params = init_params(cfg, seed=0, device="cpu")
    batch = _torch_batch(inputs(cfg, 32), 32)
    loss, m = loss_fn(cfg, params, batch)
    assert torch.isfinite(loss) and torch.isfinite(m["ce"]) and float(m["aux"]) == 0.0
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    params, _opt, m = make_train_step(cfg, num_micro=2, lr=1e-3, warmup=1)(
        params, init_opt_state(params), batch, 1)     # step 0 of the warm-up has lr 0
    assert all(torch.isfinite(v) for v in m.values()), m
    assert all(torch.isfinite(p).all() for p in params.parameters())
    assert any(not torch.equal(p, before[n]) for n, p in params.named_parameters())

"""The `serve_lm` twin (`repro_torch.examples.serve_lm`) against the JAX
example's serving loop, on the CPU.

Reduced qwen3 in fp32 on the JAX package's weights (`init_params(cfg,
PRNGKey(0))`, carried across with `convert.lm_params_from_reference`).  The
JAX example's continuous-batching loop is transcribed here from
`repro.models.forward` and `decode_step` (its first decode step feeds the
prompt's last token again, as the example does), and both it and the twin's
`serve` answer the example's queue of 10 requests on 4 slots, so that freed
slots are refilled mid-run.  The generated tokens must be equal, and every
step's logits within 2e-4, the JAX package's own prefill/decode tolerance
(`tests/test_torch_serve.py`); where a step's top-2 logit gap on the JAX
side is under 1e-4 a differing token passes if the logits agree within
1e-4 (`_torch_serve_check`).  The JAX run is computed once.
"""
import contextlib
import functools
import io
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from _torch_example_lines import EXAMPLE_LINES
from _torch_serve_check import assert_served_alike, per_request, recorded_logits
from repro.models import decode_step as j_decode_step, forward as j_forward
from repro.models import init_cache as j_init_cache, init_params as j_init_params
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.examples import serve_lm, untimed

ARCH, B, CACHE, MAX_NEW, REQUESTS = "qwen3-1.7b", 4, 160, 16, 10
TOL = 2e-4


def _cfgs():
    return (replace(jconfigs.reduced(jconfigs.get_config(ARCH)), dtype="float32"),
            replace(tconfigs.reduced(tconfigs.get_config(ARCH)), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX example's loop on `requests(...)`: (numpy params, per request
    the generated tokens and each decode step's logits)."""
    cfg, _ = _cfgs()
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    queue = serve_lm.requests(cfg.vocab_size, REQUESTS)
    prefill = jax.jit(
        lambda p, toks, c: j_forward(cfg, p, {"tokens": toks}, cache=c, cache_pos=0))
    step = jax.jit(lambda p, c, t, k: j_decode_step(cfg, p, c, t, k))
    tokens = [[] for _ in queue]
    logits_of = [[] for _ in queue]
    slots = [None] * B           # (tokens_done, remaining, pos, request)
    done, admitted = 0, 0
    per_slot_cache = [j_init_cache(cfg, 1, CACHE) for _ in range(B)]
    while done < REQUESTS:
        for s in range(B):
            if slots[s] is None and queue:
                prompt = queue.pop(0)
                toks = jnp.asarray(prompt, jnp.int32)[None]
                _, _, per_slot_cache[s] = prefill(params, toks, j_init_cache(cfg, 1, CACHE))
                slots[s] = [prompt[-1], MAX_NEW, len(prompt), admitted]
                admitted += 1
        for s in range(B):
            if slots[s] is None:
                continue
            last, remaining, pos, req = slots[s]
            logits, per_slot_cache[s] = step(
                params, per_slot_cache[s], jnp.asarray([[last]], jnp.int32), jnp.int32(pos))
            nxt = int(jnp.argmax(logits[0]))
            tokens[req].append(nxt)
            logits_of[req].append(np.asarray(logits[0]))
            slots[s] = [nxt, remaining - 1, pos + 1, req]
            if slots[s][1] == 0:
                slots[s] = None
                done += 1
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return host, tokens, logits_of


@pytest.fixture(autouse=True)
def one_thread():
    """The reduced model's tensors are small: one thread runs them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    """The twin's `serve` on the carried-across weights, with each decode
    step's logits recorded."""
    jparams, _, _ = _reference()
    _, cfg = _cfgs()
    params = convert.lm_params_from_reference(cfg, jparams, device="cpu")
    calls = []
    with recorded_logits(serve_lm, calls):
        tokens = serve_lm.serve(cfg, params, serve_lm.requests(cfg.vocab_size, REQUESTS), B,
                                CACHE, MAX_NEW)
    return tokens, calls


def test_serve_generates_the_jax_loops_tokens(served):
    _, want_tokens, want_logits = _reference()
    tokens, calls = served
    assert [len(t) for t in tokens] == [MAX_NEW] * REQUESTS
    logits = per_request(calls, REQUESTS, B, MAX_NEW)
    assert_served_alike(tokens, logits, want_tokens, want_logits, TOL)


def test_serve_lm_twin_prints_the_examples_lines():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = serve_lm.main(device="cpu")
    assert untimed(buf.getvalue()) == EXAMPLE_LINES["serve_lm"]
    assert r["steps"] == 160 and all(len(t) == MAX_NEW for t in r["tokens"])

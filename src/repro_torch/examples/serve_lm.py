"""Batched serving demo: prefill + continuous batched decode with SFC page
layout.

Serves a reduced model: a queue of requests with different prompt lengths
is admitted into a fixed batch; each step decodes one token for every
active slot; finished requests leave and the next request is prefilled into
the freed slot (continuous batching).  The paged-KV block table uses the
SFC order from `repro_torch.core.placement.page_order`.  On the card each
prefill runs the attention kernel once a layer.

    python -m repro_torch.examples.serve_lm                # on the card
    python -m repro_torch.examples.serve_lm --device cpu
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.placement import page_order
from repro_torch.core.types import resolve_device
from repro_torch.examples import cli, sync, where
from repro_torch.models import decode_step, forward, init_cache, init_params


def requests(vocab_size: int, count: int = 10, seed: int = 0) -> list:
    """The example's queue: `count` prompts of 8-31 tokens from `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab_size, size=rng.integers(8, 32)).tolist()
            for _ in range(count)]


def serve(cfg, params, queue: list, B: int, cache_len: int, max_new: int) -> list:
    """Continuous batching of `queue` over `B` slots, each slot with its own
    cache of `cache_len` positions: a freed slot prefills the next prompt,
    then every active slot decodes one greedy token a step, `max_new` a
    request.  As in the JAX example, a slot's first decode step feeds the
    prompt's last token again, at position len(prompt).  Returns the tokens
    generated for each request, in queue order."""
    dev = params.tok_embed.device
    queue = list(queue)
    out = [[] for _ in queue]
    # continuous batching over ONE shared cache: for simplicity each slot
    # round-trips through its own prefill into a per-slot cache copy.
    slots = [None] * B           # (tokens_done, remaining, pos, request)
    done, admitted = 0, 0
    per_slot_cache = [init_cache(cfg, 1, cache_len, device=dev) for _ in range(B)]
    while done < len(out):
        for s in range(B):
            if slots[s] is None and queue:
                prompt = queue.pop(0)
                toks = torch.tensor(prompt, dtype=torch.int32, device=dev)[None]
                _, _, per_slot_cache[s] = forward(cfg, params, {"tokens": toks},
                                                  cache=init_cache(cfg, 1, cache_len, device=dev),
                                                  cache_pos=0)
                slots[s] = [prompt[-1], max_new, len(prompt), admitted]
                admitted += 1
        for s in range(B):
            if slots[s] is None:
                continue
            last, remaining, pos, req = slots[s]
            logits, per_slot_cache[s] = decode_step(
                cfg, params, per_slot_cache[s],
                torch.tensor([[last]], dtype=torch.int32, device=dev), pos)
            nxt = int(torch.argmax(logits[0]))
            out[req].append(nxt)
            slots[s] = [nxt, remaining - 1, pos + 1, req]
            if slots[s][1] == 0:
                slots[s] = None
                done += 1
    return out


def run(arch: str = "qwen3-1.7b", B: int = 4, cache_len: int = 160, count: int = 10,
        max_new: int = 16, seed: int = 0, device=None) -> dict:
    """The reduced `arch` in float32 from `seed`, serving the example's queue;
    returns what `main` prints and the generated tokens.  The weights are
    drawn on the CPU and moved to `device`, so that the card and the CPU
    serve the same weights."""
    dev = resolve_device(device)
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = init_params(cfg, seed=seed, device="cpu").to(dev)
    queue = requests(cfg.vocab_size, count, seed)
    sync(dev)
    t0 = time.perf_counter()
    tokens = serve(cfg, params, queue, B, cache_len, max_new)
    sync(dev)
    dt = time.perf_counter() - t0
    return {"name": cfg.name, "B": B, "cache_len": cache_len, "device": dev,
            "page_order": page_order(10, B, device=dev).cpu().numpy(),
            "requests": count, "steps": sum(map(len, tokens)), "wall_s": dt,
            "tokens": tokens}


def main(device=None) -> dict:
    r = run(device=device)
    print(f"serving {r['name']}-reduced, batch={r['B']}, cache={r['cache_len']}")
    print(f"SFC page order ({r['B']} requests x 10 pages of 16 tokens):")
    print(r["page_order"])
    print(f"served {r['requests']} requests, {r['steps']} decode steps in {r['wall_s']:.1f}s "
          f"({r['steps'] / r['wall_s']:.1f} tok/s on {where(r['device'])})")
    return r


if __name__ == "__main__":
    cli(main)

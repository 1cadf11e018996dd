"""Holding one run of the `serve_lm` twin's loop against another, request by
request: the tokens, and each decode step's logits.  No JAX import here:
the card's tests read it.

The loop's slot schedule depends on counts only (every request decodes
`max_new` tokens), so the decode calls of a run map to (request, step) by
replaying that schedule, the same on every side.  Where the reference's
top-2 logit gap at a step is under TIE_GAP, the argmax may fall either way:
there a differing token passes if the logits agree within TIE_TOL, and that
request is compared no further (its inputs differ from then on)."""

import contextlib

import numpy as np

TIE_GAP = 1e-4
TIE_TOL = 1e-4


def decode_schedule(n: int, B: int, max_new: int) -> list:
    """The request each decode call serves, in call order: a freed slot takes
    the next request, then every active slot decodes one token, in slot
    order."""
    slots, queue, order, done = [None] * B, list(range(n)), [], 0
    while done < n:
        for s in range(B):
            if slots[s] is None and queue:
                slots[s] = [queue.pop(0), max_new]
        for s in range(B):
            if slots[s] is None:
                continue
            order.append(slots[s][0])
            slots[s][1] -= 1
            if slots[s][1] == 0:
                slots[s] = None
                done += 1
    return order


@contextlib.contextmanager
def recorded_logits(serve_lm, calls: list):
    """Within the block, each of the twin's decode steps appends its logits
    (a host copy, made after the block) to `calls`."""
    inner = serve_lm.decode_step
    held = []

    def recording(*args, **kw):
        logits, cache = inner(*args, **kw)
        held.append(logits[0].detach().clone())
        return logits, cache

    serve_lm.decode_step = recording
    try:
        yield
    finally:
        serve_lm.decode_step = inner
        calls.extend(t.float().cpu().numpy() for t in held)


def per_request(calls: list, n: int, B: int, max_new: int) -> list:
    """The recorded decode calls as each request's logits, step by step."""
    out = [[] for _ in range(n)]
    for req, logits in zip(decode_schedule(n, B, max_new), calls, strict=True):
        out[req].append(logits)
    return out


def assert_served_alike(tokens, logits, want_tokens, want_logits, tol: float) -> float:
    """Per request, the tokens equal step by step and the logits within `tol`
    (absolute and relative) until a near tie (module docstring).  Returns
    the largest |logit difference| over the steps compared."""
    assert [len(t) for t in tokens] == [len(t) for t in want_tokens]
    worst = 0.0
    for r, (got_t, want_t) in enumerate(zip(tokens, want_tokens)):
        for i, (g, w) in enumerate(zip(logits[r], want_logits[r])):
            worst = max(worst, float(np.abs(g - w).max()))
            if got_t[i] == want_t[i]:
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"request {r} step {i}")
                continue
            top2 = np.sort(w)[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (r, i, got_t, want_t)
            np.testing.assert_allclose(g, w, rtol=TIE_TOL, atol=TIE_TOL,
                                       err_msg=f"request {r} step {i}, a near tie")
            break
    return worst

"""The constant-time successor of the port's CUDA kernel, on the CPU.

`successor_kernel` in `src/repro_torch/kernels/csrc/sfc.cu` finds the
successor of a simplex inside the root simplex from the trailing levels at
which every anchor coordinate has its bit set (the levels the +1 carries
through), with one entry of each packed table; other elements take the
encode and decode walks.  The kernel runs only on a card, so this file
transcribes its simplex body in torch (`_kernel_rule`; its walk branch is
the plain version on the masked anchor) and holds it against the JAX
package: the jnp `SimplexOps.successor` and the Pallas `successor_kernel`
in interpret mode (one eager call a dimension, cached: under `jax.jit`, as
`repro.kernels.ops.successor` calls it, the d = 3 body takes XLA minutes to
compile), exactly.  The inputs are the card test's
(`test_torch_cuda._successor_inputs`): elements at levels 0..L inside and
outside the root, element 0 and every level's last element, carries
stopping at every level 1..L, and anchors with bits finer than their
level.

The fine-bits contract: the port drops the bits finer than an element's
level, as jnp `SimplexOps.successor` does (it shifts them out of the key).
The Pallas kernel's encode walk reads them, a fault of the frozen reference
(ROADMAP §3.2); on the masked anchors it agrees.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro.kernels import sfc as jsfc
from repro_torch.core.tables import MAXLEVEL, get_tables
from repro_torch.kernels import build, ref as kref
from test_torch_cuda import SUCCESSOR_KINDS, _successor_inputs

N = 2048        # rows a dimension: the interpret-mode call costs its trace, not its rows


def _masked(d, anchor, level):
    """The anchor without its bits finer than the level."""
    h = torch.bitwise_left_shift(torch.ones_like(level), MAXLEVEL[d] - level)
    return anchor & ~(h - 1)[:, None]


@functools.lru_cache(maxsize=None)
def _run(d):
    """The inputs (torch), and the JAX package's successors as numpy
    (anchor, type) pairs: jnp on the anchors as given and masked, and the
    Pallas kernel on both in one call."""
    anchor, level, stype, kind, carry = _successor_inputs(d, N, seed=100 + d, dev="cpu")
    masked = _masked(d, anchor, level)

    def js(a):
        return JSimplex(jnp.asarray(a.numpy()), jnp.asarray(level.numpy()),
                        jnp.asarray(stype.numpy()))

    def pair(s):
        return np.asarray(s.anchor), np.asarray(s.stype)

    jops = jget_ops(d)
    both = torch.cat([masked, anchor]).numpy()
    cols = [both[:, k] for k in range(d)] + [np.tile(x.numpy(), 2) for x in (level, stype)]
    out = [np.asarray(o) for o in jsfc.successor_kernel(d, *map(jnp.asarray, cols),
                                                         block=2 * N, interpret=True)]
    pa, pb = np.stack(out[:d], 1), out[d]
    return ((anchor, level, stype, kind, carry),
            {"jnp": pair(jops.successor(js(anchor))),
             "jnp_masked": pair(jops.successor(js(masked))),
             "pallas_masked": (pa[:N], pb[:N]), "pallas": (pa[N:], pb[N:])})


def _kernel_rule(d, anchor, level, stype):
    """The simplex body of `successor_kernel`, step by step: mask the bits
    finer than the level; at level 0, the root; else gate on a level in
    1..L, a type below d! and Proposition 23 against the root; in the gate,
    the run of trailing levels whose bits all coordinates share, the carry
    level i = level - run, one enc and one dec entry, the bits below level i
    cleared (element 0 when the run covers every level); outside it the
    walk, whose answer is the plain version's on the masked anchor.  Returns
    (anchor, type, branch): branch 0 the walk, 1 the constant-time rule, 2
    level 0."""
    L, nc = MAXLEVEL[d], 1 << d
    enc, dec = (torch.tensor(t, dtype=torch.int64) for t in build.packed_tables(d))
    lvl, b = level.long(), stype.long()
    c = _masked(d, anchor, level)
    gate = ((lvl >= 1) & (lvl <= L) & (b >= 0) & (b < get_tables(d).num_types)
            & kref.inside_root(c, level, stype))
    lvl = torch.where(gate, lvl, L)                 # harmless values off the gate
    b = torch.where(gate, b, 0)
    c = torch.where(gate[:, None], c.long(), 0)
    shared = c[:, 0]
    for k in range(1, d):
        shared = shared & c[:, k]
    x = shared >> (L - lvl)
    run = torch.log2((~x & (x + 1)).double()).long()   # trailing ones: the lowest 0 bit
    s = L - lvl + run                                  # the carry level's bit, L - i
    last = run == lvl
    s = torch.where(last, 0, s)
    cid = sum(((c[:, k] >> s) & 1) << k for k in range(d))
    up = enc[b * nc + cid]
    nxt = dec[(up >> 3) * nc + torch.where(last, 0, (up & 7) + 1)]
    bits = torch.stack([(nxt >> k) & 1 for k in range(d)], 1)
    new = (c & ~((2 << s) - 1)[:, None]) | (bits << s[:, None])
    new = torch.where(last[:, None], 0, new)
    new_b = torch.where(last, 0, nxt >> 3)
    walk_anchor, walk_b = kref.successor(_masked(d, anchor, level), level, stype)
    root = level == 0
    new_anchor = torch.where(gate[:, None], new, walk_anchor.long())
    new_b = torch.where(gate, new_b, walk_b.long())
    return (torch.where(root[:, None], 0, new_anchor).int(), torch.where(root, 0, new_b).int(),
            torch.where(root, 2, gate.long()))


def _equal(got, want):
    """Rows where two (anchor, type) pairs, torch or numpy, agree."""
    (ga, gb), (wa, wb) = ([np.asarray(x) for x in pair] for pair in (got, want))
    return (ga == wa).all(1) & (gb == wb)


@pytest.mark.parametrize("d", [2, 3])
def test_kernel_rule_matches_jnp_and_pallas_kernel(d):
    """On every row the transcribed kernel equals jnp `SimplexOps.successor`
    (on the anchor as given and masked) and the Pallas kernel on the masked
    anchor; the constant-time branch takes every carry row, with carries
    stopping at every level 1..L, and the walk takes level 0 and the
    elements outside the root; every level-0 element's successor is the
    root."""
    (anchor, level, stype, kind, carry), jax_out = _run(d)
    got_a, got_b, branch = _kernel_rule(d, anchor, level, stype)
    for name in ("jnp", "jnp_masked", "pallas_masked"):
        assert _equal((got_a, got_b), jax_out[name]).all(), name
    branch, top = branch.numpy(), level.numpy() > 0
    carry_rows = (kind == 3) | (kind == 7)
    assert (branch[carry_rows] == 1).all()
    assert set(carry[carry_rows]) == set(range(1, MAXLEVEL[d] + 1))
    assert (branch[(kind <= 2) & top] == 1).all() and (branch[~top] == 2).all()
    assert (branch[kind == 4] == 0).any() and (branch[kind == 4] == 1).any()
    assert set(kind[~top]) >= {0, 4, 5, 6} and set(kind) == set(range(SUCCESSOR_KINDS))


@pytest.mark.parametrize("d", [2, 3])
def test_plain_version_drops_fine_bits_as_jnp_does(d):
    """The plain version (what the wrappers run on the CPU, and the card is
    held against) equals jnp `SimplexOps.successor` on every row, the
    anchors with bits finer than their level included; so do the wrappers
    of `kernels.ops` on CPU tensors."""
    from repro_torch.kernels import ops as kops

    (anchor, level, stype, kind, _carry), jax_out = _run(d)
    fine = (kind == 5) | (kind == 6)
    assert (_masked(d, anchor, level) != anchor).any(1).numpy()[fine].mean() > 0.9
    assert _equal(kref.successor(anchor, level, stype), jax_out["jnp"]).all()
    assert _equal(kops.successor(anchor, level, stype), jax_out["jnp"]).all()


@pytest.mark.parametrize("d", [2, 3])
def test_pallas_kernel_reads_fine_bits(d):
    """The reference's fault that the port does not copy (ROADMAP §3.2):
    the Pallas kernel equals jnp on every valid element, inside and outside
    the root, but not on every anchor with bits finer than its level.  The
    share it gets right is printed."""
    (_anchor, _level, _stype, kind, _carry), jax_out = _run(d)
    agree = _equal(jax_out["pallas"], jax_out["jnp"])
    fine = (kind == 5) | (kind == 6)
    assert agree[~fine].all()
    share = agree[fine].mean()
    print(f"d={d}: the Pallas kernel equals jnp on {share:.1%} of {fine.sum()} fine-bit anchors")
    assert share < 1


@pytest.mark.parametrize("d", [2, 3])
def test_tables_give_the_carry_identity(d):
    """The identity the constant-time rule stands on, for every type b: the
    last child (local index 2^d - 1) has cube id 2^d - 1 and its parent's
    type, child 0 has cube id 0 and its parent's type, and cube id 2^d - 1
    under type b has local index 2^d - 1 and parent type b."""
    t = get_tables(d)
    top = (1 << d) - 1
    for b in range(t.num_types):
        assert t.cube_id_of_local[b, top] == top and t.type_of_local[b, top] == b
        assert t.cube_id_of_local[b, 0] == 0 and t.type_of_local[b, 0] == b
        assert t.parent_type[top, b] == b and t.local_index[top, b] == top


def test_kernel_hot_branch_reads_one_entry_of_each_table():
    """In `csrc/sfc.cu`, the constant-time branch (`successor_in_root`)
    reads one enc and one dec entry and loops over no levels: its only
    loops run over the d coordinates."""
    src = (build.CSRC_DIR / "sfc.cu").read_text()
    body = re.search(r"int successor_in_root\(.*?\n}\n", src, re.S).group(0)
    assert body.count("enc[") == 1 and body.count("dec[") == 1
    loops = re.findall(r"for \((.*?)\)", body)
    assert loops and all(re.fullmatch(r"int k = 0; k < D; \+\+k", x) for x in loops), loops
    kernel = re.search(r"successor_kernel\(const.*?\n}\n", src, re.S).group(0)
    assert kernel.index("successor_in_root") < kernel.index("decode_walk")

"""The multi-level walks of the port's `morton_key` and `decode` kernels, on the CPU.

The simplex bodies of `morton_key_kernel` and `decode_kernel` in
`src/repro_torch/kernels/csrc/sfc.cu` walk m levels a table lookup
(`walk_key`, `walk_decode`) in the m-level tables that
`repro_torch.kernels.build.walk_tables` composes from the one-level ones.
The kernels run only on a card, so this file transcribes the two walks in
torch (`_walk_key`, `_walk_decode`): the anchor's bits of m levels taken
axis-major as the table index, one lookup for m levels, and for decode the
key's digits finer than the level zeroed once and the cube ids spread back
into the coordinates.  It holds them exactly against the JAX package's jnp
`SimplexOps` key and decode and against its Pallas `morton_key_kernel` and
`decode_kernel` in interpret mode (one eager call a dimension, cached),
and against the port's plain versions, on every level 0..L and every type,
keys with every key bit set somewhere and garbage digits finer than their
level, and anchors with bits above L, negative ones among them.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import u64 as u64m
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro.kernels import sfc as jsfc
from repro_torch.core.tables import MAXLEVEL, get_tables
from repro_torch.kernels import build, ref as kref

N = 2048        # rows a dimension: the interpret-mode call costs its trace, not its rows
CONSTANT_BANK = 64 << 10     # bytes of __constant__ memory a module may hold
STATIC_SHARED = 48 << 10     # bytes of static shared memory a block may declare


def _walk_key(d, anchor, stype, m=None):
    """`walk_key`: fine -> coarse, L / m lookups; the index is the type's
    block of 2^(d m) entries and the m levels' anchor bits, axis k at bits
    m k .. m k + m - 1; an entry gives m key digits and the type at the
    coarse end.  A type out of range is clamped to the last type."""
    m = build.WALK_LEVELS[d] if m is None else m
    wenc = torch.tensor(build.walk_tables(d, m)[0], dtype=torch.int64)
    bits, digits = (1 << m) - 1, (1 << (d * m)) - 1
    c = anchor.long() & 0xFFFFFFFF              # the kernel shifts the coordinates unsigned
    t = stype.long().clamp(0, get_tables(d).num_types - 1)
    key = torch.zeros_like(t)
    for s in range(0, MAXLEVEL[d], m):
        q = sum(((c[:, k] >> s) & bits) << (m * k) for k in range(d))
        e = wenc[(t << (d * m)) + q]
        key |= (e & digits) << (d * s)
        t = e >> (d * m)
    return key


def _walk_decode(d, key, level, m=None):
    """`walk_decode`: the digits finer than the level zeroed (the shift
    clamped to [0, 63]), then coarse -> fine, L / m lookups with no level
    test; an entry gives the m levels' cube ids axis-major and the type at
    the fine end.  Returns (anchor, type)."""
    m = build.WALK_LEVELS[d] if m is None else m
    wdec = torch.tensor(build.walk_tables(d, m)[1], dtype=torch.int64)
    L, bits, digits = MAXLEVEL[d], (1 << m) - 1, (1 << (d * m)) - 1
    sb = (d * (L - level.long())).clamp(0, 63)
    k = key & ~(torch.bitwise_left_shift(torch.ones_like(key), sb) - 1)
    t = torch.zeros_like(key)
    x = torch.zeros((key.shape[0], d), dtype=torch.int64)
    for s in range(L - m, -1, -m):
        e = wdec[(t << (d * m)) + ((k >> (d * s)) & digits)]
        for a in range(d):
            x[:, a] |= ((e >> (m * a)) & bits) << s
        t = e >> (d * m)
    return x.int(), t.int()


def _inputs(d, n, seed):
    """(anchor, type) rows for encode and (key, level) rows for decode, as
    torch.  Decode: levels 0..L (rows 0 and 1 at 0 and L), keys uniform over
    the d L key bits, so most carry garbage digits finer than their level;
    rows 2 and 3 all d L bits set at levels L and 0.  Encode: the elements
    the plain decode gives for those keys (every type), every third row
    with random bits above L set in its coordinates (the sign bit among
    them), every third (from the second) a random anchor of 32 bits and a
    random type."""
    L, nt = MAXLEVEL[d], get_tables(d).num_types
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    key = rng.integers(0, 1 << (d * L), n, dtype=np.uint64).astype(np.int64)
    level[:4] = (0, L, L, 0)
    key[2:4] = (1 << (d * L)) - 1
    key, level = torch.from_numpy(key), torch.from_numpy(level)
    anchor, stype = kref.decode(d, key, level)
    high = torch.from_numpy(rng.integers(0, 1 << (32 - L), (n, d), dtype=np.int64))
    rand = torch.from_numpy(rng.integers(-2**31, 2**31, (n, d), dtype=np.int64)).int()
    row = torch.arange(n) % 3
    anchor = torch.where((row == 0)[:, None], anchor ^ (high << L).int(), anchor)
    anchor = torch.where((row == 1)[:, None], rand, anchor).contiguous()
    stype = torch.where(row == 1, torch.from_numpy(rng.integers(0, nt, n).astype(np.int32)),
                        stype).contiguous()
    return anchor, stype, key, level


@functools.lru_cache(maxsize=None)
def _run(d):
    """The inputs, and the JAX package's keys and decodes as numpy: jnp
    `SimplexOps` (the key at level L, as the plain version evaluates it) and
    the Pallas kernels in interpret mode."""
    L = MAXLEVEL[d]
    anchor, stype, key, level = _inputs(d, N, seed=40 + d)
    jops = jget_ops(d)
    a, b = jnp.asarray(anchor.numpy()), jnp.asarray(stype.numpy())
    jkey = u64m.to_np(jops.morton_key(JSimplex(a, jnp.full(N, L, jnp.int32), b)))
    hi, lo = jsfc.morton_key_kernel(d, *(a[:, k] for k in range(d)), b, block=N, interpret=True)
    pkey = np.asarray(hi).astype(np.uint64) << np.uint64(32) | np.asarray(lo).astype(np.uint64)
    ku, lv = u64m.from_int(key.numpy().astype(np.uint64)), jnp.asarray(level.numpy())
    s = jops.decode_key(ku, lv)
    out = jsfc.decode_kernel(d, ku.hi, ku.lo, lv, block=N, interpret=True)
    return ((anchor, stype, key, level),
            {"jnp_key": jkey.astype(np.int64), "pallas_key": pkey.astype(np.int64),
             "jnp_decode": (np.asarray(s.anchor), np.asarray(s.stype)),
             "pallas_decode": (np.stack([np.asarray(o) for o in out[:d]], 1),
                               np.asarray(out[d]))})


@pytest.mark.parametrize("d", [2, 3])
def test_inputs_cover_levels_types_bits_and_garbage(d):
    """The inputs hold every level 0..L and every type, every one of the
    d L key bits set somewhere, keys with garbage digits finer than their
    level, and anchors with bits above L and negative ones."""
    (anchor, stype, key, level), _ = _run(d)
    L = MAXLEVEL[d]
    assert set(level.tolist()) == set(range(L + 1))
    assert set(stype.tolist()) == set(range(get_tables(d).num_types))
    assert all(bool(((key >> b) & 1).any()) for b in range(d * L))
    fine = torch.bitwise_left_shift(torch.ones_like(key), (d * (L - level.long()))) - 1
    assert bool((key & fine).any())
    assert bool((anchor < 0).any()) and bool(((anchor.long() >> L) > 0).any())


@pytest.mark.parametrize("d", [2, 3])
def test_walk_key_matches_jnp_pallas_and_plain(d):
    """The transcribed key walk equals jnp `SimplexOps.morton_key` at level
    L, the Pallas kernel and the plain version on every row: only the low L
    bits of each coordinate count."""
    (anchor, stype, _key, _level), want = _run(d)
    got = _walk_key(d, anchor, stype).numpy()
    np.testing.assert_array_equal(got, want["jnp_key"])
    np.testing.assert_array_equal(got, want["pallas_key"])
    np.testing.assert_array_equal(got, kref.morton_key(anchor, stype).numpy())


@pytest.mark.parametrize("d", [2, 3])
def test_walk_decode_matches_jnp_pallas_and_plain(d):
    """The transcribed decode walk equals jnp `SimplexOps.decode_key`, the
    Pallas kernel and the plain version on every row, garbage digits finer
    than the level included, and those keys decode as the masked keys do."""
    (_anchor, _stype, key, level), want = _run(d)
    got = [x.numpy() for x in _walk_decode(d, key, level)]
    for name in ("jnp_decode", "pallas_decode"):
        for g, w in zip(got, want[name], strict=True):
            np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w in zip(got, kref.decode(d, key, level), strict=True):
        np.testing.assert_array_equal(g, w.numpy())
    fine = torch.bitwise_left_shift(torch.ones_like(key), d * (MAXLEVEL[d] - level.long())) - 1
    for g, w in zip(got, _walk_decode(d, key & ~fine, level), strict=True):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("d, m", [(2, 1), (2, 3), (2, 5), (2, 6), (3, 1), (3, 3)])
def test_every_table_height_gives_the_same_walks(d, m):
    """Tables of m = 1 (the one-level tables, 16 bits an entry), 3, 5 and 6
    levels a lookup give the same keys and elements: the m the kernels use
    (`WALK_LEVELS`) is a choice of speed alone."""
    (anchor, stype, key, level), want = _run(d)
    np.testing.assert_array_equal(_walk_key(d, anchor, stype, m).numpy(), want["jnp_key"])
    got = _walk_decode(d, key, level, m)
    for g, w in zip(got, want["jnp_decode"], strict=True):
        np.testing.assert_array_equal(g.numpy(), w)


def test_walk_tables_reject_heights_that_do_not_fit():
    """m must divide L and an entry (d m digit bits and the type) must fit
    16 bits."""
    for d, m in ((2, 4), (2, 10), (3, 7)):
        with pytest.raises(ValueError):
            build.walk_tables(d, m)


@pytest.mark.parametrize("d", [2, 3])
def test_decode_mask_rests_on_child_zero(d):
    """The identity that lets decode mask instead of testing the level: child
    0 (local index 0) of every type b has cube id 0 and type b, so a zero
    digit keeps the type; and the m-level decode table's entry 0 of type b
    is cube ids 0 and type b."""
    t = get_tables(d)
    m = build.WALK_LEVELS[d]
    wdec = build.walk_tables(d)[1]
    for b in range(t.num_types):
        assert t.cube_id_of_local[b, 0] == 0 and t.type_of_local[b, 0] == b
        assert wdec[b << (d * m)] == b << (d * m)


def test_generated_tables_fit_constant_and_shared_memory():
    """Every table `sfc_tables.h` declares fits in 64 KB of __constant__
    memory together, and each m-level table in the static shared memory a
    block may declare; the header gives the kernels the m of
    `WALK_LEVELS` and the tables of `walk_tables`."""
    text = build.table_header()
    decls = re.findall(r"__constant__ (?:__align__\(16\) )?unsigned (char|short) (\w+)\[(\d+)\]",
                       text)
    size = {name: int(n) * (1 if kind == "char" else 2) for kind, name, n in decls}
    assert sum(size.values()) <= CONSTANT_BANK, size
    for d in (2, 3):
        assert f"#define SFC_WALK_M_{d} {build.WALK_LEVELS[d]}" in text
        for name, vals in zip(("walk_enc", "walk_dec"), build.walk_tables(d)):
            assert size[f"sfc_{name}_{d}"] == 2 * len(vals) <= STATIC_SHARED
            assert f"sfc_{name}_{d}[{len(vals)}] = {{{', '.join(map(str, vals))}}};" in text


def test_kernels_walk_m_levels_a_lookup():
    """In `csrc/sfc.cu` the simplex bodies of morton_key and decode call the
    multi-level walks, which loop over the L / m lookups and the
    coordinates only, never level by level."""
    src = (build.CSRC_DIR / "sfc.cu").read_text()
    for kernel, walk in (("simplex_key_kernel", "walk_key"),
                         ("simplex_decode_kernel", "walk_decode")):
        body = re.search(rf"{kernel}\(const.*?\n}}\n", src, re.S).group(0)
        assert f"{walk}<D>(" in body and "stage_walk_table<D>(" in body
        fn = re.search(rf"{walk}\(.*?\n}}\n", src, re.S).group(0)
        loops = re.findall(r"for \((.*?)\)", fn)
        assert loops and all("STEPS" in x or re.search(r"< D; \+\+", x) for x in loops), loops

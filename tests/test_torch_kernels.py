"""The port's four SFC kernels (encode, decode, parent, children), held
against the JAX package, exactly.  (The Pallas parity of encode and
decode lives in `test_torch_pallas_encode.py` and
`test_torch_pallas_decode.py`, which reuse the helpers here.)

On this CPU the wrappers in `repro_torch.kernels.ops` run the plain PyTorch
versions (`kernels.ref`), which must equal the JAX Pallas kernels (run in
interpret mode, as `tests/kernels/test_sfc_kernels.py` runs them) and the
JAX element ops.  Inputs come from a numpy seed and cover level 0 (where
`parent` is still called, by the family scan) and level L (where `children`
has a zero offset).  The CUDA kernels themselves are held against these
plain versions on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import u64 as u64m
from repro.core.ops import get_ops as jget_ops
from repro.core.types import Simplex as JSimplex
from repro.kernels import ops as jkops
from repro.kernels import sfc as jsfc
from repro_torch.core.cmesh import pack_connection
from repro_torch.core.keys import to_pair
from repro_torch.core.tables import MAXLEVEL
from repro_torch.kernels import build, ops as kops, ref as kref

KERNELS = ["morton_key", "decode", "parent", "children"]


def _inputs(d, n, seed):
    """(key uint64 with garbage below each level, level, anchor, stype) as
    numpy; the elements are the keys decoded by the JAX element ops.  The
    first two elements sit at level 0 and level L."""
    L = MAXLEVEL[d]
    rng = np.random.default_rng(seed)
    level = rng.integers(0, L + 1, n).astype(np.int32)
    level[:2] = (0, L)[: n]
    key = rng.integers(0, 1 << (d * L), n, dtype=np.uint64)
    s = jget_ops(d).decode_key(u64m.from_int(key), jnp.asarray(level))
    return key, level, np.array(s.anchor), np.array(s.stype)


def _port(d, name, key, level, anchor, stype):
    """The port's wrapper outputs for one kernel, as numpy (keys as uint64)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         (("level", level), ("anchor", anchor), ("stype", stype))}
    if name == "morton_key":
        return (kops.morton_key(t["anchor"], t["stype"]).numpy().astype(np.uint64),)
    if name == "decode":
        k = torch.from_numpy(key.astype(np.int64))
        return tuple(x.numpy() for x in kops.decode(d, k, t["level"]))
    fn = kops.parent if name == "parent" else kops.children
    return tuple(x.numpy() for x in fn(t["anchor"], t["level"], t["stype"]))


def _jax_kernel(d, name, key, level, anchor, stype):
    """The JAX package's Pallas kernel outputs (interpret mode), as numpy."""
    s = JSimplex(jnp.asarray(anchor), jnp.asarray(level), jnp.asarray(stype))
    if name == "morton_key":
        return (u64m.to_np(jkops.morton_key(d, s)),)
    if name == "decode":
        out = jkops.decode(d, u64m.from_int(key), jnp.asarray(level))
        return np.asarray(out.anchor), np.asarray(out.stype)
    if name == "parent":
        p, iloc = jkops.parent_and_local_index(d, s)
        return np.asarray(p.anchor), np.asarray(p.level), np.asarray(p.stype), np.asarray(iloc)
    kids = jkops.children(d, s)
    return np.asarray(kids.anchor), np.asarray(kids.level), np.asarray(kids.stype)


def _jax_ops(d, name, key, level, anchor, stype):
    """The JAX element ops (`repro.core.ops`) for the same function."""
    o = jget_ops(d)
    s = JSimplex(jnp.asarray(anchor), jnp.asarray(level), jnp.asarray(stype))
    if name == "morton_key":
        return (u64m.to_np(o.morton_key(s)),)
    if name == "decode":
        out = o.decode_key(u64m.from_int(key), jnp.asarray(level))
        return np.asarray(out.anchor), np.asarray(out.stype)
    if name == "parent":
        p = o.parent(s)
        return np.asarray(p.anchor), np.asarray(p.level), np.asarray(p.stype), np.asarray(
            o.local_index(s))
    kids = o.children_tm(s)
    return np.asarray(kids.anchor), np.asarray(kids.level), np.asarray(kids.stype)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def check_against_pallas(name, d, n):
    """The port's wrapper for kernel `name` on the CPU equals the JAX Pallas
    kernel in interpret mode.  Encode and decode, whose interpret-mode
    compiles are the slowest, are run from their own test files."""
    args = _inputs(d, n, seed=n + d)
    _assert_same(_port(d, name, *args), _jax_kernel(d, name, *args))


@pytest.mark.parametrize("name", ["parent", "children"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [7, 250])
def test_plain_kernel_matches_pallas_kernel(name, d, n):
    check_against_pallas(name, d, n)


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("d", [2, 3])
def test_plain_kernel_matches_element_ops_all_levels(name, d):
    args = _inputs(d, 4096, seed=100 + d)
    assert len(np.unique(args[1])) == MAXLEVEL[d] + 1
    _assert_same(_port(d, name, *args), _jax_ops(d, name, *args))


@pytest.mark.parametrize("d", [2, 3])
def test_packed_tables_match_pallas_tables(d):
    enc, dec, _ = jsfc._packed_tables(d)
    assert build.packed_tables(d) == (list(enc), list(dec))
    text = build.table_header()
    assert f"sfc_enc_{d}[{len(enc)}] = {{{', '.join(map(str, enc))}}};" in text
    assert f"sfc_dec_{d}[{len(dec)}] = {{{', '.join(map(str, dec))}}};" in text
    assert f"#define SFC_MAXLEVEL_{d} {MAXLEVEL[d]}" in text


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor goes to the plain version (its counter moves), never to
    a kernel (the launch counters stay put)."""
    key, level, anchor, stype = (torch.from_numpy(np.ascontiguousarray(x).astype(
        np.int64 if i == 0 else np.int32)) for i, x in enumerate(_inputs(3, 16, seed=1)))
    kops.reset_launch_counts()
    kref.reset_call_counts()
    kops.morton_key(anchor, stype)
    kops.decode(3, key, level)
    kops.parent(anchor, level, stype)
    kops.children(anchor, level, stype)
    kops.morton_key(anchor[:0], stype[:0])
    kops.face_sweep(anchor, level, stype)
    kops.inside_root(anchor, level, stype)
    tgt = torch.zeros((4, 16), dtype=torch.int32)
    kops.eval_route(3, tgt, tgt.long(), level, tgt[0, :1], tgt[0, :1].long())
    table = torch.from_numpy(pack_connection(3, np.eye(3), np.zeros(3), np.arange(6)))[None]
    kops.tree_transform(tgt[0], anchor, level, stype, tgt[1], table)
    kops.owner_rank(tgt[0], key, tgt[0, :0], key[:0])          # P = 0: every key to rank 0
    kops.successor(anchor, level, stype)
    kops.face_neighbor(anchor, level, stype, tgt[0])
    assert kref.call_counts == {"morton_key": 2, "decode": 1, "parent": 1, "children": 1,
                                "face_sweep": 1, "eval_route": 1, "inside_root": 1,
                                "tree_transform": 1, "owner_rank": 1, "successor": 1,
                                "face_neighbor": 1}
    assert not any(kops.launch_counts.values())


def test_wrappers_reject_bad_inputs():
    a = torch.zeros((4, 3), dtype=torch.int32)
    b = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kops.morton_key(a.long(), b)
    with pytest.raises(ValueError):
        kops.parent(a, b[:3], b)
    with pytest.raises(ValueError):
        kops.children(torch.zeros((4, 6), dtype=torch.int32)[:, ::2], b, b)
    with pytest.raises(ValueError):
        kops.decode(4, b.long(), b)
    with pytest.raises(ValueError):   # no kernel and no plain version off CPU/CUDA
        kops.morton_key(a.to("meta"), b.to("meta"))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """Where no nvcc is found the build fails loudly, naming nvcc."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert (tmp_path / "sfc_tables.h").read_text() == build.table_header()


def test_key_pairs_match_pallas_words():
    """The int64 key of the encode path equals the Pallas kernel's
    (hi, lo) uint32 words."""
    key, level, anchor, stype = _inputs(3, 250, seed=9)
    k = kops.morton_key(torch.from_numpy(np.array(anchor)), torch.from_numpy(stype))
    want = jkops.morton_key(3, JSimplex(jnp.asarray(anchor), jnp.asarray(level), jnp.asarray(stype)))
    hi, lo = to_pair(k)
    np.testing.assert_array_equal(hi, np.asarray(want.hi))
    np.testing.assert_array_equal(lo, np.asarray(want.lo))


@pytest.mark.parametrize("d", [2, 3])
def test_batched_ops_match_reference_batched_ops(d):
    """The port's `BatchedOps` (what the forest calls) against the JAX
    package's, op for op: host uint64 keys, decode, parent with local
    index, children."""
    from repro.core.batch import get_batch_ops as jget_bops
    from repro_torch.core.batch import get_batch_ops
    from repro_torch.core.types import Simplex

    key, level, anchor, stype = _inputs(d, 250, seed=20 + d)
    jb = jget_bops(d, "reference")
    tb = get_batch_ops(d)
    js = JSimplex(jnp.asarray(anchor), jnp.asarray(level), jnp.asarray(stype))
    ts = Simplex(*(torch.from_numpy(np.array(x)) for x in (anchor, level, stype)))
    np.testing.assert_array_equal(tb.morton_key_np(ts), jb.morton_key_np(js))
    got = tb.decode(torch.from_numpy(key.astype(np.int64)), ts.level)
    want = jb.decode(u64m.from_int(key), jnp.asarray(level))
    _assert_same([x.numpy() for x in got], [np.asarray(x) for x in want])
    (p, il), (jp, jil) = tb.parent_and_local_index(ts), jb.parent_and_local_index(js)
    _assert_same([x.numpy() for x in (*p, il)], [np.asarray(x) for x in (*jp, jil)])
    _assert_same([x.numpy() for x in tb.parent(ts)], [np.asarray(x) for x in jb.parent(js)])
    _assert_same([x.numpy() for x in tb.children(ts)], [np.asarray(x) for x in jb.children(js)])


def _many_markers(P, trees, d, rng):
    """P lex-sorted partition markers over `trees` trees, with empty ranks
    (repeated markers) and a trailing (trees, 0) sentinel, as the marker
    table gives them: (tree int32, key uint64)."""
    L = MAXLEVEL[d]
    mt = np.sort(rng.integers(0, trees, P)).astype(np.int32)
    mk = rng.integers(0, 1 << (d * L), P, dtype=np.uint64)
    order = np.lexsort((mk, mt))
    mt, mk = mt[order], mk[order]
    mt[0], mk[0] = 0, 0
    mk[5:9] = mk[4]
    mt[5:9] = mt[4]
    mt[-3:], mk[-3:] = trees, 0
    return mt, mk


@pytest.mark.parametrize("d", [2, 3])
def test_eval_route_beyond_4096_markers_matches_reference(d):
    """At P = 4097 partition markers (more than the kernel keeps in shared
    memory) the port's routing eval runs on the CPU and equals the JAX
    package: the wrapper against `eval_route_ref`, and `BatchedOps.eval_route`
    (what Balance and Ghost call) against the JAX package's under
    `use_backend("jnp")`."""
    from repro.core import batch as jbatch
    from repro.kernels import ref as jkref
    from repro_torch.core import batch as tbatch
    from test_torch_sweep import _pad_markers

    L = MAXLEVEL[d]
    rng = np.random.default_rng(40 + d)
    n, nf, P = 300, d + 1, 4097
    level = rng.integers(0, L + 1, n).astype(np.int32)
    shift = (np.uint64(d) * (np.uint64(L) - level.astype(np.uint64)))[None, :]
    key = (rng.integers(0, 1 << (d * L), (nf, n), dtype=np.uint64) >> shift) << shift
    tgt = rng.integers(0, 4, (nf, n)).astype(np.int32)
    mt, mk = _many_markers(P, 4, d, rng)
    t_args = (torch.from_numpy(tgt), torch.from_numpy(key.astype(np.int64)),
              torch.from_numpy(level))
    kend, first, last = kops.eval_route(d, *t_args, torch.from_numpy(mt),
                                        torch.from_numpy(mk.astype(np.int64)))
    mt_p, mk_p = _pad_markers(mt, mk)
    hh, hl, jf, jl = jkref.eval_route_ref(
        d, jnp.asarray(tgt), jnp.asarray((key >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(key.astype(np.uint32)), jnp.asarray(np.broadcast_to(level, (nf, n))),
        jnp.asarray(mt_p), jnp.asarray((mk_p >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(mk_p.astype(np.uint32)))
    jend = (np.asarray(hh).astype(np.uint64) << np.uint64(32)) | np.asarray(hl).astype(np.uint64)
    np.testing.assert_array_equal(kend.numpy().astype(np.uint64), jend)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jl))
    assert len(np.unique(first.numpy())) > 100 and (last.numpy() > first.numpy()).any()

    valid = rng.integers(0, 2, (nf, n)).astype(bool)
    dual = rng.integers(0, nf, (nf, n)).astype(np.int32)
    tb, jb = tbatch.get_batch_ops(d), jbatch.get_batch_ops(d, "jnp")
    tsw = tb.sweep_from_layer(t_args[0], t_args[1], torch.from_numpy(valid),
                              torch.from_numpy(dual), t_args[2])
    jsw = jb.sweep_from_host(tgt, key, valid, dual, level)
    for g in (0, 1000, P - 1):
        got, want = tb.eval_route(tsw, mt, mk, g), jb.eval_route(jsw, mt, mk, g)
        assert len(got.tree) > 0
        for x, y in zip(got, want):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _digesting(comm_cls, P, encode):
    """A SimComm that hashes every payload posted, per phase, in order:
    the payloads of thousands of ranks are compared without keeping them."""
    class Digesting(comm_cls):
        def __init__(self):
            super().__init__(P)
            self.digests = {}

        def _digest(self, payload):
            phase = self._phases[-1] if self._phases else None
            self.digests.setdefault(phase, hashlib.sha256()).update(encode(payload))

        def _allgather(self, per_local):
            self._digest(per_local)
            return super()._allgather(per_local)

        def _alltoallv(self, send):
            self._digest(send)
            return super()._alltoallv(send)
    return Digesting()


@pytest.mark.slow
def test_balance_and_ghost_on_4100_ranks_match_reference_bytes():
    """Balance and Ghost of a uniform 4,096-tet forest on SimComm(4100)
    (more ranks than the eval_route kernel keeps markers in shared memory):
    the port runs them on the CPU, and the JAX package under
    `use_backend("jnp")` runs them on the same set-up.  Every forest and
    ghost field, every counter and every payload posted (by its SHA-256 per
    phase) are equal, and the bytes are those ROADMAP §3.1 recorded
    (balance 403,541,280 B, ghost 269,309,120 B)."""
    from repro.core import batch as jbatch
    from repro.core import comm as jcomm
    from repro.core import forest as JF
    from repro_torch import convert
    from repro_torch.core import comm as tcomm
    from repro_torch.core import forest as TF
    from test_torch_forest import _assert_same_forests

    P = 4100
    tc = _digesting(TF.SimComm, P, tcomm.encode_payload)
    tb = TF.balance(TF.new_uniform(3, 1, 4, tc, device="cpu"), tc)
    tg = TF.ghost(tb, tc)
    assert TF.count_global(tb) == 4096
    assert TF.validate(tb, tg)
    jc = _digesting(JF.SimComm, P, jcomm.encode_payload)
    with jbatch.use_backend("jnp"):
        jb = JF.balance(JF.new_uniform(3, 1, 4, jc), jc)
        jg = JF.ghost(jb, jc)
    _assert_same_forests(tb, jb)
    for a, b in zip(tg, jg, strict=True):
        for k in convert.GHOST_FIELDS:
            np.testing.assert_array_equal(a[k].numpy(), b[k], err_msg=k)
    for phase in ("balance", "ghost"):
        assert tc.counters[phase] == jc.counters[phase]
        assert tc.digests[phase].hexdigest() == jc.digests[phase].hexdigest()
    assert tc.bytes_for("balance") == jc.bytes_for("balance") == 403_541_280
    assert tc.bytes_for("ghost") == jc.bytes_for("ghost") == 269_309_120

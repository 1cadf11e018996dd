"""The port's data path (`repro_torch.data`) against the JAX package's, on the
CPU.

The numpy threefry-2x32 against `jax.random` bit for bit: keys
(`PRNGKey`, `fold_in`), the hash words, the 32 random bits and `uniform`'s
floats, for several (seed, step, dp_rank, dp_size), in the installed JAX's
partitionable mode.  Tokens: equal to the reference's except where the
float32 value before truncation lies within 1e-5 of an integer (the two
`exp`/`log` may round apart there); the test counts those.  The encdec
family's frames and the vlm family's patches (`jax.random.normal` in bf16
from the tokens' key, times 0.1) bit for bit, every one of the 128 values
such a draw takes included; the vlm tokens cut after the patches.  The
pipeline is seekable and reshards, frames included; a `Trainer` restart of
reduced whisper-medium repeats its losses; `pack_documents` equals the
reference's.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace

import repro.configs as jconfigs
from repro.data import DataPipeline as JPipeline, pack_documents as j_pack
from repro.data.pipeline import synthetic_batch as j_batch
from repro.models.config import ShapeConfig as JShape
import repro_torch.configs as tconfigs
from repro_torch.data import DataPipeline, pack_documents, pipeline as tp
from repro_torch.launch.train import make_train_step
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime import Trainer, TrainerConfig

ARCH = "qwen3-1.7b"
CASES = [(0, 0, 0, 1), (7, 123, 0, 1), (3, 5, 1, 2), (2 ** 31 - 1, 2 ** 32 - 1, 3, 4),
         (12, 40_000, 5, 8)]
NEAR_INT = 1e-5


def test_jax_is_in_partitionable_threefry_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,step,rank,_size", CASES)
def test_keys_and_hash_words_match_jax(seed, step, rank, _size):
    key = tp.fold_in(tp.fold_in(tp.prng_key(seed), step), rank)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), step), rank)
    np.testing.assert_array_equal(tp.prng_key(seed), np.asarray(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(key, np.asarray(jkey))
    x0 = np.arange(17, dtype=np.uint32) * np.uint32(2654435761)
    x1 = np.arange(17, dtype=np.uint32)[::-1].copy()
    from jax._src import prng as jprng
    want = jprng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                     jnp.asarray(x0), jnp.asarray(x1))
    got = tp.threefry2x32(key, x0, x1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed,step,rank,_size", CASES)
def test_random_bits_and_uniform_match_jax_bit_for_bit(seed, step, rank, _size):
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), step), rank)
    key = np.asarray(jkey)
    shape = (3, 37)
    np.testing.assert_array_equal(tp.random_bits(key, shape),
                                  np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    got = tp.uniform(key, shape, minval=1e-6, maxval=1.0)
    want = np.asarray(jax.random.uniform(jkey, shape, minval=1e-6, maxval=1.0))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@functools.lru_cache(maxsize=None)
def _cfg(vocab: int | None = None):
    t, j = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    if vocab is not None:
        t, j = replace(t, vocab_size=vocab), replace(j, vocab_size=vocab)
    return t, j


@pytest.mark.parametrize("seed,step,rank,size", CASES)
@pytest.mark.parametrize("vocab", [None, 40])
def test_tokens_match_jax_but_near_integers(seed, step, rank, size, vocab):
    tcfg, jcfg = _cfg(vocab)
    S, GB = 256, 16
    got = tp.synthetic_batch(tcfg, ShapeConfig("t", S, GB, "train"), seed=seed, step=step,
                             dp_rank=rank, dp_size=size, device="cpu")["tokens"]
    want = np.asarray(j_batch(jcfg, JShape("t", S, GB, "train"), seed=seed, step=step,
                              dp_rank=rank, dp_size=size)["tokens"])
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (GB // size, S)
    key = tp.fold_in(tp.fold_in(tp.prng_key(seed), step), rank)
    u = tp.uniform(key, want.shape, minval=1e-6, maxval=1.0)
    z = np.exp(-np.log(u.astype(np.float64)) * 0.35) - 1.0
    near = np.abs(z - np.round(z)) < NEAR_INT
    differ = got.numpy() != want
    assert not (differ & ~near).any()
    assert int(differ.sum()) <= int(near.sum()) <= 2 + want.size // 1000
    assert int(got.max()) <= tcfg.vocab_size - 1


def test_pipeline_is_seekable_and_reshards():
    tcfg, jcfg = _cfg()
    shape = ShapeConfig("t", 32, 8, "train")
    p = DataPipeline(tcfg, shape, seed=7, device="cpu")
    assert torch.equal(p.batch(123)["tokens"], p.batch(123)["tokens"])
    assert not torch.equal(p.batch(123)["tokens"], p.batch(124)["tokens"])
    halves = [p.reshard(r, 2).batch(5)["tokens"] for r in (0, 1)]
    jhalves = [np.asarray(JPipeline(jcfg, JShape("t", 32, 8, "train"), seed=7)
                          .reshard(r, 2).batch(5)["tokens"]) for r in (0, 1)]
    for h, j in zip(halves, jhalves):
        assert tuple(h.shape) == (4, 32)
        np.testing.assert_array_equal(h.numpy(), j)
    with pytest.raises(ValueError):
        p.reshard(0, 3)
    # the encdec family's frames: seekable, and each rank's slice the JAX one
    tw, jw = (pkg.reduced(pkg.get_config("whisper-medium")) for pkg in (tconfigs, jconfigs))
    p = DataPipeline(tw, shape, seed=7, device="cpu")
    assert torch.equal(p.batch(9)["frames"], p.batch(9)["frames"])
    for r in (0, 1):
        got = p.reshard(r, 2).batch(5)["frames"]
        want = np.asarray(JPipeline(jw, JShape("t", 32, 8, "train"), seed=7).reshard(r, 2)
                          .batch(5)["frames"])
        assert tuple(got.shape) == (4, tw.encoder_seq, tw.d_model)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("arch,full,S,GB", [("whisper-medium", False, 40, 4),
                                            ("pixtral-12b", False, 48, 4),
                                            ("whisper-medium", True, 4096, 8)])
def test_frames_and_patches_match_jax_bit_for_bit(arch, full, S, GB):
    """`synthetic_batch` of reduced whisper-medium and pixtral-12b, and of
    whisper-medium at full width (8 x 1500 x 1024 frames, train_4k's S),
    against the JAX package's: tokens, frames and patches bit for bit (a
    vlm batch's tokens cut to S - P after its P = min(num_patches, S / 2)
    patches)."""
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    if not full:
        t, j = tconfigs.reduced(t), jconfigs.reduced(j)
    got = tp.synthetic_batch(t, ShapeConfig("t", S, GB, "train"), seed=3, step=11, device="cpu")
    want = j_batch(j, JShape("t", S, GB, "train"), seed=3, step=11)
    assert sorted(got) == sorted(want) == sorted(
        ["tokens", "frames" if t.family == "encdec" else "patches"])
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    for k in ("frames", "patches"):
        if k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == torch.bfloat16 and tuple(got[k].shape) == w.shape
            np.testing.assert_array_equal(_bits16(got[k]), w.view(np.int16))
    if t.family == "vlm":
        P = min(t.num_patches, S // 2)
        assert tuple(got["patches"].shape) == (GB, P, t.d_model)
        assert tuple(got["tokens"].shape) == (GB, S - P)


def test_normal_bf16_takes_every_one_of_its_128_values_as_jax():
    """A bf16 normal keeps 7 random bits an element: a draw of 2^18 holds
    all 128 values (about 2048 each), and equals `jax.random.normal`'s
    bit for bit, scaled by 1 and by 0.1."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 77)
    for scale in (1.0, 0.1):
        got = tp.normal_bf16(np.asarray(jkey), (1 << 18,), scale, device="cpu")
        want = np.asarray(jax.random.normal(jkey, (1 << 18,), jnp.bfloat16) * scale)
        assert len(np.unique(want.view(np.int16))) == 128
        np.testing.assert_array_equal(_bits16(got), want.view(np.int16))


def test_trainer_restart_with_frames_is_identical(tmp_path):
    """Reduced whisper-medium in fp32 under `Trainer` (its frames from the
    stream): 6 uninterrupted steps, against 3, a restart from the
    checkpoint, and 3 more; the losses after the restart within rtol 1e-5
    (the reference's restart test)."""
    cfg = replace(tconfigs.reduced(tconfigs.get_config("whisper-medium")), dtype="float32")
    shape = ShapeConfig("test", 24, 4, "train")

    def trainer(ckpt, max_steps):
        return Trainer(cfg, shape, TrainerConfig(ckpt_dir=str(ckpt), ckpt_every=3,
                                                 max_steps=max_steps),
                       step_fn=make_train_step(cfg, num_micro=2, lr=1e-3), seed=2, device="cpu")

    _, _, full = trainer(tmp_path / "full", 6).run(seed=1)
    want = {r["step"]: r["loss"] for r in full}
    trainer(tmp_path / "resume", 3).run(seed=1)
    manifest = json.loads((tmp_path / "resume" / "step_2" / "manifest.json").read_text())
    assert manifest["step"] == 2
    _, opt, resumed = trainer(tmp_path / "resume", 6).run(seed=1)
    assert [r["step"] for r in resumed] == [3, 4, 5] and int(opt.step) == 6
    for r in resumed:
        assert abs(r["loss"] - want[r["step"]]) <= 1e-5 * abs(want[r["step"]]), r


@pytest.mark.parametrize("num_ranks,seq_len", [(4, 64), (3, 100), (8, 16)])
def test_pack_documents_matches_reference(num_ranks, seq_len):
    lengths = np.random.default_rng(num_ranks).integers(1, 200, 60)
    rank_of_doc, rows, imb = pack_documents(lengths, seq_len, num_ranks, device="cpu")
    j_rank, j_rows, j_imb = j_pack(lengths, seq_len, num_ranks)
    np.testing.assert_array_equal(rank_of_doc, np.asarray(j_rank))
    assert rows == j_rows
    assert abs(imb - j_imb) <= 1e-6 * abs(j_imb)
    assert sum(p[2] for r in rows for p in r) == int(lengths.sum())

"""Build the CUDA kernels of `csrc/` and load them with ctypes.

Two sources: `sfc.cu` (the element kernels) and `flash_attention.cu`
(attention).  A `csrc/<stem>.cu` source is compiled by `nvcc` into a shared
library with a plain C interface, at first use, into `_build/` beside this
file (a directory that git ignores); `build_all` starts one `nvcc` a source,
all together.  The packed lookup tables the kernels index (the one-level
tables, and the m-level tables of the simplex key and decode walks), and
the root simplex's containment constants, are generated from
`core.tables` into `_build/sfc_tables.h` first, so no table is typed by
hand.  A library is named after the hash of its source, the generated
header and the flags, so an edit rebuilds and an unchanged tree reuses the
earlier build.

This module imports nothing CUDA-specific: `nvcc` is looked up, and a
library loaded, only when a kernel is first needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..core.tables import MAXLEVEL, get_tables

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "WALK_LEVELS", "packed_tables",
           "walk_tables", "neighbor_table", "hex_neighbor_table", "root_containment",
           "table_header", "build", "build_all", "library"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Levels a table lookup of the simplex key and decode walks (`walk_tables`),
# by dimension; each divides MAXLEVEL[d].  Picked by measurement on the card
# (PERF.md §6): at d = 2, m = 5 and 6 were timed.
WALK_LEVELS = {2: 5, 3: 3}

_LIBS: dict[str, ctypes.CDLL] = {}


def packed_tables(d: int) -> tuple[list[int], list[int]]:
    """The packed transition tables the kernels index, one byte per entry:
    enc[b * 2^d + cid] = local index | parent type << 3 and
    dec[b * 2^d + iloc] = cube id | child type << 3 (the TPU kernels'
    `_packed_tables`; the face-neighbor table is `neighbor_table`)."""
    t = get_tables(d)
    nc, nt = t.num_children, t.num_types
    enc = [0] * (nt * nc)
    dec = [0] * (nt * nc)
    for b in range(nt):
        for cid in range(nc):
            enc[b * nc + cid] = int(t.local_index[cid, b]) | (int(t.parent_type[cid, b]) << 3)
        for iloc in range(nc):
            dec[b * nc + iloc] = (int(t.cube_id_of_local[b, iloc])
                                  | (int(t.type_of_local[b, iloc]) << 3))
    return enc, dec


def walk_tables(d: int, m: int | None = None) -> tuple[list[int], list[int]]:
    """The m-level transition tables of the simplex key and decode walks
    (m = WALK_LEVELS[d] by default), composed from `packed_tables`, 16 bits
    an entry, entry b * 2^(d m) + chunk for a type b and the chunk of m
    levels (t = 0 the finest of them):

    wenc: chunk = the m cube ids axis-major, bit m k + t the bit of axis k
    at level t; entry = the m local indices as key digits, digit t at bit
    d t, | the type at the coarse end << d m (b is the type at the fine end).
    wdec: chunk = the m key digits, digit t at bit d t; entry = the m cube
    ids axis-major | the type at the fine end << d m (b is the type at the
    coarse end).

    The decode walk masks the digits finer than an element's level to 0 and
    walks every level: it relies on child 0 of every type b having cube id
    0 and type b, which is checked here."""
    m = WALK_LEVELS[d] if m is None else m
    enc1, dec1 = (np.array(t, dtype=np.int64) for t in packed_tables(d))
    nc = 1 << d
    nt = len(enc1) // nc
    if MAXLEVEL[d] % m or d * m + (nt - 1).bit_length() > 16:
        raise ValueError(f"{m} levels a lookup do not divide {MAXLEVEL[d]} levels or fit 16 bits")
    if any(dec1[b * nc] != b << 3 for b in range(nt)):
        raise ValueError(f"d={d}: child 0 of some type is not cube 0 of its parent's type")
    idx = np.arange(nt << (d * m), dtype=np.int64)
    top, chunk = idx >> (d * m), idx & ((1 << (d * m)) - 1)
    wenc, b = np.zeros_like(idx), top
    for t in range(m):                                 # fine -> coarse
        cid = sum(((chunk >> (m * k + t)) & 1) << k for k in range(d))
        p = enc1[b * nc + cid]
        wenc |= (p & 7) << (d * t)
        b = p >> 3
    wenc |= b << (d * m)
    wdec, b = np.zeros_like(idx), top
    for t in range(m - 1, -1, -1):                     # coarse -> fine
        p = dec1[b * nc + ((chunk >> (d * t)) & (nc - 1))]
        for k in range(d):
            wdec |= ((p >> k) & 1) << (m * k + t)
        b = p >> 3
    wdec |= b << (d * m)
    return wenc.tolist(), wdec.tolist()


def neighbor_table(d: int) -> list[int]:
    """The packed face-neighbor table (Algorithm 4.6), 16 bits per entry:
    nei[b * (d+1) + f] = neighbor type | dual face << 3
    | (offset_k + 1) << (6 + 2k) for each axis k — the third of the TPU
    kernels' `_packed_tables`."""
    t = get_tables(d)
    nei = [0] * (t.num_types * (d + 1))
    for b in range(t.num_types):
        for f in range(d + 1):
            v = int(t.neighbor_type[b, f]) | (int(t.neighbor_face[b, f]) << 3)
            for k in range(d):
                v |= (int(t.neighbor_offset[b, f, k]) + 1) << (6 + 2 * k)
            nei[b * (d + 1) + f] = v
    return nei


def hex_neighbor_table(d: int) -> list[int]:
    """The packed hex face-neighbor table, one entry per face f = 2 axis +
    dir: dual face f ^ 1 << 3 | (offset_k + 1) << (6 + 2k) for each axis k,
    the offset -1 or +1 on axis f // 2 and 0 elsewhere (type bits 0: hexes
    have no types) — the TPU kernels' `_packed_hex_nei`."""
    nei = [0] * (2 * d)
    for f in range(2 * d):
        v = (f ^ 1) << 3
        for k in range(d):
            off = (2 * (f % 2) - 1) if k == f // 2 else 0
            v |= (off + 1) << (6 + 2 * k)
        nei[f] = v
    return nei


def root_containment(d: int) -> tuple[list[int], dict[str, int]]:
    """The Proposition-23 constants of the root simplex (type 0): its axis
    permutation, and for each boundary case (ik, kj, diag) the bit mask of
    the element types that lie outside the root on that boundary."""
    t = get_tables(d)
    masks = {}
    for name in ("ik", "kj", "diag"):
        row = getattr(t, f"outside_types_{name}")[0]
        masks[name] = sum(1 << b for b in range(t.num_types) if int(row[b]))
    return [int(v) for v in t.outside_perm[0]], masks


def table_header() -> str:
    """Text of the generated `sfc_tables.h`."""
    lines = ["// Generated by repro_torch/kernels/build.py from core/tables.py.",
             "#pragma once"]
    for d in (2, 3):
        lines.append(f"#define SFC_MAXLEVEL_{d} {MAXLEVEL[d]}")
        enc, dec = packed_tables(d)
        for name, vals in (("enc", enc), ("dec", dec)):
            body = ", ".join(str(v) for v in vals)
            lines.append(f"__constant__ unsigned char sfc_{name}_{d}[{len(vals)}] = {{{body}}};")
        lines.append(f"#define SFC_WALK_M_{d} {WALK_LEVELS[d]}")
        for name, vals in zip(("walk_enc", "walk_dec"), walk_tables(d)):
            body = ", ".join(str(v) for v in vals)
            lines.append(f"__constant__ __align__(16) unsigned short sfc_{name}_{d}[{len(vals)}] = "
                         f"{{{body}}};")
        for name, nei in (("nei", neighbor_table(d)), ("hex_nei", hex_neighbor_table(d))):
            body = ", ".join(str(v) for v in nei)
            lines.append(f"__constant__ unsigned short sfc_{name}_{d}[{len(nei)}] = {{{body}}};")
        perm, masks = root_containment(d)
        for k, v in enumerate(perm):
            lines.append(f"#define SFC_ROOT_PERM_{d}_{k} {v}")
        for name, v in masks.items():
            lines.append(f"#define SFC_ROOT_OUT_{name.upper()}_{d} {v}")
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _target(src: Path, header: str) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(header.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _start(stem: str):
    """Start `nvcc` on `csrc/<stem>.cu` unless an up-to-date library exists.
    Returns (library path, running build or None)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = table_header()
    hpath = BUILD_DIR / "sfc_tables.h"
    if not hpath.exists() or hpath.read_text() != header:
        tmp = hpath.with_suffix(f".h.{os.getpid()}")
        tmp.write_text(header)
        os.replace(tmp, hpath)
    src = CSRC_DIR / f"{stem}.cu"
    lib = _target(src, header)
    if lib.exists():
        return lib, None
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    log = BUILD_DIR / f"{stem}.log"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(BUILD_DIR), "-o", str(tmp), str(src)]
    with log.open("w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    return lib, (proc, tmp, log)


def _finish(lib: Path, running) -> Path:
    if running is not None:
        proc, tmp, log = running
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(f"CUDA kernel build failed: {log.stem}.cu (nvcc exit {rc}, "
                               f"see {log})")
        os.replace(tmp, lib)
    return lib


def build(stem: str = "sfc") -> Path:
    """Compile `csrc/<stem>.cu` unless an up-to-date library exists, and
    return the library's path.  The compiler's output, register counts
    included, goes to `_build/<stem>.log`.  Raises RuntimeError if `nvcc`
    is missing or the build fails."""
    return _finish(*_start(stem))


def build_all() -> list[Path]:
    """`build` every source of `csrc/`, all `nvcc` runs started together;
    returns the libraries' paths in source order."""
    started = [_start(src.stem) for src in sorted(CSRC_DIR.glob("*.cu"))]
    try:
        return [_finish(lib, running) for lib, running in started]
    finally:
        for _lib, running in started:       # a failed build leaves no compiler running
            if running is not None and running[0].poll() is None:
                running[0].kill()
                running[0].wait()


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu`, building it first if
    needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        lib = _LIBS[stem] = ctypes.CDLL(str(build(stem)))
    return lib

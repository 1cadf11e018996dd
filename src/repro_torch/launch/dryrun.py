"""Dry run of the production meshes: trace every (architecture x shape) cell
on 256 and 512 ranks and take its memory, cost and collectives
(counterpart of the JAX package's `repro.launch.dryrun`).

  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # every cell, both meshes
  python -m repro_torch.launch.dryrun --list

Each cell writes results/dryrun_torch/<arch>__<shape>__<mesh>.json.  A
cell runs the train, prefill or decode step once, as rank 0 of a fake
process group of 256 or 512 ranks (`mesh.init_fake_process_group`: its
collectives move nothing), under a `FakeTensorMode` (tensors of the mesh's
device type with shapes and dtypes, no memory, no arithmetic), with the
parameters, optimizer state, batch and
cache distributed by `launch.sharding`, and the all-to-all MoE and the
activation spec set as the JAX package's dry run sets them.  The mesh is a
"cuda" one unless `--device cpu`, so the traced path is the card's (row
12's operator, not the plain attention); `--device cpu` traces a "cpu" mesh
(there DTensor turns a Shard -> Shard redistribution's all-to-all into an
all-gather and a chunk).  The keys are the JAX package's: the memory
(peak a device: the parameters, state, batch and cache a rank holds, and
the most bytes the traced step's ops hold alive at once, `op_cost`), the
analytic parameter
bytes a device, the cost (`op_cost`, one rank's local ops), the H100
roofline, MODEL_FLOPS and the useful-FLOPs ratio.  `compile_s` holds the
trace's seconds (the port compiles nothing).  `source` holds the digest
of the port's sources the cell was traced on (`source_digest`): `--all`
traces again a cell of another digest, and `report` marks it.  A cell that
errors is a fault of the port, not of the cell.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
PACKAGE = Path(__file__).resolve().parents[1]
SOURCES = {".py", ".cu", ".cuh", ".h", ".cpp"}


def source_digest() -> str:
    """The first 16 hex digits of the SHA-256 of the port's source files
    (their paths and bytes, in order; build outputs and bytecode left
    out): the code state a cell is traced on."""
    h = hashlib.sha256()
    for f in sorted(PACKAGE.rglob("*")):
        rel = f.relative_to(PACKAGE)
        if f.suffix in SOURCES and not {"_build", "__pycache__"} & set(rel.parts):
            h.update(str(rel).encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def _cell_path(arch, shape, mesh_kind):
    return RESULTS / f"{arch}__{shape}__{mesh_kind}.json"


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors of `tree`."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, device=None, cfg=None, shape=None,
             mesh_shape=None) -> dict:
    """Trace one cell; returns its result dict.  `cfg`, `shape` and
    `mesh_shape` (a `mesh.MeshShape`) replace the named config, shape and
    production mesh (the CPU tests trace reduced configs on small meshes)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from ..configs import cell_supported, get_config, get_shape, input_specs
    from ..models import layers as ly
    from ..models import lm as lm_mod
    from ..models import moe_a2a
    from ..models.lm import init_cache, init_params
    from ..optim import init_opt_state
    from . import sharding as sh
    from .mesh import (batch_spec_axes, init_fake_process_group, mesh_device,
                       production_shape)
    from .op_cost import OpCost, analyze
    from .roofline import model_flops, roofline_terms
    from .serve import make_decode_step, make_prefill_step
    from .train import default_num_micro, make_train_step

    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "source": source_digest()}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        out.update(status="skip", why=why)
        return out

    names, dims = mesh_shape or production_shape(mesh_kind == "multi")
    n_dev = int(np.prod(dims))
    kind = mesh_device(device)
    init_fake_process_group(n_dev)
    mesh = init_device_mesh(kind, tuple(dims), mesh_dim_names=tuple(names))
    sizes = dict(zip(names, dims))
    pod = sizes.get("pod", 1)
    out["device"] = kind

    # sequence-parallel residuals for pure-FSDP profiles and a2a-MoE configs
    tp_size = sizes.get("model", 1)
    a2a_moe = (cfg.moe is not None and shape.mode in ("train", "prefill")
               and cfg.moe.num_experts % tp_size == 0)
    bax = batch_spec_axes(mesh, shape.global_batch)
    if (cfg.parallelism == "fsdp_sp" or a2a_moe) and shape.mode in ("train", "prefill"):
        lm_mod.set_activation_spec((bax if bax else None, "model", None))
    else:
        lm_mod.set_activation_spec(None)
    moe_a2a.set_moe_impl(mesh=mesh if a2a_moe else None, dp_axes=bax, model_axis="model")

    ly._rope_freqs.cache_clear()      # its tables are fake tensors of this cell's mode
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    try:
        t0 = time.time()
        with fake:
            params = init_params(cfg, device=kind)
            pspecs = sh.params_pspecs(cfg, mesh, params)
            sh.distribute_params(cfg, params, mesh, pspecs)
            specs = input_specs(cfg, shape)
            batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=kind) for k, v in specs.items()}
            batch = sh.distribute_tree(batch, sh.batch_pspecs(mesh, batch), mesh)
            held = [params, batch]
            if shape.mode == "train":
                num_micro = default_num_micro(cfg, shape, mesh)
                out["num_micro"] = num_micro
                opt = init_opt_state(params, cfg.optimizer, cfg.opt_state_dtype)
                opt = sh.distribute_tree(
                    opt, sh.opt_state_pspecs(cfg, mesh, pspecs, params, cfg.optimizer), mesh)
                held.append(opt)
                micro = {k: sh.to_named(mesh, s) for k, s in
                         sh.batch_pspecs(mesh, {k: v[:v.shape[0] // num_micro]
                                                for k, v in specs.items()}).items()}
                step_fn = make_train_step(
                    cfg, num_micro=num_micro, micro_shardings=micro,
                    grad_shardings={n: sh.to_named(mesh, s) for n, s in pspecs.items()})

                def run():
                    return step_fn(params, opt, batch, 0)
            else:
                cache = init_cache(cfg, shape.global_batch, shape.seq_len, device=kind)
                cache = sh.distribute_tree(cache, sh.cache_pspecs(cfg, mesh, cache), mesh)
                held.append(cache)
                if shape.mode == "prefill":
                    fn = make_prefill_step(cfg)

                    def run():
                        return fn(params, batch, cache)
                else:
                    fn = make_decode_step(cfg)

                    def run():
                        return fn(params, cache, batch["tokens"], shape.seq_len - 1)
            out["lower_s"] = round(time.time() - t0, 2)
            held_bytes = _local_bytes(held)
            t0 = time.time()
            cost = OpCost(pod_size=n_dev // pod)
            with cost:
                result = run()
            del result
            out["compile_s"] = round(time.time() - t0, 2)
    finally:
        lm_mod.set_activation_spec(None)
        moe_a2a.set_moe_impl(mesh=None)
        ly._rope_freqs.cache_clear()
        dist.destroy_process_group()

    out["memory"] = {"argument_bytes": held_bytes, "temp_bytes": int(cost.peak),
                     "peak_bytes_per_device": int(held_bytes + cost.peak)}
    out["analytic_param_bytes_per_device"] = sum(
        int(np.prod(p.shape)) * p.element_size() // sh.spec_divisor(mesh, pspecs[n])
        for n, p in params.named_parameters())

    hc = analyze(cost)
    out["hlo_cost"] = {
        "flops_per_device": hc["flops"],
        "bytes_per_device": hc["bytes"],
        "bytes_per_device_cpu_granularity": hc["bytes_cpu_granularity"],
        "collective_counts": {k: int(v) for k, v in hc["collective_counts"].items()},
        "collective_bytes_by_kind": {k: int(v) for k, v in
                                     hc["collective_bytes_by_kind"].items()},
        "collective_total_bytes": int(hc["collective_total_bytes"]),
        "cross_pod_bytes": int(hc["cross_pod_bytes"]),
        "network_bytes": int(hc["network_bytes"]),
        "bytes_attention_internal": hc["bytes_attention_internal"],
    }
    rt = roofline_terms(hc["flops"], hc["bytes"], hc["collective_total_bytes"],
                        hc["cross_pod_bytes"], hc["network_bytes"])
    out["roofline"] = rt
    out["roofline_fused_attention"] = rt       # row 12 is fused already
    mf = model_flops(cfg, shape)
    out["model_flops_global"] = mf
    total = hc["flops"] * n_dev
    out["useful_flops_ratio"] = mf / total if total else 0.0
    out["status"] = "ok"
    return out


# ------------------------------------------------------------------ driver
def _one(arch, shp, mk, device, timeout):
    t0 = time.time()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shp,
           "--mesh", mk] + (["--device", device] if device else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[2]), *filter(None, [os.environ.get("PYTHONPATH")])]))
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
        err, rc = r.stderr, r.returncode
    except subprocess.TimeoutExpired:
        err, rc = f"timed out after {timeout} s", -1
    dt = time.time() - t0
    path = _cell_path(arch, shp, mk)
    if rc != 0 and not path.exists():
        path.write_text(json.dumps({"arch": arch, "shape": shp, "mesh": mk, "status": "error",
                                    "source": source_digest(), "why": err[-4000:],
                                    "wall_s": dt}, indent=2))
    return arch, shp, mk, rc, dt


def drive_all(meshes=("single", "multi"), force=False, timeout=3600, only_arch=None,
              only_shape=None, device=None, jobs=1):
    """Run every cell on both meshes, one process a cell, `jobs` at once;
    a cell already traced on these sources is kept unless `force`."""
    from ..configs import all_cells
    RESULTS.mkdir(parents=True, exist_ok=True)
    digest = source_digest()
    todo = []
    for arch, shp, ok, why in all_cells():
        if (only_arch and arch != only_arch) or (only_shape and shp != only_shape):
            continue
        for mk in meshes:
            path = _cell_path(arch, shp, mk)
            if (not force and path.exists()
                    and json.loads(path.read_text()).get("source") == digest):
                continue
            todo.append((arch, shp, mk))
    print(f"dryrun driver: {len(todo)} cells to run on sources {digest}", flush=True)
    with ThreadPoolExecutor(max_workers=max(1, jobs)) as ex:
        futs = [ex.submit(_one, *t, device, timeout) for t in todo]
        for i, f in enumerate(futs):
            arch, shp, mk, rc, dt = f.result()
            print(f"[{i + 1}/{len(todo)}] {arch} x {shp} x {mk}: "
                  f"{'done' if rc == 0 else 'ERROR'} in {dt:.0f}s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--only-arch")
    ap.add_argument("--only-shape")
    ap.add_argument("--device", help="the mesh's device type: cuda (default) or cpu")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced at once (--all)")
    args = ap.parse_args()

    if args.list:
        from ..configs import all_cells
        for arch, shp, ok, why in all_cells():
            print(f"{arch:24s} {shp:12s} {'ok' if ok else 'SKIP: ' + why}")
        return
    if args.all:
        drive_all(force=args.force, only_arch=args.only_arch, only_shape=args.only_shape,
                  device=args.device, jobs=args.jobs)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --list)")
    RESULTS.mkdir(parents=True, exist_ok=True)
    try:
        out = run_cell(args.arch, args.shape, args.mesh, device=args.device)
    except Exception:
        out = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh, "status": "error",
               "source": source_digest(), "why": traceback.format_exc()[-6000:]}
    path = _cell_path(args.arch, args.shape, args.mesh)
    path.write_text(json.dumps(out, indent=2))
    print(json.dumps({k: v for k, v in out.items() if k != "why"}, indent=2))
    if out["status"] == "error":
        print(out["why"][-3000:], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()

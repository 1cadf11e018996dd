"""Rank scripts of the port's DeviceMesh tests, one rank a process.

No JAX here, so the card can run them too.  `MESH_SCRIPT` runs under
`repro_torch.launch.multiproc.run_ranks(MESH_SCRIPT, 4, extra_args=(outdir,
device, cases))` (argv = [store_port, rank, outdir, device, cases], the
cases comma-separated, run in turn) and meets the other ranks in a gloo
("cpu") or NCCL ("cuda") process group of 4 on a (2, 2) ("data", "model")
mesh.  Rank 0 writes `<outdir>/<case>.json` (and `.npz` where arrays are
compared against the JAX package in the test):

- "qwen3", "mixtral", "mamba2", "mixtral_drop": a reduced config in fp32
  (mixtral's fsdp: ZeRO gathers, its 4 experts split over 'model';
  mamba2: the SSD's scan a rank's rows at a time; "mixtral_drop": mixtral
  at capacity factor 1, below E / k, so that experts drop pairs), the
  same seeded weights and batch on every rank, `loss_fn` and its
  gradients unsharded and through `distribute_params`: the losses, the
  worst relative gradient error over the parameters, and the pairs each
  MoE layer's route dropped (the sharded run's summed over the data
  shards);
- "train": two `make_train_step` steps of reduced mixtral sharded (2
  micro-batches, with `micro_shardings` and `grad_shardings`) against the
  same steps unsharded: losses and the worst parameter error after them;
- "a2a": the JAX package's `tests/models/test_moe_a2a.py` layer (8
  experts, a shared one, capacity factor 4) through `moe_layer_a2a` with
  the batch over 'data' and tokens over 'model', against `moe_layer`:
  output, aux, and the gradients of sum(out w) for the weights and x;
- "psum": three steps of `compressed_psum` over all four ranks with error
  feedback, each rank's input its own draw (`<outdir>/psum.npz`: inputs,
  outputs and residuals of every rank);
- "ckpt": a (2, 2)-sharded DTensor and a replicated one saved with
  `sharded=True`, restored onto a (1, 4) mesh and gathered.
"""

MESH_SCRIPT = r"""
import contextlib, json, sys
from dataclasses import replace
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
port, rank, outdir, device, cases = sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]), \
    sys.argv[4], sys.argv[5].split(",")
if device == "cuda":
    torch.cuda.set_device(rank % torch.cuda.device_count())
dist.init_process_group("nccl" if device == "cuda" else "gloo")
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config, reduced
from repro_torch.launch import sharding as sh
from repro_torch.launch.train import make_train_step
from repro_torch.models import init_params, loss_fn, moe, spmd
from repro_torch.models.config import ModelConfig, MoEConfig

mesh = init_device_mesh(device, (2, 2), mesh_dim_names=("data", "model"))


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def batch_of(cfg, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)}
    return {k: v.to(device) for k, v in b.items()}


def rel(a, b):
    a, b = full(a).double(), full(b).double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@contextlib.contextmanager
def dropped():
    # the routed pairs each `moe.route` call drops (this rank's), a list
    # filled while the context is open
    seen, route = [], moe.route

    def counted(*args):
        r = route(*args)
        seen.append(int((~r[4]).sum()))
        return r

    moe.route = counted
    try:
        yield seen
    finally:
        moe.route = route


def run(case, out):
    if case in ("qwen3", "mixtral", "mamba2", "mixtral_drop"):
        arch = {"qwen3": "qwen3-1.7b", "mixtral": "mixtral-8x7b", "mamba2": "mamba2-130m",
                "mixtral_drop": "mixtral-8x7b"}[case]
        cfg = replace(reduced(get_config(arch)), dtype="float32")
        if case == "mixtral_drop":
            cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=1.0))
        batch = batch_of(cfg, 4, 32, 1)
        ref = init_params(cfg, seed=0, device=device).requires_grad_()
        with dropped() as d0:
            l0, m0 = loss_fn(cfg, ref, batch)
        l0.backward()
        model = sh.distribute_params(cfg, init_params(cfg, seed=0, device=device), mesh)
        model.requires_grad_()
        b = sh.distribute_tree(batch, sh.batch_pspecs(mesh, batch), mesh)
        with dropped() as d1:
            l1, m1 = loss_fn(cfg, model, b)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, d1)
        # the route runs on each data shard, once a rank of 'model'
        out["dropped"] = d0
        out["dropped_mesh"] = [sum(e[i] for e in every) // mesh.size(1) for i in range(len(d1))]
        with spmd.on_mesh(l1):
            l1.backward()
        out["loss"], out["loss_mesh"] = float(l0), float(full(l1))
        out["aux"], out["aux_mesh"] = float(m0["aux"]), float(full(m1["aux"]))
        out["grad_err"] = max(rel(b_.grad, a.grad) for (_, a), (_, b_)
                              in zip(ref.named_parameters(), model.named_parameters()))
        out["placements"] = {n: [str(q) for q in p.placements]
                             for n, p in model.named_parameters()}
        out["grad_placements"] = {n: [str(q) for q in p.grad.placements]
                                  for n, p in model.named_parameters()}
    elif case == "train":
        from repro_torch.optim import init_opt_state
        cfg = replace(reduced(get_config("mixtral-8x7b")), dtype="float32")
        kw = dict(num_micro=2, lr=1e-2, warmup=2, total_steps=6, clip_norm=0.5)
        ref = init_params(cfg, seed=0, device=device)
        ref_opt = init_opt_state(ref, cfg.optimizer, cfg.opt_state_dtype)
        model = sh.distribute_params(cfg, init_params(cfg, seed=0, device=device), mesh)
        pspecs = sh.params_pspecs(cfg, mesh, model)
        opt = sh.distribute_tree(init_opt_state(model, cfg.optimizer, cfg.opt_state_dtype),
                                 sh.opt_state_pspecs(cfg, mesh, pspecs, model, cfg.optimizer), mesh)
        first = batch_of(cfg, 8, 32, 0)
        micro = {k: sh.to_named(mesh, s) for k, s in sh.batch_pspecs(mesh, first).items()}
        grads = {n: sh.to_named(mesh, s) for n, s in pspecs.items()}
        step_ref = make_train_step(cfg, **kw)
        step = make_train_step(cfg, **kw, micro_shardings=micro, grad_shardings=grads)
        losses = []
        for i in range(2):
            batch = batch_of(cfg, 8, 32, i)
            ref, ref_opt, m0 = step_ref(ref, ref_opt, batch, i)
            b = sh.distribute_tree(batch, sh.batch_pspecs(mesh, batch), mesh)
            model, opt, m1 = step(model, opt, b, i)
            losses.append((float(m0["loss"]), float(full(m1["loss"]))))
        out["losses"] = losses
        out["param_err"] = max(rel(b_, a) for (_, a), (_, b_)
                               in zip(ref.named_parameters(), model.named_parameters()))
    elif case == "a2a":
        from repro_torch.models import moe_a2a
        from repro_torch.models.lm import _Init, _moe_params
        from repro_torch.models.moe import moe_layer
        cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=64, num_heads=4,
                          num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
                          moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, num_shared=1,
                                        capacity_factor=4.0))
        p = {k: v.detach().requires_grad_() for k, v in
             _moe_params(cfg, _Init(0, torch.device(device), torch.float32)).items()}
        g = torch.Generator().manual_seed(1)
        x0 = torch.randn(4, 32, 64, generator=g).to(device).requires_grad_()
        w = torch.randn(4, 32, 64, generator=g).to(device)
        want, aux_want = moe_layer(cfg, p, x0)
        (want * w).sum().backward()
        moe_a2a.set_moe_impl(mesh=mesh, dp_axes=("data",), model_axis="model")
        assert moe_a2a.a2a_available(cfg, 32)
        rep = [Replicate(), Replicate()]
        dp = {k: distribute_tensor(v.detach(), mesh, [Replicate(), Shard(0)] if k.startswith(
            "experts") else rep, src_data_rank=None).requires_grad_() for k, v in p.items()}
        x = distribute_tensor(x0.detach(), mesh, rep, src_data_rank=None).requires_grad_()
        got, aux_got = moe_a2a.moe_layer_a2a(cfg, dp, x)
        with spmd.on_mesh(got):
            (got * distribute_tensor(w, mesh, rep, src_data_rank=None)).sum().backward()
        out["out_err"] = float((full(got) - want).abs().max())
        out["aux"], out["aux_a2a"] = float(aux_want), float(full(aux_got))
        out["grad_err"] = {k: float((full(dp[k].grad) - p[k].grad).abs().max()
                                    / p[k].grad.abs().max()) for k in p}
        out["x_grad_err"] = float((full(x.grad) - x0.grad).abs().max() / x0.grad.abs().max())
        out["a2a_placements"] = [str(q) for q in got.placements]
        moe_a2a.set_moe_impl(mesh=None)
    elif case == "psum":
        from repro_torch.optim import compressed_psum
        xs = [np.random.default_rng(10 + r).standard_normal((3, 300)).astype(np.float32)
              for r in range(4)]
        x = torch.from_numpy(xs[rank]).to(device)
        res, outs, resids = None, [], []
        for _ in range(3):
            y, res = compressed_psum(x, dist.group.WORLD, residual=res)
            outs.append(y.cpu().numpy())
            resids.append(res.cpu().numpy())
        every = [None] * 4
        dist.all_gather_object(every, (outs, resids))
        if rank == 0:
            np.savez(outdir / "psum.npz", x=np.stack(xs),
                     out=np.stack([e[0] for e in every]), res=np.stack([e[1] for e in every]))
    elif case == "ckpt":
        from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
        arr = torch.arange(64.0).reshape(8, 8).to(device)
        tree = {"w": distribute_tensor(arr, mesh, [Shard(0), Shard(1)], src_data_rank=None),
                "r": distribute_tensor(arr + 1, mesh, [Replicate(), Replicate()],
                                       src_data_rank=None),
                "b": torch.arange(3, dtype=torch.int32)}
        save_checkpoint(outdir / "ckpt", tree, step=0, sharded=True)
        m2 = init_device_mesh(device, (1, 4), mesh_dim_names=("data", "model"))
        sh2 = {"w": (m2, [Shard(0), Shard(1)]), "r": (m2, [Replicate(), Shard(0)]), "b": None}
        got, manifest = restore_checkpoint(outdir / "ckpt", tree, shardings=sh2)
        out["w_equal"] = bool(torch.equal(got["w"].full_tensor().cpu(), arr.cpu()))
        out["r_equal"] = bool(torch.equal(got["r"].full_tensor().cpu(), (arr + 1).cpu()))
        out["w_local"] = list(got["w"].to_local().shape)
        out["b"] = np.asarray(got["b"]).tolist()
        out["mesh2"] = list(got["w"].device_mesh.shape)
        out["manifest"] = manifest
    else:
        raise SystemExit(f"unknown case {case}")


for case in cases:
    out = {}
    run(case, out)
    if rank == 0:
        (outdir / f"{case}.json").write_text(json.dumps(out))
    dist.barrier()
dist.destroy_process_group()
"""

"""The port's dry run (`repro_torch.launch.dryrun.run_cell`) on reduced
configs, on fake (2, 4), (2, 8) and (2, 2, 2) "cpu" meshes of one process
(the fake process group), for train, prefill and decode.

Each cell must be `ok` with the JAX package's result keys.  The cost is
one rank's local ops (`launch.op_cost`), so its FLOPs times the ranks must
equal the FLOPs of the same step on a (1, 1) mesh where no work is
replicated (qwen3: every head and every token on one rank only), and stay
within a band of MODEL_FLOPS (6 N D for training, 2 N D for inference):
the traced FLOPs add remat's recomputed forward (a third of a training
step), attention's S^2 work, the router, and the reduced MoE configs'
capacity slots (capacity factor 2: twice the routed tokens' expert work),
so the band is [0.25, 1.05] for the useful/traced ratio of a training
step.  Serving steps unembed one position a sequence where 2 N D counts
the head for every token, so there the band's top is 3.  A mamba2 whose
12 SSD heads do not divide a 'model' of 8 (as mamba2-130m's 24 do not
divide 16) runs the scan whole on every 'model' rank, 8 times the work:
its band's bottom is 0.05.  The collective
kinds are those the sharding asks for: all-gather and reduce-scatter of
ZeRO weights under fsdp (mixtral), all-to-all where the a2a MoE is set
(deepseek-v3 and mixtral's 4 reduced experts over 'model'), none across
pods on one pod.  The JAX side is not run: the keys are the JAX package's
`dryrun.run_cell` ones (`KEYS`).
"""

import functools
from dataclasses import replace

import pytest

import repro_torch.configs as tconfigs
from repro_torch.launch.dryrun import run_cell, source_digest
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.config import ShapeConfig

KEYS = {"arch", "shape", "mesh", "status", "memory", "analytic_param_bytes_per_device",
        "hlo_cost", "roofline", "roofline_fused_attention", "model_flops_global",
        "useful_flops_ratio", "lower_s", "compile_s"}
HLO_KEYS = {"flops_per_device", "bytes_per_device", "bytes_per_device_cpu_granularity",
            "collective_counts", "collective_bytes_by_kind", "collective_total_bytes",
            "cross_pod_bytes", "bytes_attention_internal"}
MESHES = {"2x4": MeshShape(("data", "model"), (2, 4)),
          "2x8": MeshShape(("data", "model"), (2, 8)),
          "2x2x2": MeshShape(("pod", "data", "model"), (2, 2, 2)),
          "1x1": MeshShape(("data", "model"), (1, 1))}
SHAPES = {"train": ShapeConfig("train_s", 64, 8, "train"),
          "prefill": ShapeConfig("prefill_s", 64, 8, "prefill"),
          "decode": ShapeConfig("decode_s", 64, 8, "decode"),
          # past the reduced window of 64: the ring cache's rolled write
          "prefill_ring": ShapeConfig("prefill_r", 128, 8, "prefill")}


def _cfg(arch: str):
    if arch == "mamba2-odd-heads":      # 12 SSD heads over a 'model' of 8, as 24 over 16
        return replace(tconfigs.reduced(tconfigs.get_config("mamba2-130m")), d_model=96)
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    if cfg.num_micro_override:          # two micro-batches trace the loop as four do
        cfg = replace(cfg, num_micro_override=min(cfg.num_micro_override, 2))
    return cfg


@functools.lru_cache(maxsize=None)
def _cell(arch: str, mode: str, mesh: str) -> dict:
    return run_cell(arch, SHAPES[mode].name, mesh, device="cpu", cfg=_cfg(arch),
                    shape=SHAPES[mode], mesh_shape=MESHES[mesh])


CELLS = [("qwen3-1.7b", m, "2x4") for m in ("train", "prefill", "decode")] + [
    ("mixtral-8x7b", "prefill_ring", "2x4"), ("mamba2-130m", "train", "2x2x2"),
    ("mixtral-8x7b", "train", "2x4"), ("deepseek-v3-671b", "train", "2x4"),
    ("deepseek-coder-33b", "prefill", "2x4"),
    ("whisper-medium", "train", "2x4"), ("recurrentgemma-9b", "prefill", "2x4"),
    ("pixtral-12b", "prefill", "2x2x2"), ("mamba2-odd-heads", "train", "2x8")]


@pytest.mark.parametrize("arch,mode,mesh", CELLS)
def test_cells_trace_with_the_jax_package_keys(arch, mode, mesh):
    r = _cell(arch, mode, mesh)
    assert r["status"] == "ok" and KEYS <= set(r), set(r) ^ KEYS
    assert r["source"] == source_digest()
    assert HLO_KEYS <= set(r["hlo_cost"])
    hc = r["hlo_cost"]
    assert hc["flops_per_device"] > 0 and hc["bytes_per_device"] > 0
    hi = 1.05 if mode == "train" else 3.0       # inference: MODEL_FLOPS unembeds every token
    lo = 0.05 if arch == "mamba2-odd-heads" else 0.25   # its SSD whole on each 'model' rank
    assert lo <= r["useful_flops_ratio"] <= hi, r["useful_flops_ratio"]
    mem = r["memory"]
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"] >= \
        r["analytic_param_bytes_per_device"] > 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    kinds = set(hc["collective_counts"])
    cfg = _cfg(arch)
    if mode != "decode" and cfg.moe is not None:
        assert "all-to-all" in kinds                     # the a2a MoE dispatch
    if cfg.fsdp and mode == "train":
        assert {"all-gather", "reduce-scatter"} <= kinds  # ZeRO: gather at use, scatter dW
    if "pod" not in MESHES[mesh].mesh_dim_names:
        assert hc["cross_pod_bytes"] == 0


def test_flops_summed_over_ranks_equal_the_unsharded_count():
    one = _cell("qwen3-1.7b", "train", "1x1")
    for mode in ("train", "prefill"):
        ref = _cell("qwen3-1.7b", mode, "1x1")
        got = _cell("qwen3-1.7b", mode, "2x4")
        assert got["hlo_cost"]["flops_per_device"] * 8 == ref["hlo_cost"]["flops_per_device"]
    assert one["hlo_cost"]["collective_total_bytes"] == 0


def test_a_skipped_cell_is_skipped():
    r = run_cell("qwen3-1.7b", "long_500k", "single", device="cpu")
    assert r["status"] == "skip" and "sub-quadratic" in r["why"]

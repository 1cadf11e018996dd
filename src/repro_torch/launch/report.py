"""The dry run's tables, from results/dryrun_torch (counterpart of the JAX
package's `repro.launch.report`), injected into PERF.md §8 between tags of
their own:

    PYTHONPATH=src python -m repro_torch.launch.report

`dryrun_table`, `roofline_table` and `skip_table` print the JAX package's
tables (the same columns and rows from the same cell keys; the levers
under the roofline table are the H100's).  PERF.md takes `cell_table`:
each cell on both meshes in one row, its peak bytes a device beside the
H100's 80 GB, with the single pod's roofline, a cell traced on other
sources than the tree's (`dryrun.source_digest`) marked "stale".
"""

from __future__ import annotations

import json
from pathlib import Path

from .roofline import HBM_BYTES

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results" / "dryrun_torch"

HINTS = {
    "memory": "fewer eager passes over activations (fused norm / RoPE / SwiGLU kernels); "
              "the plain attention backward's fp32 scores (a backward kernel)",
    "collective": "keep tensor parallelism inside a node of 8 (NVLink), gather each "
                  "block's tokens once, int8 cross-pod gradient reduction",
    "compute": "raise per-device batch or quantize; compute-bound is the target regime",
}


def _gb(x):
    return f"{x / 2**30:.2f}"


def load_cells(results: Path = RESULTS):
    return [json.loads(p.read_text()) for p in sorted(results.glob("*.json"))]


def dryrun_table(cells):
    lines = [
        "| arch | shape | mesh | status | compile s | peak GB/dev | params GB/dev | collectives (count) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for j in cells:
        if j.get("status") == "skip":
            lines.append(f"| {j['arch']} | {j['shape']} | {j['mesh']} | SKIP ({j['why'][:40]}...) | | | | |")
            continue
        if j.get("status") != "ok":
            lines.append(f"| {j['arch']} | {j['shape']} | {j['mesh']} | ERROR | | | | |")
            continue
        mem = j.get("memory", {})
        peak = mem.get("peak_bytes_per_device")
        cc = j.get("hlo_cost", {}).get("collective_counts", {})
        cstr = " ".join(f"{k.split('-')[-1][:3]}:{int(v)}" for k, v in sorted(cc.items()))
        lines.append(
            f"| {j['arch']} | {j['shape']} | {j['mesh']} | ok | {j.get('compile_s', '')} "
            f"| {_gb(peak) if peak else '?'} | {_gb(j.get('analytic_param_bytes_per_device', 0))} "
            f"| {cstr} |")
    return "\n".join(lines)


def roofline_table(cells, hints=None):
    lines = [
        "| arch | shape | compute s | memory s | collective s | bottleneck | "
        "MODEL_FLOPS | useful/HLO flops | roofline frac | frac w/ fused attn |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for j in cells:
        if j.get("mesh") != "single" or j.get("status") != "ok":
            continue
        r = j["roofline"]
        rf = j.get("roofline_fused_attention", {})
        lines.append(
            f"| {j['arch']} | {j['shape']} | {r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"| {r['collective_s']:.4g} | **{r['bottleneck']}** "
            f"| {j['model_flops_global']:.3g} | {j['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {rf.get('roofline_fraction', float('nan')):.3f} |")
    lines.append("")
    lines.append("Per-bottleneck lever (applied in §Perf): ")
    for k, v in (hints or HINTS).items():
        lines.append(f"- **{k}**: {v}")
    return "\n".join(lines)


def skip_table(cells):
    lines = ["| arch | shape | reason |", "|---|---|---|"]
    seen = set()
    for j in cells:
        if j.get("status") == "skip" and (j["arch"], j["shape"]) not in seen:
            seen.add((j["arch"], j["shape"]))
            lines.append(f"| {j['arch']} | {j['shape']} | {j['why']} |")
    return "\n".join(lines)


def cell_table(cells, source=None):
    """One row an (arch, shape) cell, both meshes side by side: status, peak
    bytes a device against the H100's 80 GB and collective bytes a device a
    step (GB = 1e9 B); and on the single pod the parameter bytes a device
    and the roofline's three terms and bottleneck.  Given the digest
    `source`, a cell traced on other sources is marked "stale"."""
    by = {}
    for j in cells:
        by.setdefault((j["arch"], j["shape"]), {})[j["mesh"]] = j

    def one(j):
        if j is None:
            return "not run", ""
        stale = " (stale)" if source is not None and j.get("source") != source else ""
        if j.get("status") != "ok":
            return ("skip" if j.get("status") == "skip" else "ERROR") + stale, ""
        peak = j["memory"]["peak_bytes_per_device"]
        return (f"{peak / 1e9:.2f} ({100 * peak / HBM_BYTES:.0f} %"
                f"{'' if peak <= HBM_BYTES else ', over'}){stale}",
                f"{j['hlo_cost']['collective_total_bytes'] / 1e9:.1f}")

    lines = ["| arch | shape | single: peak GB/dev (of 80) | coll GB | multi: peak GB/dev (of 80) "
             "| coll GB | params GB/dev | compute / memory / collective s | bottleneck |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), m in by.items():
        s1, m1 = m.get("single"), m.get("multi")
        (p1, c1), (p2, c2) = one(s1), one(m1)
        params = terms = neck = ""
        if s1 is not None and s1.get("status") == "ok":
            r = s1["roofline"]
            params = f"{s1['analytic_param_bytes_per_device'] / 1e9:.3f}"
            terms = f"{r['compute_s']:.3g} / {r['memory_s']:.3g} / {r['collective_s']:.3g}"
            neck = r["bottleneck"]
        lines.append(f"| {arch} | {shape} | {p1} | {c1} | {p2} | {c2} | {params} | {terms} "
                     f"| {neck} |")
    return "\n".join(lines)


def inject(md_path: Path, tag: str, content: str):
    begin, end = f"<!-- BEGIN {tag} -->", f"<!-- END {tag} -->"
    text = md_path.read_text() if md_path.exists() else ""
    if begin not in text:
        text += f"\n{begin}\n{end}\n"
    pre = text.split(begin)[0]
    post = text.split(end)[1] if end in text else ""
    md_path.write_text(pre + begin + "\n" + content + "\n" + end + post)


def main():
    from .dryrun import source_digest

    cells = load_cells()
    digest = source_digest()
    n_stale = sum(1 for c in cells if c.get("source") != digest)
    note = (f"All {len(cells)} cells traced on the port's sources {digest}." if not n_stale else
            f"{n_stale} of {len(cells)} cells traced on other sources than {digest} (stale).")
    md = ROOT / "PERF.md"
    inject(md, "DRYRUN_TORCH_TABLE", cell_table(cells, digest) + "\n\n" + note)
    n_ok = sum(1 for c in cells if c.get("status") == "ok")
    n_skip = sum(1 for c in cells if c.get("status") == "skip")
    n_err = sum(1 for c in cells if c.get("status") not in ("ok", "skip"))
    print(f"report: {n_ok} ok, {n_skip} skip, {n_err} error, {n_stale} stale -> {md}")


if __name__ == "__main__":
    main()

"""Hillclimb tool (port of ``src/repro/launch/perf.py``): dry-run one cell
(optionally with config or rule overrides), print the roofline terms and
the top collectives with where in the port they come from.  This is the
"profile" of the dry-run world.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch dbrx-132b --shape train_4k \\
        [--mesh single] [--override remat=dots] [--rule kv_heads=model] [--tag x]

The cell runs as ``launch.dryrun`` runs it: once on fake tensors over a fake
process group of the mesh's size, made and destroyed here.  Each run
appends a record to ``results_torch/perf_log.jsonl`` at the root of the
checkout, so the hypothesis -> change -> measure loop is replayable.
"""
import argparse
import json
import pathlib
import time

from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import fake_mesh
from repro_torch.launch.hlo_analysis import analyze_trace
from repro_torch.launch.roofline import model_flops_for, roofline
from repro_torch.launch.steps import build_cell, lower_cell

LOG = pathlib.Path(__file__).resolve().parents[3] / "results_torch" / "perf_log.jsonl"


def _parse_kv(items):
    out = {}
    for it in items or []:
        k, v = it.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    if "," in v or v == "None":
                        v = None if v == "None" else tuple(x for x in v.split(",") if x)
        out[k] = v
    return out


def run(arch: str, shape: str, mesh_kind: str = "single", *,
        overrides=None, rules=None, tag: str = "", quiet: bool = False) -> dict:
    t0 = time.time()
    if rules:  # merge on top of the shape's default rules
        from repro_torch.launch.steps import SHAPE_RULES
        merged = dict(SHAPE_RULES.get(shape, {}))
        merged.update(rules)
        rules = merged
    with fake_mesh(mesh_kind) as mesh:
        n_dev = mesh.size()
        cell = build_cell(arch, shape, mesh, unroll=False,
                          overrides=overrides or None, rules=rules)
        trace = lower_cell(cell, mesh)
    compile_s = time.time() - t0
    spec = SHAPES[shape]
    cost = analyze_trace(trace, n_dev)
    rf = roofline(trace, n_dev, cfg=cell.cfg, spec=spec, kind=cell.kind,
                  model_flops=model_flops_for(cell.cfg, spec, cell.kind),
                  cost=cost)
    top = cost.top_collectives(15)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "rules": {k: str(v) for k, v in (rules or {}).items()},
        "compile_s": compile_s,
        "t_compute_s": rf["t_compute_s"], "t_memory_s": rf["t_memory_s"],
        "t_collective_s": rf["t_collective_s"], "bound": rf["bound"],
        "mfu_at_roofline": rf.get("mfu_at_roofline"),
        "model_vs_hlo_flops": rf.get("model_vs_hlo_flops"),
        "flops_per_device": rf["flops_per_device"],
        "collective_wire_bytes_per_device": rf["collective_wire_bytes_per_device"],
        "memory_fits_80g": rf["memory_analysis"].get("fits_80g"),
        "memory_total_bytes": rf["memory_analysis"].get("total_nonaliased_bytes"),
        "top_collectives": top,
    }
    LOG.parent.mkdir(parents=True, exist_ok=True)
    with LOG.open("a") as f:
        f.write(json.dumps(rec) + "\n")
    if not quiet:
        print(f"\n== {arch} x {shape} x {mesh_kind}  tag={tag or '-'} "
              f"(trace {compile_s:.0f}s)")
        print(f" bound={rf['bound']}  t_compute={rf['t_compute_s']:.3f}s "
              f"t_memory={rf['t_memory_s']:.3f}s t_coll={rf['t_collective_s']:.3f}s")
        print(f" mfu_at_roofline={rf.get('mfu_at_roofline', 0):.4f}  "
              f"model/hlo={rf.get('model_vs_hlo_flops', 0):.3f}  "
              f"fits80g={rec['memory_fits_80g']}")
        print(" top collectives (wire bytes/device over the step):")
        for r in top[:12]:
            print(f"  {r['wire_bytes'] / 1e9:8.2f} GB  x{r['count']:<6.0f} "
                  f"{r['kind']:<18s} {r['shape']:<22s} ...{r['op'][-70:]}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, e.g. remat=dots")
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding rule override, e.g. kv_heads=model")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    run(args.arch, args.shape, args.mesh,
        overrides=_parse_kv(args.override) or None,
        rules=_parse_kv(args.rule) or None, tag=args.tag)


if __name__ == "__main__":
    main()

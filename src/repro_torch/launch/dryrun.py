"""Multi-pod dry run (port of ``src/repro/launch/dryrun.py``): trace and
analyse every (architecture x input-shape) cell on the production meshes
and record memory, cost and roofline analyses.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh multi

The reference forces 512 host devices before JAX starts and compiles each
cell.  Here a cell's step runs once on fake tensors over a
``torch.distributed`` group of backend ``"fake"`` of the mesh's size (256
ranks for the single pod's 16 x 16, 512 for the multi pod's 2 x 16 x 16),
as this process's rank 0 (``steps.lower_cell``).  Importing this module
sets no environment variable and touches no process group: ``run_cell``
makes the group and destroys it, so a process that holds another group
(NCCL) runs the dry run in a child process.  In a record, ``lower_s`` is
the seconds of that traced run and ``compile_s`` those of the analysis of
its trace.

Results are cached as JSON under ``results_torch/dryrun/`` at the root of
the checkout, so the sweep is resumable (``--force`` runs a cell again).
"""
import argparse
import contextlib
import json
import pathlib
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, cell_supported
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import model_flops_for, roofline
from repro_torch.launch.steps import build_cell, lower_cell, trace_device
from repro_torch.models import set_active_mesh, set_mesh_rules

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results_torch" / "dryrun"

#: the production meshes: shape and axes (``launch.mesh``)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_mesh(mesh_kind: str):
    """The production mesh of ``mesh_kind`` on the trace device, over a
    fake process group of its size made for the duration (this process is
    its rank 0); the active mesh and the rules are reset after."""
    import math

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = MESHES[mesh_kind]
    if dist.is_initialized():
        raise RuntimeError("a process group is initialized: run the dry "
                           "run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_host_mesh(shape, axes, device=trace_device())
    finally:
        set_active_mesh(None)  # build_cell made it active
        set_mesh_rules({})
        dist.destroy_process_group()


def run_cell(arch: str, shape: str, mesh_kind: str, *, force: bool = False,
             rules: dict | None = None, tag: str = "", unroll: bool = False,
             overrides: dict | None = None) -> dict:
    RESULTS.mkdir(parents=True, exist_ok=True)
    out_path = RESULTS / f"{arch}__{shape}__{mesh_kind}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    ok, why = cell_supported(arch, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "skipped": why}
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    try:
        with fake_mesh(mesh_kind) as mesh:
            n_dev = mesh.size()
            rec["devices"] = int(n_dev)
            cell = build_cell(arch, shape, mesh, rules=rules, unroll=unroll,
                              overrides=overrides)
            trace = lower_cell(cell, mesh)
        t1 = time.time()
        spec = SHAPES[shape]
        rf = roofline(trace, n_dev, cfg=cell.cfg, spec=spec, kind=cell.kind,
                      model_flops=model_flops_for(cell.cfg, spec, cell.kind))
        t2 = time.time()
        print(f"[{arch} x {shape} x {mesh_kind}] memory_analysis: "
              f"{rf['memory_analysis']}")
        print(f"[{arch} x {shape} x {mesh_kind}] flops/dev="
              f"{rf['flops_per_device']:.3e} "
              f"bytes/dev={rf['hbm_bytes_per_device_xla_raw']:.3e}")
        rec.update({
            "ok": True,
            "lower_s": t1 - t0,
            "compile_s": t2 - t1,
            "trace_device": trace.device,
            "n_ops": len(trace.ops),
            "n_params": cell.cfg.n_params(),
            "n_active_params": cell.cfg.n_active_params(),
            "roofline": rf,
        })
    except Exception as e:
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[{arch} x {shape} x {mesh_kind}] FAILED: {e}")
    rec["wall_s"] = time.time() - t0
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's unroll flag (the port's layer "
                         "loops are always unrolled)")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for a in archs:
            for s in shapes:
                ok, why = cell_supported(a, s)
                print(f"{a:24s} {s:12s} {'ok' if ok else 'SKIP: ' + why}")
        return

    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")

    n_ok = n_fail = n_skip = 0
    for mesh_kind in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mesh_kind, force=args.force,
                               unroll=args.unroll,
                               tag="_unroll" if args.unroll else "")
                if rec.get("skipped"):
                    n_skip += 1
                elif rec.get("ok"):
                    n_ok += 1
                    rf = rec["roofline"]
                    print(f"OK  {a:24s} {s:12s} {mesh_kind:6s} "
                          f"bound={rf['bound']:10s} "
                          f"t=({rf['t_compute_s']:.2e},{rf['t_memory_s']:.2e},"
                          f"{rf['t_collective_s']:.2e})s "
                          f"compile={rec.get('compile_s', 0):.0f}s")
                else:
                    n_fail += 1
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

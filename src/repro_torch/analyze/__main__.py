"""``python -m repro_torch.analyze`` — verify the precomputed-plan stack
without running the numeric phase (port of ``src/repro/analyze/__main__.py``).

Default usage checks small instances of every shipped generator:

    python -m repro_torch.analyze --all-generators --strict

Other targets:

    python -m repro_torch.analyze --matrix lap2d_256 --matrix kkt_192
    python -m repro_torch.analyze --plan-file /path/to/plan_<key>.pkl
    python -m repro_torch.analyze --all-generators --trace
    python -m repro_torch.analyze --all-generators --trace --device cpu
    python -m repro_torch.analyze --matrix elast3d_12 --smem-cap 100

``--family`` picks the bucket families (``batch``, ``fused`` or ``both``).
``--trace`` runs one real factorization per target on the card (or, with
``--device cpu``, on the CPU) and audits its event trace; without a card it
raises unless ``--device cpu`` is given.  ``--strict`` exits nonzero when
any ERROR finding survives; warnings never gate.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analyze import analyze_matrix, check_plan_file, report_json
from repro_torch.analyze.findings import AnalysisReport

#: small instances of every generator in repro_torch.sparse.gen (incl.
#: stencil variants) — big enough to exercise multi-level schedules and both
#: bucket families, small enough that the full static sweep runs in seconds.
GENERATOR_SUITE = (
    ("lap2d_32", "laplacian_2d", dict(nx=32)),
    ("lap2d9_24", "laplacian_2d", dict(nx=24, stencil=9)),
    ("lap3d_8", "laplacian_3d", dict(nx=8)),
    ("lap3d27_6", "laplacian_3d", dict(nx=6, stencil=27)),
    ("elast3d_4", "elasticity_3d", dict(nx=4)),
    ("kkt_16", "kkt_like", dict(nx=16)),
    ("rand_200", "random_spd", dict(n=200, density=0.02, seed=0)),
)

_FAMILIES = {"batch": ("batch",), "fused": ("fused",),
             "both": ("batch", "fused")}


def _suite_matrices(names):
    from repro_torch.sparse import gen

    small = {name: (fn, kw) for name, fn, kw in GENERATOR_SUITE}
    for name in names:
        if name in small:
            fn, kw = small[name]
            yield name, getattr(gen, fn)(**kw)
        else:
            yield name, gen.make_suite_matrix(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="static analysis of the precomputed-plan stack",
    )
    ap.add_argument("--matrix", action="append", default=[],
                    help="suite matrix name (repeatable; see sparse.gen)")
    ap.add_argument("--all-generators", action="store_true",
                    help="check small instances of every generator "
                         "(the default when no target is given)")
    ap.add_argument("--plan-file", action="append", default=[],
                    help="saved CachedPlan file to validate (pass 4)")
    ap.add_argument("--family", choices=tuple(_FAMILIES), default="both",
                    help="which bucket families to check (default both)")
    ap.add_argument("--trace", action="store_true",
                    help="also run one real factorization per target and "
                         "audit its recorded event trace (the only option "
                         "that runs the numeric phase)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --trace factorizes (default the card)")
    ap.add_argument("--smem-cap", type=float, default=None, metavar="KIB",
                    help="treat this shared memory per block (KiB) as a "
                         "hard cap: launches over it become ERROR findings")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any ERROR finding is reported")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here ('-' for "
                         "stdout)")
    args = ap.parse_args(argv)

    if not (args.matrix or args.plan_file or args.all_generators):
        args.all_generators = True
    families = _FAMILIES[args.family]
    trace_devices = (args.device,) if args.trace else ()
    smem_cap = None if args.smem_cap is None else int(args.smem_cap * 1024)

    names = [name for name, _, _ in GENERATOR_SUITE] \
        if args.all_generators else []
    reports = []
    for name, A in _suite_matrices(names + args.matrix):
        rep = analyze_matrix(
            A, name=f"{name}[{'+'.join(families)}]", families=families,
            smem_cap=smem_cap, max_batch=args.max_batch,
            trace_devices=trace_devices,
        )
        reports.append(rep)
        print(rep.summary())
    for path in args.plan_file:
        rep = AnalysisReport(target=str(path))
        findings, _plan = check_plan_file(path)
        rep.extend(findings)
        reports.append(rep)
        print(rep.summary())

    n_err = sum(len(r.errors) for r in reports)
    n_warn = sum(len(r.warnings) for r in reports)
    print(f"-- {len(reports)} target(s): {n_err} error(s), "
          f"{n_warn} warning(s)")
    if args.json:
        payload = report_json(reports)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
    return 1 if (args.strict and n_err) else 0


if __name__ == "__main__":
    sys.exit(main())

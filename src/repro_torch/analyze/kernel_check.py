"""Pass 3 — kernel static analysis: prove each bucket's fused-kernel launches
fit the card before they run (port of ``src/repro/analyze/kernel_check.py``
on a Hopper resource model).

The port's fused kernel (``kernels/csrc/fused_factor_syrk.cu``) is a loop
of launches per group: a mask pass, then per 64-column slab a panel launch
(and, guarded, the column sweep), a DMMA trailing update, and one DMMA SYRK
of the tail.  Each launch's block, threads and shared memory are fixed by
the source's constants; its grid by the bucket ``(Lp, Wp)`` and the group's
lanes ``Bp`` — all statically known from the schedule.  The reference's
model is the TPU's: a VMEM estimate against a 16 MiB budget, the SYRK
column tile and 128-lane MXU alignment.  None of those figures means
anything on the card, and none is used here.  This pass checks instead:

  * shared memory per block — static plus the dynamic bytes set at launch,
    against the H100's 227 KiB opt-in limit (``HOPPER_SMEM_PER_BLOCK``) or
    an explicit tighter cap; over either is an ERROR (the launch fails);
  * threads per block        — at most 1024: ERROR;
  * grid size                — every launch puts the lanes lane-major on
    ``gridDim.x``, whose limit is 2^31 - 1 blocks: ERROR past it;
  * DMMA tile padding        — ``Wp`` and ``Lp - Wp`` round up to the
    64-wide tile of the trailing and SYRK launches; a padded share above
    ``TILE_WASTE_WARN`` is a WARNING on a bucket at least one slab wide (a
    narrower one is one partial slab, whose cost is the panel launch's
    latency, not its tiles);
  * the "fused" family's promise, restated for the port's tile — ``Lp``
    and ``Wp`` are powers of two (so a dimension of 64 or more is whole
    64-wide tiles and slabs, a narrower one a single tile): a "fused"
    bucket that breaks it is an ERROR, a ragged last slab on another
    family a WARNING;
  * cost-model sanity        — ``group_flop_stats`` must satisfy
    true <= masked <= padded per group (kept from the reference).

The model's constants mirror the sources (``csrc/tile.cuh``: DT, DK, DNT,
DMMA_SMEM_BYTES, TLD, TPSZ; ``csrc/fused_factor_syrk.cu``: NB, ENT, PNT,
PANEL_SMEM(_G), GNT and the guarded sweep's static arrays).  Each library
exports ``<library>_func_attrs``, and ``chip_smoke.py`` holds
``KERNEL_FUNCS`` and ``bucket_smem`` to ``cudaFuncGetAttributes`` of the
built kernels.

Returns (findings, metrics); metrics carry the per-bucket shared-memory
table and the schedule's padded/masked flop-waste ratios.
"""
from __future__ import annotations

from repro_torch.analyze.findings import Finding

_P = "kernel"

#: shared memory one block may opt in to on the H100 (sm_90): 227 KiB
HOPPER_SMEM_PER_BLOCK = 232_448
MAX_THREADS_PER_BLOCK = 1024
MAX_GRID_X = 2 ** 31 - 1
#: SMs of the H100 SXM (the panel launch caps its blocks at one wave)
H100_SMS = 132
#: a padded share of the 64-wide DMMA tiles above this is a warning
TILE_WASTE_WARN = 0.5

# csrc/tile.cuh
DT = 64                              # DMMA output tile edge
DK = 32                              # depth of one staged K chunk
DNT = 256                            # threads of the DMMA tile launches
DMMA_SMEM_BYTES = 2 * 3 * DT * (DK + 4) * 8   # 2 operands x 3 stages
TLD = DT + 4                         # row stride of a 64 x 64 block
TPSZ = 32 * (32 + 4)                 # doubles of the doubling's products
# csrc/fused_factor_syrk.cu
NB = DT                              # slab width
ENT = 256                            # threads of the mask pass / status init
PNT = 128                            # threads of the panel launch
PANEL_SMEM = (3 * NB * TLD + TPSZ) * 8
PANEL_SMEM_G = PANEL_SMEM + NB * 8   # + the slab's column maxima
GNT = 512                            # threads of the guarded sweep
MASK_BLOCKS_MAX = 132 * 32           # mask_blocks' cap (grid-stride pass)


def _static(*sizes, extern_align: int = 1) -> int:
    """Static shared bytes of a kernel's ``__shared__`` variables in
    declaration order, each at its natural alignment (its size, at most 8),
    the total rounded up to the largest alignment — and, in a kernel that
    also declares ``extern __shared__ __align__(A)`` dynamic memory, to A,
    where that memory begins."""
    off, top = 0, extern_align
    for size in sizes:
        a = min(size, 8)
        off, top = (off + a - 1) // a * a + size, max(top, a)
    return (off + top - 1) // top * top


# int last; then the extern __align__(16) panel
PANEL_STATIC = _static(4, extern_align=16)
# route, red, colk, sh_dk
GUARD_STATIC = _static(4, 8 * GNT // 32, 8 * NB, 8)


def _chol_tile(np_: int) -> tuple:
    nw = np_ // 16 if np_ >= 32 else 1
    smem = (np_ * (np_ + 4) + (np_ // 8) * 8 * 12) * 8
    return (f"chol_tile_kernel<{np_}>", 32 * nw, smem, 0)


#: every library's kernel functions, in the order of its
#: ``<library>_func_attrs`` export: (function, threads per block, dynamic
#: shared bytes set at launch, static shared bytes)
KERNEL_FUNCS = {
    "fused_factor_syrk": (
        ("mask_kernel", ENT, 0, 0),
        ("guard_init_kernel", ENT, 0, 0),
        ("panel_kernel<false>", PNT, PANEL_SMEM, PANEL_STATIC),
        ("panel_kernel<true>", PNT, PANEL_SMEM_G, PANEL_STATIC),
        ("guarded_slab_kernel", GNT, 0, GUARD_STATIC),
        ("trailing_kernel", DNT, DMMA_SMEM_BYTES, 0),
        ("syrk_kernel", DNT, DMMA_SMEM_BYTES, 0),
    ),
    "tri_inv": (
        ("inv_diag_kernel", 128, (2 * DT * TLD + TPSZ) * 8, 0),
        ("level_t_kernel", DNT, DMMA_SMEM_BYTES, 0),
        ("level_x_kernel", DNT, DMMA_SMEM_BYTES, 0),
    ),
    "trsm_rlt": (
        # two cp.async rings (16-row X stages, 64-row L stages), L_jj and
        # its inverse, the doubling's products
        ("trsm_rlt_kernel", 128,
         (3 * (16 * (DK + 4) + DT * (DK + 4)) + 2 * DT * TLD + TPSZ) * 8, 0),
    ),
    "chol_tile": tuple(_chol_tile(n) for n in (8, 16, 32, 64, 128)),
    "syrk_ln": (
        ("syrk_ln_kernel<false>", DNT, DMMA_SMEM_BYTES, 0),
        ("syrk_ln_kernel<true>", DNT, DMMA_SMEM_BYTES, 0),
    ),
    "gemm_nt": (("gemm_nt_kernel", DNT, DMMA_SMEM_BYTES, 0),),
}
_FUSED = {f[0]: f[1:] for f in KERNEL_FUNCS["fused_factor_syrk"]}


def built_mismatches(lib: str, rows: list) -> list:
    """Where the built library ``lib`` departs from ``KERNEL_FUNCS``: for
    ``rows`` as ``kernels._build.func_attrs(lib)`` reads them on the card,
    each function whose name, threads, dynamic or static shared bytes differ
    from the model's, or that does not fit a block (threads over its
    ``maxThreadsPerBlock``, registers times threads over 65,536, shared
    bytes over ``HOPPER_SMEM_PER_BLOCK``).  Empty when the model holds."""
    model = KERNEL_FUNCS[lib]
    if [r["function"] for r in rows] != [m[0] for m in model]:
        return [f"{lib}: functions {[r['function'] for r in rows]}"]
    bad = []
    for r, (fn, threads, dyn, static) in zip(rows, model):
        got = (r["threads"], r["dynamic"], r["static"])
        if got != (threads, dyn, static):
            bad.append(f"{fn}: built (threads, dynamic, static) {got}, "
                       f"model {(threads, dyn, static)}")
        if not (threads <= r["max_threads"] and r["regs"] * threads <= 65536
                and static + dyn <= HOPPER_SMEM_PER_BLOCK):
            bad.append(f"{fn}: {r} does not fit a block")
    return bad


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _mask_blocks(total: int) -> int:
    return min(max(_cdiv(total, ENT), 1), MASK_BLOCKS_MAX)


def bucket_smem(Lp: int, Wp: int, *, Bp: int = 1) -> dict:
    """Resources of every launch of the fused kernel (both routes) on a
    group of ``Bp`` lanes of bucket ``(Lp, Wp)``, mirroring the launch loop
    of ``csrc/fused_factor_syrk.cu``: each launch's threads, blocks (the
    largest over the slab loop), dynamic and static shared bytes and their
    sum ``smem``.  ``smem_bytes`` is the largest ``smem`` of the launches."""
    mp = Lp - Wp
    nb = min(Wp, NB)
    nslab = _cdiv(Wp, nb)
    nrt = max(_cdiv(Lp - nb, DT), 1)       # the first slab's row tiles
    wave = max(2 * H100_SMS // Bp, 1)
    grids = {
        "mask_kernel": _mask_blocks(Bp * Lp * Wp),
        "guard_init_kernel": _mask_blocks(max(nslab * Bp * nb, Bp)),
        "panel_kernel<false>": min(nrt, wave) * Bp,
        "panel_kernel<true>": min(nrt, wave) * Bp,
        "guarded_slab_kernel": Bp,
    }
    if Wp > nb:   # a trailing launch follows every slab but the last
        grids["trailing_kernel"] = nrt * _cdiv(Wp - nb, DT) * Bp
    if mp > 0:
        grids["syrk_kernel"] = _cdiv(mp, DT) ** 2 * Bp
    launches = []
    for fn, blocks in grids.items():
        threads, dyn, static = _FUSED[fn]
        launches.append({"function": fn, "threads": threads,
                         "blocks": blocks, "dynamic": dyn, "static": static,
                         "smem": dyn + static})
    tiles = _cdiv(Wp, DT) * DT * (_cdiv(Wp, DT) * DT + _cdiv(mp, DT) * DT)
    return {"Lp": Lp, "Wp": Wp, "mp": mp, "Bp": Bp, "launches": launches,
            "smem_bytes": max(x["smem"] for x in launches),
            "tile_waste": 1.0 - Lp * Wp / tiles}


def check_bucket(Lp: int, Wp: int, *, family: str | None = None,
                 smem_cap: int | None = None,
                 reference: int = HOPPER_SMEM_PER_BLOCK, nb: int = NB,
                 Bp: int = 1) -> list:
    """All static checks for one bucket shape (``Bp`` lanes a group)."""
    out: list = []
    loc = f"bucket ({Lp}, {Wp})"
    mp = Lp - Wp
    if mp < 0 or Wp <= 0:
        return [Finding("error", _P, "bucket-shape", loc,
                        "buckets satisfy Lp >= Wp > 0")]
    pow2 = Lp & (Lp - 1) == 0 and Wp & (Wp - 1) == 0
    if family == "fused" and not pow2:
        out.append(Finding(
            "error", _P, "tile-alignment", loc,
            "the fused bucket family keeps Lp and Wp powers of two, so a "
            f"dimension of {DT} or more is whole {DT}-wide DMMA tiles and "
            "slabs",
            f"Lp={Lp}, Wp={Wp}",
        ))
    elif Wp > nb and Wp % nb != 0:
        out.append(Finding(
            "warning", _P, "ragged-slab", loc,
            "the panel loop's nb-column slabs tile Wp evenly",
            f"Wp={Wp}, nb={nb}",
        ))
    est = bucket_smem(Lp, Wp, Bp=Bp)
    for x in est["launches"]:
        where = f"{loc} {x['function']}"
        if x["smem"] > reference:
            out.append(Finding(
                "error", _P, "smem-overflow", where,
                "a block's static + dynamic shared memory fits the card's "
                f"{reference:,} B per block",
                f"{x['smem']:,} B — this launch fails on the card",
            ))
        elif smem_cap is not None and x["smem"] > smem_cap:
            out.append(Finding(
                "error", _P, "smem-cap", where,
                "a block's static + dynamic shared memory fits the "
                "requested cap",
                f"{x['smem']:,} B > cap {smem_cap:,} B",
            ))
        if x["threads"] > MAX_THREADS_PER_BLOCK:
            out.append(Finding(
                "error", _P, "block-threads", where,
                f"a block has at most {MAX_THREADS_PER_BLOCK} threads",
                f"{x['threads']} threads",
            ))
        if x["blocks"] > MAX_GRID_X:
            out.append(Finding(
                "error", _P, "grid-x", where,
                "a launch's lane-major grid fits gridDim.x (2^31 - 1)",
                f"{x['blocks']:,} blocks",
            ))
    if est["tile_waste"] > TILE_WASTE_WARN and Wp >= DT:
        out.append(Finding(
            "warning", _P, "tile-waste", loc,
            f"Wp and Lp - Wp fill the {DT}-wide DMMA tiles to at least "
            f"{1 - TILE_WASTE_WARN:.0%}",
            f"{est['tile_waste']:.0%} of the tiled cells are padding",
        ))
    return out


def bucket_lanes(sched) -> dict:
    """{(Lp, Wp): the most lanes of one group of that bucket}, sorted."""
    lanes: dict = {}
    for lg in sched.groups:
        for bg in lg:
            key = (bg.Lp, bg.Wp)
            lanes[key] = max(lanes.get(key, 0), len(bg.ids))
    return dict(sorted(lanes.items()))


def check_kernels(sym, sched, *, family: str | None = None,
                  smem_cap: int | None = None,
                  reference: int = HOPPER_SMEM_PER_BLOCK) -> tuple[list, dict]:
    """Static kernel checks + waste accounting for one schedule.

    Returns ``(findings, metrics)``; metrics carries the per-bucket
    shared-memory table (each bucket at its largest group) and the
    schedule's padded/masked flop-waste ratios."""
    from repro_torch.core.schedule import group_flop_stats

    out: list = []
    table = []
    for (Lp, Wp), Bp in bucket_lanes(sched).items():
        out += check_bucket(Lp, Wp, family=family, smem_cap=smem_cap,
                            reference=reference, Bp=Bp)
        est = bucket_smem(Lp, Wp, Bp=Bp)
        est["smem_kib"] = round(est["smem_bytes"] / 1024, 2)
        est["headroom_kib"] = round((reference - est["smem_bytes"]) / 1024, 2)
        table.append(est)
    stats = group_flop_stats(sym, sched)
    for g in stats["groups"]:
        if not (g["true"] <= g["masked"] <= g["padded"]):
            out.append(Finding(
                "error", _P, "cost-model",
                f"level {g['level']} bucket ({g['Lp']}, {g['Wp']})",
                "column-op costs satisfy true <= masked <= padded",
                f"true={g['true']}, masked={g['masked']}, "
                f"padded={g['padded']}",
            ))
    metrics = {
        "buckets": table,
        "max_smem_kib": max((b["smem_kib"] for b in table), default=0.0),
        "padded_waste": stats["padded_waste"],
        "masked_waste": stats["masked_waste"],
    }
    return out, metrics

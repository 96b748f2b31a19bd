"""Device engine in PyTorch: the reference's ``DeviceEngine``
(``src/repro/core/engines.py``) without its jit program cache.  Three
protocols:

    per-op (sequential RL/RLB)  ``stage`` / ``factor`` / ``read_panel`` /
                                ``syrk_tail`` / ``syrk_block`` /
                                ``gemm_block`` / ``fetch`` / ``gather`` /
                                ``release``: one supernode at a time, every
                                transfer synchronous, as in the paper
    batched (mixed levels)      ``stage_batch`` / ``factor_batch`` /
                                ``read_panels_batch`` / ``syrk_tail_batch``
                                / ``release_batch``: one (level x bucket)
                                batch per call, host assembly
    device-resident (levels)    ``put`` / ``put_async`` / ``get``,
                                ``fused_group`` (guarded or not),
                                ``fused_group_many`` (M matrices of one
                                pattern), the three-dispatch oracle
                                ``gather_group`` / ``factor_group`` /
                                ``pack_group`` (``fused_groups=False``),
                                ``invert_diag``,
                                ``solve_fwd_level`` / ``solve_bwd_level``,
                                ``stage_rhs`` / ``unstage_rhs`` (a resident
                                right-hand side)

A staged supernode is its exact (rows, w) panel: where the reference pads
into a bucket for ``jit``, the port's kernels mask their ragged edges, so
the RLB block rows ``[w + k0, w + k1)`` are plain slices.  ``stats`` count
as the reference counts (one ``device_calls`` per factor, syrk_block and
gemm_block, and per syrk_tail only when not fused; one transfer per stage,
read and fetch), however many kernel launches a call makes; the bytes of a
staged panel are its own, not a bucket's.

Where the reference jits a program per bucket shape, the port runs eager
PyTorch around its kernels.  The reference donates the update pool and the
solve RHS to its programs; here both are updated in place.  That is safe
for the pool because a group's gather reads ``pool[src]`` only from entries
written by earlier levels, and its write ``[off, off + n_out)`` is disjoint
from them.

A fused group dispatch runs through the reference's fallback chain: the
CUDA kernels, then their plain PyTorch versions on the same device, then
the plain versions on host copies (on the CPU the chain starts at the
plain versions).  On a card only a fault plan's injected dispatch failure
steps down from the kernels; any other error of the CUDA tier is counted
as ``failed`` and raised, so a kernel's limit or fault is never served
by the plain versions.  Every step down is counted in ``fallbacks``,
logged as a ``fallback:<tier>`` event and added to the process-wide
``STEPS_DOWN``; a ``KernelBuildError`` is never absorbed.  A ``faults``
plan (``repro_torch.faults.FaultPlan``) hooks the uploads and the
dispatches for the chaos tests.

``device`` is explicit.  The default is ``"cuda"``, which raises when no card
is present; ``device="cpu"`` runs the kernels' plain PyTorch versions on the
host.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.buckets import bucket_shape
from repro_torch.faults import InjectedDispatchError
from repro_torch.kernels import ops
from repro_torch.kernels._build import KernelBuildError
from repro_torch.kernels.fused import (
    fused_factor_syrk,
    fused_factor_syrk_guarded_ref,
    fused_factor_syrk_ref,
)
from repro_torch.kernels.trsm import tri_inv_lower

#: process-wide steps down a tier of the group fallback chain, summed over
#: every engine (as each kernel wrapper counts its ``launches``): a run that
#: injects no fault must leave it at zero
STEPS_DOWN = {"plain": 0, "host": 0}


#: block length of ``ordered_cumsum``'s per-row scans
_SCAN = 1024


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, 1)`` of an (M, n) tensor, added up in the same
    order on every run.  On a card, ``torch.cumsum`` of one long row runs
    CUB's decoupled look-back scan, whose association order, and so its
    fp64 rounding, changes from run to run (a row of 10^6 entries differed
    in every one of 20 runs on an H100), which made two factorizations of
    ``lap3d_40`` differ by 4e-12.  Here each row is cut into blocks of
    ``_SCAN`` entries, which PyTorch scans as separate rows, in a fixed
    order, and the block totals are scanned the same way."""
    M, n = x.shape
    nb = -(-n // _SCAN)
    if nb <= 1:
        # one row alone would take the look-back scan: scan it as two rows
        return torch.cumsum(x, 1) if M > 1 else \
            torch.cumsum(x.expand(2, n), 1)[:1]
    blk = torch.nn.functional.pad(x, (0, nb * _SCAN - n))
    part = torch.cumsum(blk.reshape(M * nb, _SCAN), 1).reshape(M, nb, _SCAN)
    tot = ordered_cumsum(part[:, :, -1])
    part[:, 1:] += tot[:, :-1, None]
    return part.reshape(M, nb * _SCAN)[:, :n]


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point: ``"cuda"`` unless the caller asks
    for another; a CUDA request without a card raises instead of running on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host"
        )
    return dev


@dataclass
class Upload:
    """A host->device copy issued by ``put_async``: ``done`` is the event
    recorded on the copy stream (None on the CPU), ``host`` the pinned source
    kept alive until the copy has been waited on."""
    tensor: torch.Tensor
    done: object = None
    host: torch.Tensor | None = None


#: the index arrays and offsets of a group that ``_group_math`` reads
_GROUP_FIELDS = ("src", "lo", "hi", "gidx", "rows", "ws", "ppack", "upack",
                 "off", "lb")


def _group_math(many: bool, chunk, pool, g, guard: bool, thr: float,
                clamp: bool, plain: bool):
    """One group on the device its tensors lie on: slice the level chunk,
    apply the pending updates by the prefix-sum trick, factor (through the
    kernel wrapper, which runs the plain version for a CPU tensor, or with
    ``plain`` through the plain PyTorch versions directly), write the
    update entries into ``pool`` in place and return the packed factored
    cells (with ``guard`` also the per-lane status).  A single matrix runs
    as M = 1."""
    if not many:
        chunk, pool = chunk[None], pool[None]
    M = chunk.shape[0]
    Bp, Lp, Wp = g.gidx.shape
    n_out = int(g.upack.shape[0])
    pc = chunk[:, g.lb:g.lb + int(g.ppack.shape[0])]
    if g.src.shape[0]:
        vals = pool[:, g.src]  # (M, n_in), destination-sorted
        C = torch.cat([vals.new_zeros((M, 1)), ordered_cumsum(vals)], 1)
        pc = pc - (C[:, g.hi] - C[:, g.lo])
    ext = torch.cat([pc, pc.new_zeros((M, 1)), pc.new_ones((M, 1))], 1)
    buf = ext[:, g.gidx].reshape(M * Bp, Lp, Wp)
    rows, ws = (g.rows, g.ws) if M == 1 else (g.rows.repeat(M),
                                              g.ws.repeat(M))
    t = thr if clamp else 0.0
    if plain and guard:
        fp, u, st = fused_factor_syrk_guarded_ref(buf, rows, ws, t)
    elif plain:
        fp, u = fused_factor_syrk_ref(buf, rows, ws)
    elif guard:
        fp, u, st = fused_factor_syrk(buf, rows, ws, guard=True, thr=t)
    else:
        fp, u = fused_factor_syrk(buf, rows, ws)
    if n_out:
        pool[:, g.off:g.off + n_out] = u.reshape(M, -1)[:, g.upack]
    packed = fp.reshape(M, -1)[:, g.ppack]
    if not guard:
        return packed if many else packed[0]
    st = st.reshape(M, Bp, -1)
    return (packed, st) if many else (packed[0], st[0])


class _Handle:
    """A staged supernode: ``dev`` its (rows, w) panel on the device, ``u``
    the update matrix a fused factor left behind."""
    __slots__ = ("dev", "rows", "w", "u")

    def __init__(self, dev, rows: int, w: int):
        self.dev, self.rows, self.w, self.u = dev, rows, w, None


class _BatchHandle:
    """A staged batch of same-bucket panels: ``dev`` is (B, Lp, Wp) in the
    bucket layout (diagonal block rows [0, w), tail rows [Wp, Wp + rows -
    w)), ``u`` the (B, Lp - Wp, Lp - Wp) update matrices once factored."""
    __slots__ = ("dev", "rows", "ws", "Wp", "u")

    def __init__(self, dev, rows, ws, Wp):
        self.dev, self.rows, self.ws, self.Wp = dev, rows, ws, Wp
        self.u = None


class DeviceEngine:
    """Engine that runs the dense supernode math on one device.

    fused         the sequential path's ``factor`` runs POTRF + TRSM + SYRK
                  as one ``fused_factor_syrk`` call (beyond the paper, which
                  calls DPOTRF and DTRSM separately); False runs
                  ``ops.factor_panel`` (potrf + trsm_rlt) and leaves the
                  SYRK to ``syrk_tail``
    fused_groups  device-resident path: each (level x bucket) group is ONE
                  dispatch (gather + apply updates + factor + pack); False
                  keeps the reference's three-dispatch pipeline
                  (``gather_group`` / ``factor_group`` / ``pack_group``) as
                  the oracle
    events_cap    ring-buffer bound of ``events``
    stats         transfers_in/out, bytes_in/out and device_calls, counted
                  as the reference counts them
    events        ordered issue log of (tag, level) upload/dispatch events —
                  the evidence that level k+1's upload is issued before
                  level k is dispatched; reset at the start of every
                  factorization, and ``events_overflowed`` is set once the
                  ring buffer drops an event (the hazard audit then reports
                  INCONCLUSIVE)
    fallbacks     steps down the group fallback chain by tier, and groups
                  that failed (not in ``stats``, which callers compare
                  whole)
    scan_peak     the three-dispatch oracle's largest running total
                  ``max |C|`` of its prefix sums, a device scalar (None
                  before a group with pending updates): the scale of the
                  rounding by which two groupings of them differ
    faults        a ``repro_torch.faults.FaultPlan`` (None in production)
    """

    name = "device"

    def __init__(self, device=None, fused: bool = True,
                 fused_groups: bool = True, events_cap: int = 4096):
        self.device = resolve_device(device)
        self.fused = bool(fused)
        self.fused_groups = bool(fused_groups)
        self.stats = {"transfers_in": 0, "transfers_out": 0,
                      "bytes_in": 0, "bytes_out": 0, "device_calls": 0}
        self.events: deque = deque(maxlen=events_cap)
        self.events_overflowed = False
        self.faults = None
        self.fallbacks = {"plain": 0, "host": 0, "failed": 0}
        self.scan_peak = None
        self._copy_stream = None

    def _event(self, tag: str, lvl: int) -> None:
        if len(self.events) == self.events.maxlen:
            self.events_overflowed = True
        self.events.append((tag, lvl))

    def reset_events(self) -> None:
        """Start a fresh event log (top of each factorization)."""
        self.events.clear()
        self.events_overflowed = False

    # -- transfers ---------------------------------------------------------
    def _count_in(self, x: np.ndarray) -> None:
        self.stats["transfers_in"] += 1
        self.stats["bytes_in"] += x.nbytes

    def put(self, x: np.ndarray) -> torch.Tensor:
        """Host -> device transfer (counted), complete when it returns."""
        if self.faults is not None:
            x = self.faults.on_put(self, x)
        x = np.ascontiguousarray(x)
        self._count_in(x)
        # a copy on the CPU too: callers may write to what they staged
        return torch.from_numpy(x).to(self.device, copy=True)

    def put_async(self, x: np.ndarray) -> Upload:
        """Host -> device transfer (counted) that overlaps device work: on a
        card the array is copied into pinned memory and sent by a
        ``non_blocking`` copy on a side stream; ``wait`` orders the current
        stream after it.  On the CPU it is ``put``."""
        if self.device.type != "cuda":
            return Upload(self.put(x))
        if self.faults is not None:
            x = self.faults.on_put(self, x)
        x = np.ascontiguousarray(x)
        self._count_in(x)
        host = torch.from_numpy(x).pin_memory()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return Upload(dev, done, host)

    def wait(self, up: Upload) -> torch.Tensor:
        """The uploaded tensor, usable on the current stream."""
        if up.done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(up.done)
            up.tensor.record_stream(cur)
            up.done = None
        return up.tensor

    def get(self, x: torch.Tensor) -> np.ndarray:
        """Device -> host transfer (counted)."""
        out = x.cpu().numpy()
        self.stats["transfers_out"] += 1
        self.stats["bytes_out"] += out.nbytes
        return out

    fetch = get  # per-result transfer (RLB's per-block mode)

    def gather(self, xs) -> list:
        """Device -> host transfer of many results as ONE transfer (RLB's
        deferred mode): concatenated on the device, copied once, split."""
        xs = list(xs)
        flat = torch.cat([x.reshape(-1) for x in xs]).cpu().numpy()
        self.stats["transfers_out"] += 1
        self.stats["bytes_out"] += flat.nbytes
        out, pos = [], 0
        for x in xs:
            out.append(flat[pos:pos + x.numel()].reshape(x.shape))
            pos += x.numel()
        return out

    def flush(self) -> None:
        """Wait for all queued device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- per-op protocol (sequential RL / RLB) -----------------------------
    def stage(self, P: np.ndarray, w: int) -> _Handle:
        """Host -> device transfer of one supernode panel (rows, w)."""
        return _Handle(self.put(P), P.shape[0], w)

    def factor(self, h: _Handle) -> None:
        """POTRF + TRSM of a staged panel in place of ``h.dev``; with
        ``fused``, one ``fused_factor_syrk`` call that also leaves the
        update matrix for ``syrk_tail``."""
        self.stats["device_calls"] += 1
        if self.fused:
            ext = torch.tensor([[h.rows], [h.w]], dtype=torch.int32,
                               device=self.device)
            fp, u = fused_factor_syrk(h.dev[None], ext[0], ext[1])
            h.dev, h.u = fp[0], u[0]
        else:
            h.dev = ops.factor_panel(h.dev, h.w)

    def read_panel(self, h: _Handle) -> np.ndarray:
        """The factored panel back on the host (one synchronous transfer)."""
        return self.get(h.dev)

    def syrk_tail(self, h: _Handle) -> np.ndarray:
        """RL's update matrix ``tril(T T^T)`` of the tail ``T`` on the host:
        the one a fused factor left, else one ``syrk_ln`` call."""
        u = h.u
        if u is None:
            self.stats["device_calls"] += 1
            u = ops.syrk_ln(h.dev[h.w:])
        return self.get(u)

    def syrk_block(self, h: _Handle, k0: int, k1: int) -> torch.Tensor:
        """RLB: ``tril(B B^T)`` for tail rows ``[k0, k1)``, left on the
        device."""
        self.stats["device_calls"] += 1
        return ops.syrk_ln(h.dev[h.w + k0:h.w + k1])

    def gemm_block(self, h: _Handle, kr0: int, kr1: int, kc0: int,
                   kc1: int) -> torch.Tensor:
        """RLB: ``R C^T`` for tail rows ``R = [kr0, kr1)`` and ``C = [kc0,
        kc1)``, left on the device."""
        self.stats["device_calls"] += 1
        return ops.gemm_nt(h.dev[h.w + kr0:h.w + kr1],
                           h.dev[h.w + kc0:h.w + kc1])

    def release(self, h: _Handle) -> None:
        h.dev = None
        h.u = None

    # -- batched protocol (mixed host/device levels) -----------------------
    def stage_batch(self, Ps: list, ws: list) -> _BatchHandle:
        """Stack same-bucket panels into ONE (B, Lp, Wp) buffer in the
        reference's bucket layout and send it in one transfer.  The bucket
        (not the batch's own extents) sets Lp, so whether the update
        matrices are read back is decided as the reference decides it.  Pad
        cells stay zero: the fused kernel rebuilds the identity extension
        from the extents."""
        shapes = {bucket_shape(P.shape[0], w) for P, w in zip(Ps, ws)}
        if len(shapes) != 1:
            raise ValueError(f"stage_batch: mixed buckets {sorted(shapes)}")
        (Lp, Wp), = shapes
        buf = np.zeros((len(Ps), Lp, Wp))
        for i, (P, w) in enumerate(zip(Ps, ws)):
            buf[i, :w, :w] = P[:w]
            buf[i, Wp:Wp + P.shape[0] - w, :w] = P[w:]
        return _BatchHandle(self.put(buf), [P.shape[0] for P in Ps],
                            list(ws), Wp)

    def factor_batch(self, hb: _BatchHandle) -> None:
        """ONE ``fused_factor_syrk`` call over the batch."""
        self.stats["device_calls"] += 1
        ext = torch.tensor([hb.rows, hb.ws], dtype=torch.int32,
                           device=self.device)
        hb.dev, hb.u = fused_factor_syrk(hb.dev, ext[0], ext[1])

    def read_panels_batch(self, hb: _BatchHandle) -> list:
        """The factored panels back in one transfer, unpacked per lane."""
        dv = hb.dev.cpu().numpy()
        self.stats["transfers_out"] += 1
        outs = []
        for i, (rows, w) in enumerate(zip(hb.rows, hb.ws)):
            out = np.empty((rows, w))
            out[:w] = dv[i, :w, :w]
            out[w:] = dv[i, hb.Wp:hb.Wp + rows - w, :w]
            self.stats["bytes_out"] += out.nbytes
            outs.append(out)
        return outs

    def syrk_tail_batch(self, hb: _BatchHandle) -> list:
        """Each lane's (m, m) update matrix (``None`` without a tail), in
        one transfer; no transfer when the bucket has no tail rows
        (Lp == Wp)."""
        if hb.u is None or hb.u.shape[1] == 0:
            return [None] * len(hb.rows)
        uv = hb.u.cpu().numpy()
        self.stats["transfers_out"] += 1
        outs = []
        for i, (rows, w) in enumerate(zip(hb.rows, hb.ws)):
            m = rows - w
            if m == 0:
                outs.append(None)
                continue
            u = uv[i, :m, :m]
            self.stats["bytes_out"] += u.nbytes
            outs.append(u)
        return outs

    def release_batch(self, hb: _BatchHandle) -> None:
        hb.dev = None
        hb.u = None

    # -- device-resident factor: three dispatches (the oracle) -------------
    def gather_group(self, storage0: torch.Tensor, pool: torch.Tensor, g):
        """One group's stacked padded panel buffer (Bp, Lp, Wp), gathered
        from the whole staged storage with its pending updates applied by
        the prefix-sum trick.  Zero transfers."""
        self.stats["device_calls"] += 1
        pc = storage0[g.cells]
        if g.src.shape[0]:
            vals = pool[g.src]  # incoming update entries, destination-sorted
            C = torch.cat([vals.new_zeros(1), ordered_cumsum(vals[None])[0]])
            pc = pc - (C[g.hi] - C[g.lo])
            peak = C.abs().max()
            self.scan_peak = (peak if self.scan_peak is None
                              else torch.maximum(self.scan_peak, peak))
        ext = torch.cat([pc, pc.new_zeros(1), pc.new_ones(1)])
        return ext[g.gidx]

    def factor_group(self, buf: torch.Tensor, rows: torch.Tensor,
                     ws: torch.Tensor):
        """One ``fused_factor_syrk`` call over a stacked buffer with the
        group's true per-lane extents; returns ``(fp, u)``."""
        self.stats["device_calls"] += 1
        return fused_factor_syrk(buf, rows, ws)

    def pack_group(self, fp: torch.Tensor, u: torch.Tensor,
                   pool: torch.Tensor, g) -> torch.Tensor:
        """The group's packed factored cells; its update entries go into
        ``pool[off, off + n_out)`` in place.  Zero transfers."""
        self.stats["device_calls"] += 1
        n_out = int(g.upack.shape[0])
        if n_out:
            pool[g.off:g.off + n_out] = u.reshape(-1)[g.upack]
        return fp.reshape(-1)[g.ppack]

    # -- device-resident factor: one dispatch through the fallback chain ----
    def fused_group(self, chunk: torch.Tensor, pool: torch.Tensor, g,
                    lvl: int = -1, *, guard: bool = False, thr: float = 0.0,
                    clamp: bool = False):
        """Run one (level x bucket) group end to end as ONE dispatch: slice
        the level chunk, apply the pending updates by the prefix-sum trick,
        factor with the fused kernel, write the group's update entries into
        ``pool`` in place, and return the group's packed factored cells.

        ``guard`` runs the guarded kernel instead and returns ``(packed,
        st)`` with ``st`` the (Bp, 4) per-lane status; ``clamp`` clamps
        pivots at ``thr`` (without it the kernel only detects, thr = 0).
        A failure degrades through ``_run_group_chain``."""
        self.stats["device_calls"] += 1
        self._event("dispatch", lvl)
        return self._run_group_chain(False, chunk, pool, g, lvl, guard, thr,
                                     clamp)

    def fused_group_many(self, chunk: torch.Tensor, pool: torch.Tensor, g,
                         lvl: int = -1, *, guard: bool = False,
                         thr: float = 0.0, clamp: bool = False):
        """Multi-matrix ``fused_group``: M value streams (a leading matrix
        axis on ``chunk`` (M, clen) and ``pool`` (M, pool)) through one
        pattern's index arrays, factored as ONE kernel call of M*Bp lanes.
        Returns the (M, r) packed cells, with ``guard`` also the (M, Bp, 4)
        status."""
        self.stats["device_calls"] += 1
        self._event("dispatch", lvl)
        return self._run_group_chain(True, chunk, pool, g, lvl, guard, thr,
                                     clamp)

    def _group_tiers(self) -> list:
        """The fallback chain of a fused group: the CUDA kernels (on a
        card), their plain PyTorch versions on the same device, the plain
        versions on host copies.  Each tier runs at most once per group."""
        tiers = ["cuda"] if self.device.type == "cuda" else []
        return tiers + ["plain", "host"]

    def _run_group_chain(self, many: bool, chunk, pool, g, lvl: int,
                         guard: bool, thr: float, clamp: bool):
        """Dispatch one fused group through the fallback chain.

        The first tier runs the fault plan's ``on_dispatch`` hook, so an
        injected failure exercises the chain; a tier that raises is counted
        in ``fallbacks`` and ``STEPS_DOWN`` and logged as a
        ``fallback:<next tier>`` event.  The ``cuda`` tier steps down only
        for an ``InjectedDispatchError``: any other error there (a shape
        the wrapper refuses, an out-of-memory, a launch error) is counted
        in ``fallbacks["failed"]`` and propagates, since the plain versions
        would serve it about a thousand times slower.  A
        ``KernelBuildError`` propagates at once with nothing counted: a
        kernel that cannot be built is a broken installation, not a failed
        dispatch.  If every tier fails, ``fallbacks["failed"]`` counts it
        and the first error propagates.

        Running a group again after a tier failed is safe with the in-place
        pool: a group reads ``pool[src]`` only from entries that earlier
        levels wrote, and writes only its own ``[off, off + n_out)``, so a
        failed tier's partial write is overwritten and never read."""
        first_err = None
        for i, tier in enumerate(self._group_tiers()):
            if i > 0:
                self.fallbacks[tier] += 1
                STEPS_DOWN[tier] += 1
                self._event(f"fallback:{tier}", lvl)
            try:
                if i == 0 and self.faults is not None:
                    self.faults.on_dispatch(self, lvl)
                if tier == "host":
                    out = self._host_group(many, chunk, pool, g, guard, thr,
                                           clamp)
                else:
                    out = self._device_group(many, chunk, pool, g, guard,
                                             thr, clamp, plain=i > 0)
            except KernelBuildError:
                raise
            except Exception as e:  # noqa: BLE001 — counted, never silent
                if tier == "cuda" and not isinstance(e,
                                                     InjectedDispatchError):
                    self.fallbacks["failed"] += 1
                    raise
                if first_err is None:
                    first_err = e
                continue
            if self.faults is not None:
                out = self.faults.on_group_result(self, out, pool, lvl)
            return out
        self.fallbacks["failed"] += 1
        raise first_err

    def _device_group(self, many: bool, chunk, pool, g, guard: bool,
                      thr: float, clamp: bool, plain: bool):
        """The ``cuda`` tier, or with ``plain`` (a step down) the ``plain``
        tier: ``_group_math`` on the group's own device."""
        return _group_math(many, chunk, pool, g, guard, thr, clamp, plain)

    def _host_group(self, many: bool, chunk, pool, g, guard: bool,
                    thr: float, clamp: bool):
        """Last tier: ``_group_math`` through the plain versions on host
        copies of the chunk, the pool and the group's index arrays (one
        transfer out), the results and the pool sent back (one transfer
        in), as the reference's ``_host_fused_group`` counts them."""
        cpu = torch.device("cpu")
        ch, po = chunk.to(cpu, copy=True), pool.to(cpu, copy=True)
        fields = {k: getattr(g, k) for k in _GROUP_FIELDS}
        hg = SimpleNamespace(**{k: v.to(cpu) if torch.is_tensor(v) else v
                                for k, v in fields.items()})
        self.stats["transfers_out"] += 1
        self.stats["bytes_out"] += ch.nbytes + po.nbytes
        out = _group_math(many, ch, po, hg, guard, thr, clamp, plain=True)
        packed = out[0] if guard else out
        self.stats["transfers_in"] += 1
        self.stats["bytes_in"] += packed.nbytes + po.nbytes
        pool.copy_(po)
        if not guard:
            return packed.to(self.device)
        return packed.to(self.device), out[1].to(self.device)

    # -- resident right-hand sides ------------------------------------------
    def stage_rhs(self, b: torch.Tensor, iperm: torch.Tensor,
                  trash: torch.Tensor) -> torch.Tensor:
        """Permute a device-resident (M*n, k) right-hand side into the padded
        solve layout, one trash row per matrix (zero transfers; counted as a
        device call)."""
        self.stats["device_calls"] += 1
        y = b[iperm]
        y[trash] = 0.0
        return y

    def unstage_rhs(self, y: torch.Tensor, operm: torch.Tensor) -> torch.Tensor:
        """The padded solve layout back in natural row order, trash rows
        dropped (zero transfers; counted as a device call)."""
        self.stats["device_calls"] += 1
        return y[operm]

    # -- solve -------------------------------------------------------------
    def invert_diag(self, P: torch.Tensor) -> torch.Tensor:
        """Invert one group's stacked diagonal blocks (finalize time)."""
        self.stats["device_calls"] += 1
        Wp = P.shape[2]
        return tri_inv_lower(P[:, :Wp, :])

    # A level's groups are an antichain, so each level runs as one program
    # chaining its groups on y: per group one batched Dinv-GEMM for the
    # diagonal blocks and one batched GEMM for the tails.  ``y`` is (n+1,
    # nrhs) with a trash row at n that pad reads and writes hit; identity
    # extensions and zero pad rows keep its junk out of every real row, and
    # it is reset once per level to stay finite.
    def solve_fwd_level(self, y, trash, Ps, Dinvs, colss, tailss):
        """One forward-substitution level against the resident RHS (in
        place)."""
        self.stats["device_calls"] += 1
        nrhs = y.shape[1]
        for P, Dinv, cols, tails in zip(Ps, Dinvs, colss, tailss):
            Lp, Wp = P.shape[1], P.shape[2]
            z = Dinv @ y[cols]                        # (Bp, Wp, nrhs)
            y[cols.reshape(-1)] = z.reshape(-1, nrhs)
            if Lp > Wp:
                u = P[:, Wp:, :] @ z                  # (Bp, Lp-Wp, nrhs)
                # sibling lanes share ancestor rows: accumulate
                y.index_add_(0, tails.reshape(-1), u.reshape(-1, nrhs),
                             alpha=-1.0)
        y[trash] = 0.0
        return y

    def solve_bwd_level(self, y, trash, Ps, Dinvs, colss, tailss):
        """One backward-substitution level against the resident RHS (in
        place)."""
        self.stats["device_calls"] += 1
        nrhs = y.shape[1]
        for P, Dinv, cols, tails in zip(Ps, Dinvs, colss, tailss):
            Lp, Wp = P.shape[1], P.shape[2]
            r = y[cols]                               # (Bp, Wp, nrhs)
            if Lp > Wp:
                r = r - P[:, Wp:, :].mT @ y[tails]
            z = Dinv.mT @ r                           # (L^T)^{-1} = (L^{-1})^T
            y[cols.reshape(-1)] = z.reshape(-1, nrhs)
        y[trash] = 0.0
        return y

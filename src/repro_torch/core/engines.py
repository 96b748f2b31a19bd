"""Device engine of the device-resident level-scheduled path, in PyTorch.

The subset of ``src/repro/core/engines.py::DeviceEngine`` that the main path
runs: host<->device transfers (``put``/``put_async``/``get``), one fused
program per (level x bucket) group (``fused_group``), the finalize-time
inversion of each group's diagonal blocks (``invert_diag``), and one forward
and one backward substitution program per level (``solve_fwd_level`` /
``solve_bwd_level``).

Where the reference jits a program per bucket shape, the port runs eager
PyTorch around its kernels.  The reference donates the update pool and the
solve RHS to its programs; here both are updated in place.  That is safe
for the pool because a group's gather reads ``pool[src]`` only from entries
written by earlier levels, and its write ``[off, off + n_out)`` is disjoint
from them.  The engine has no fallback chain: a failed launch raises.

``device`` is explicit.  The default is ``"cuda"``, which raises when no card
is present; ``device="cpu"`` runs the kernels' plain PyTorch versions on the
host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.fused import fused_factor_syrk
from repro_torch.kernels.trsm import tri_inv_lower


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


class DeviceEngine:
    """Engine that runs the dense supernode math on one device.

    stats   transfers_in/out, bytes_in/out and device_calls, counted as the
            reference counts them
    events  ordered issue log of (tag, level) upload/dispatch events — the
            evidence that level k+1's upload is issued before level k is
            dispatched; reset at the start of every factorization
    """

    name = "device"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.stats = {"transfers_in": 0, "transfers_out": 0,
                      "bytes_in": 0, "bytes_out": 0, "device_calls": 0}
        self.events: list = []
        self._copy_stream = None

    def _event(self, tag: str, lvl: int) -> None:
        self.events.append((tag, lvl))

    def reset_events(self) -> None:
        """Start a fresh event log (top of each factorization)."""
        self.events.clear()

    # -- transfers ---------------------------------------------------------
    def _count_in(self, x: np.ndarray) -> None:
        self.stats["transfers_in"] += 1
        self.stats["bytes_in"] += x.nbytes

    def put(self, x: np.ndarray) -> torch.Tensor:
        """Host -> device transfer (counted), complete when it returns."""
        x = np.ascontiguousarray(x)
        self._count_in(x)
        return torch.from_numpy(x).to(self.device)

    def put_async(self, x: np.ndarray) -> Upload:
        """Host -> device transfer (counted) that overlaps device work: on a
        card the array is copied into pinned memory and sent by a
        ``non_blocking`` copy on a side stream; ``wait`` orders the current
        stream after it.  On the CPU it is ``put``."""
        if self.device.type != "cuda":
            return Upload(self.put(x))
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

    def flush(self) -> None:
        """Wait for all queued device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- factor ------------------------------------------------------------
    def fused_group(self, chunk: torch.Tensor, pool: torch.Tensor, g,
                    lvl: int = -1) -> torch.Tensor:
        """Run one (level x bucket) group end to end as ONE dispatch: slice
        the level chunk, apply the pending updates by the prefix-sum trick,
        factor with the fused kernel, write the group's update entries into
        ``pool`` in place, and return the group's packed factored cells."""
        self.stats["device_calls"] += 1
        self._event("dispatch", lvl)
        n_out = int(g.upack.shape[0])
        pc = chunk[g.lb:g.lb + int(g.ppack.shape[0])]
        if g.src.shape[0]:
            vals = pool[g.src]  # incoming update entries, destination-sorted
            C = torch.cat([vals.new_zeros(1), torch.cumsum(vals, 0)])
            pc = pc - (C[g.hi] - C[g.lo])
        ext = torch.cat([pc, pc.new_zeros(1), pc.new_ones(1)])
        fp, u = fused_factor_syrk(ext[g.gidx], g.rows, g.ws)  # (Bp, Lp, Wp)
        if n_out:
            pool[g.off:g.off + n_out] = u.reshape(-1)[g.upack]
        return fp.reshape(-1)[g.ppack]

    # -- solve -------------------------------------------------------------
    def invert_diag(self, P: torch.Tensor) -> torch.Tensor:
        """Invert one group's stacked diagonal blocks (finalize time)."""
        self.stats["device_calls"] += 1
        Wp = P.shape[2]
        return tri_inv_lower(P[:, :Wp, :].contiguous())

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

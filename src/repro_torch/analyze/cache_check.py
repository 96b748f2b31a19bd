"""Pass 4 — cache integrity: validate a saved CachedPlan before it factors
(port of ``src/repro/analyze/cache_check.py`` for the port's own file
format, ``plan_cache.FORMAT``).

A pickled plan file is the one plan-stack layer that crosses a trust
boundary: it may be stale (written by an older code version), truncated
(a killed writer — the atomic rename prevents this for our own writer, but
not for copies), corrupt (bit rot, bad transfer), or simply the wrong plan
for the matrix at hand.  ``CachedPlan.load`` rejects the first three via
the envelope (format name and version + blake2b payload digest) and the
last via ``expect_key``; this pass turns each rejection into a structured finding
and, for files that do load, runs the full plan lint over the deserialized
artifacts — a plan can be bit-intact yet semantically wrong if it was saved
by buggy analysis code.
"""
from __future__ import annotations

import hashlib
import pickle

from repro_torch.analyze.findings import Finding

_P = "cache"


def _err(code, loc, inv, detail=""):
    return Finding("error", _P, code, loc, inv, detail)


def check_plan_file(path, *, expect_key: str | None = None,
                    deep: bool = True):
    """Validate one saved plan file.  Returns ``(findings, plan_or_None)``;
    the plan is returned only when every integrity gate passes (deep lint
    findings do not withhold it — they carry their own severities)."""
    from repro_torch.core.plan_cache import FORMAT, FORMAT_VERSION, CachedPlan

    loc = str(path)
    try:
        with open(path, "rb") as f:
            envelope = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError) as e:
        return [_err("unreadable", loc,
                     "the plan file unpickles to an envelope",
                     f"{type(e).__name__}: {e}")], None
    if not isinstance(envelope, dict):
        return [_err("malformed", loc,
                     "the envelope is a dict with format/version/digest/"
                     "blob")], None
    findings: list = []
    fmt, version = envelope.get("format"), envelope.get("version")
    if fmt != FORMAT or version != FORMAT_VERSION:
        # a reference file carries no format name: stale for this package
        return [_err("format-version", loc,
                     "the file carries the current plan format and version",
                     f"file format {fmt!r} version {version!r}, want "
                     f"{FORMAT!r} version {FORMAT_VERSION} — stale cache; "
                     "rebuild the plan")], None
    blob = envelope.get("blob")
    if not isinstance(blob, bytes):
        return [_err("malformed", loc,
                     "the envelope carries the pickled payload blob")], None
    digest = hashlib.blake2b(blob, digest_size=16).hexdigest()
    if digest != envelope.get("digest"):
        return [_err("digest-mismatch", loc,
                     "the payload digest matches the envelope "
                     "(corrupt or tampered file otherwise)",
                     f"payload blake2b {digest}, envelope says "
                     f"{envelope.get('digest')!r}")], None
    try:
        plan = CachedPlan.load(path, expect_key=expect_key)
    except ValueError as e:
        code = ("fingerprint-mismatch" if "fingerprint" in str(e)
                else "payload-inconsistent")
        return [_err(code, loc,
                     "the plan matches the requested pattern fingerprint",
                     str(e))], None
    # structural cross-checks on the deserialized payload
    sym = plan.sym
    if plan.n != sym.n:
        findings.append(_err("payload-inconsistent", loc,
                             "plan.n matches the symbolic factor",
                             f"plan.n={plan.n}, sym.n={sym.n}"))
    if plan.fill_src.shape != plan.fill_dst.shape:
        findings.append(_err("payload-inconsistent", loc,
                             "fill_src and fill_dst align"))
    if deep and not findings:
        from repro_torch.analyze.plan_lint import lint_plan_stack

        warmed = sorted({k[2] for k in (sym.schedules or {})})
        findings += lint_plan_stack(
            sym, buckets=tuple(warmed),
            fill=(plan.fill_src, plan.fill_dst), nnz=plan.nnz,
        )
    return findings, plan

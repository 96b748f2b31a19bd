"""The port's kernel pass on the Hopper resource model, ``analyze_matrix``,
the ``python -m repro_torch.analyze`` CLI and the solver examples, on the
CPU, held to the reference's ``repro.analyze`` where the two share a
meaning (plan lint, hazards, waste accounting, the pass list)."""
import importlib.util
import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch import analyze as port
from repro_torch.analyze import __main__ as cli
from repro_torch.analyze import kernel_check as kc
from repro_torch.sparse import gen

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small ops, as in
    ``test_torch_train.py``: under the 6-worker test run each worker's
    thread pool spun at every op's barrier, and this file's tests took
    1.2-7x as long as with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(rep, passes=("plan-lint", "hazard")):
    return Counter((f.pass_name, f.code, f.severity) for f in rep.findings
                   if f.pass_name in passes)


@pytest.mark.parametrize("entry", cli.GENERATOR_SUITE, ids=lambda e: e[0])
def test_analyze_matrix_matches_reference(entry):
    ref = pytest.importorskip("repro.analyze")
    from repro.analyze.__main__ import GENERATOR_SUITE as REF_SUITE
    from repro.sparse import gen as ref_gen

    assert entry in REF_SUITE
    name, fn, kw = entry
    rep_r = ref.analyze_matrix(getattr(ref_gen, fn)(**kw), name=name)
    rep_p = port.analyze_matrix(getattr(gen, fn)(**kw), name=name)
    assert _counts(rep_p) == _counts(rep_r)
    assert not rep_p.errors
    for family in ("batch", "fused"):
        m_r = rep_r.metrics["families"][family]
        m_p = rep_p.metrics["families"][family]
        # the same schedule: the waste ratios bit for bit
        assert m_p["padded_waste"] == m_r["padded_waste"]
        assert m_p["masked_waste"] == m_r["masked_waste"]
        assert [(b["Lp"], b["Wp"]) for b in m_p["buckets"]] == \
            [(b["Lp"], b["Wp"]) for b in m_r["buckets"]]
        assert m_p["max_smem_kib"] * 1024 <= kc.HOPPER_SMEM_PER_BLOCK


def test_passes_equal_the_references():
    ref = pytest.importorskip("repro.analyze")
    assert port.PASSES == ref.PASSES
    assert "kernel" in port.PASSES
    names = set(ref.__all__) - {"REFERENCE_VMEM", "bucket_vmem"}
    assert names | {"HOPPER_SMEM_PER_BLOCK", "bucket_smem"} == \
        set(port.__all__)


def test_kernel_checks_flag_bad_buckets():
    (f,) = port.check_bucket(64, 128)
    assert (f.severity, f.code) == ("error", "bucket-shape")
    # every bucket's largest block is the guarded panel launch's
    est = port.bucket_smem(512, 256, Bp=4)
    assert est["smem_bytes"] == kc.PANEL_SMEM_G + kc.PANEL_STATIC
    fns = {x["function"] for x in est["launches"]}
    assert {"panel_kernel<false>", "trailing_kernel", "syrk_kernel"} <= fns
    capped = port.check_bucket(512, 256, smem_cap=100 * 1024)
    assert {x.code for x in capped} == {"smem-cap"}
    assert all(x.severity == "error" for x in capped)
    assert not port.check_bucket(512, 256)
    # a lane-major grid past gridDim.x
    (g,) = [x for x in port.check_bucket(1024, 64, Bp=2 ** 26)
            if x.code == "grid-x"]
    assert g.severity == "error" and "syrk_kernel" in g.location
    # the fused family keeps powers of two; elsewhere a ragged slab warns
    assert [x.code for x in port.check_bucket(200, 72, family="fused")
            if x.severity == "error"] == ["tile-alignment"]
    assert "ragged-slab" in {x.code for x in port.check_bucket(200, 72)}


def test_kernel_model_follows_the_launch_loop():
    # a group of 4 lanes of bucket (320, 192): three 64-column slabs
    est = {x["function"]: x for x in port.bucket_smem(320, 192, Bp=4)
           ["launches"]}
    assert est["panel_kernel<false>"]["blocks"] == 4 * 4   # 4 row tiles
    assert est["trailing_kernel"]["blocks"] == 4 * 2 * 4   # 4 x 2 tiles
    assert est["syrk_kernel"]["blocks"] == 2 * 2 * 4       # mp = 128
    assert est["guarded_slab_kernel"] == {
        "function": "guarded_slab_kernel", "threads": 512, "blocks": 4,
        "dynamic": 0, "static": kc.GUARD_STATIC, "smem": kc.GUARD_STATIC}
    # one wave of panel blocks caps a wide group: 2 per SM
    wide = {x["function"]: x for x in port.bucket_smem(1024, 64, Bp=256)
            ["launches"]}
    assert wide["panel_kernel<true>"]["blocks"] == 256
    assert sum(len(v) for v in kc.KERNEL_FUNCS.values()) == 19


def test_built_mismatches_reads_the_card_rows():
    # rows as _build.func_attrs reads them on the card
    rows = [dict(function=f, threads=t, dynamic=d, static=st,
                 max_threads=1024, regs=64)
            for f, t, d, st in kc.KERNEL_FUNCS["fused_factor_syrk"]]
    assert kc.built_mismatches("fused_factor_syrk", rows) == []
    rows[2] = dict(rows[2], static=4)      # the panel's int alone
    rows[5] = dict(rows[5], regs=300)      # 256 threads of 300 registers
    bad = kc.built_mismatches("fused_factor_syrk", rows)
    assert len(bad) == 2 and "panel_kernel<false>" in bad[0] \
        and "trailing_kernel" in bad[1]
    assert kc.built_mismatches("gemm_nt", rows[:1])


def test_cli_strict_exit_codes_and_json(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert cli.main(["--all-generators", "--strict", "--json",
                     str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["errors"] == 0
    assert len(rep["reports"]) == len(cli.GENERATOR_SUITE)
    passes = {f["pass_name"] for r in rep["reports"] for f in r["findings"]}
    assert passes <= set(port.PASSES)
    assert "kernel" in capsys.readouterr().out
    # a cap below the DMMA launches' 108 KiB: every such launch errs
    assert cli.main(["--matrix", "lap3d_8", "--family", "fused",
                     "--smem-cap", "100", "--strict"]) == 1
    assert "smem-cap" in capsys.readouterr().out
    # without --strict the errors are reported and do not gate
    assert cli.main(["--matrix", "lap3d_8", "--smem-cap", "100"]) == 0


def test_cli_trace_on_the_cpu(capsys):
    assert cli.main(["--matrix", "kkt_16", "--trace", "--device", "cpu",
                     "--strict"]) == 0
    assert "0 error(s)" in capsys.readouterr().out


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_pde_solve"])
def test_examples_run_small_on_the_cpu(name, capsys):
    _example(name).main(["--device", "cpu", "--grid", "8"])
    out = capsys.readouterr().out
    assert "resid" in out
    if name == "torch_pde_solve":
        assert out.rstrip().endswith("OK")
    else:
        assert "analyze: PASS" in out and "guard=perturb" in out


def test_card_entry_points_raise_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--matrix", "kkt_16", "--trace"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port.analyze_matrix(gen.laplacian_2d(6), trace_devices=("cuda",))
    for name in ("torch_quickstart", "torch_pde_solve"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(name).main(["--grid", "6"])

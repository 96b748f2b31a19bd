"""The port's ctypes bindings against its CUDA sources, on the CPU.

``kernels/_build.SIGNATURES`` gives ctypes the argument and result types of
every exported C function of ``kernels/csrc/*.cu``.  A wrong entry is not
caught by the compiler: ctypes then passes a pointer as a 32-bit int, or
a double as an int, and the kernel reads garbage on the card.  These tests
parse the ``extern "C"`` prototypes of the sources and hold each to its
entry, and check that the library name follows the shared headers, so an
edited header is rebuilt."""
import ctypes
import re
import shutil

import pytest

from repro_torch.kernels import _build

PROTO = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)',
                   re.S)
SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


def _kind_of_c(decl: str) -> str:
    """'pointer', 'int' or 'double' for one C parameter or return type."""
    decl = " ".join(decl.split())
    if "*" in decl:
        return "pointer"
    words = decl.replace("const ", "").split()
    if words[0] in ("int", "double"):
        return words[0]
    raise AssertionError(f"unexpected C type {decl!r}")


def _kind_of_ctypes(t) -> str:
    if t in (ctypes.c_void_p, ctypes.c_char_p):
        return "pointer"
    if t is ctypes.c_int:
        return "int"
    if t is ctypes.c_double:
        return "double"
    raise AssertionError(f"unexpected ctypes type {t!r}")


def prototypes(name: str) -> dict:
    """{function: (return kind, [parameter kinds])} of a source's extern "C"
    functions."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    out = {}
    for ret, fn, params in PROTO.findall(text):
        kinds = [_kind_of_c(p) for p in params.split(",") if p.strip()]
        out[fn] = (_kind_of_c(ret), kinds)
    return out


def test_every_source_has_a_binding():
    assert SOURCES == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("name", SOURCES)
def test_signatures_match_the_sources(name):
    protos = prototypes(name)
    sigs = _build.SIGNATURES[name]
    assert sorted(protos) == sorted(sigs)
    for fn, (argtypes, restype) in sigs.items():
        ret, kinds = protos[fn]
        assert [_kind_of_ctypes(t) for t in argtypes] == kinds, fn
        assert _kind_of_ctypes(restype) == ret, fn


@pytest.mark.parametrize("name", SOURCES)
def test_pointers_and_streams_are_full_width(name):
    # every launch takes its stream last, as a pointer-sized argument
    for fn, (argtypes, _) in _build.SIGNATURES[name].items():
        if fn.endswith("_launch"):
            assert argtypes[-1] is ctypes.c_void_p
            assert argtypes[-2] is ctypes.c_int   # the device index


def test_library_path_follows_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in SOURCES}
    header = csrc / "tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in SOURCES}
    assert all(before[n] != after[n] for n in SOURCES)
    src = csrc / "gemm_nt.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("gemm_nt") != after["gemm_nt"]
    assert _build.library_path("syrk_ln") == after["syrk_ln"]

"""The port's kernel library entry table against its CUDA sources, on the
CPU: every entry point that vkresample_tpu_torch/_build.py binds with
ctypes is defined by exactly one extern "C" function in one csrc/*.cu, every
extern "C" function is in the table, and each one's parameters match the
ctypes argument types it is called with.  A missing, duplicated or
mistyped entry would otherwise show only when nvcc links or a launch runs
on the card."""
import ctypes
import glob
import os
import re

import pytest

from vkresample_tpu_torch import _build

_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{')


def _definitions():
    """name -> [(file, [parameter declarations])] over csrc/*.cu and *.cuh."""
    found = {}
    paths = sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))
                   + glob.glob(os.path.join(_build.CSRC_DIR, "*.cuh")))
    for path in paths:
        with open(path) as f:
            src = re.sub(r"//[^\n]*", "", f.read())
        for name, params in _EXTERN.findall(src):
            decls = [" ".join(p.split()) for p in params.split(",")]
            found.setdefault(name, []).append((os.path.basename(path), decls))
    return found


def _ctype(decl: str):
    """The ctypes type a C parameter declaration is passed as."""
    stars = decl.count("*")
    if stars == 2:
        return ctypes.POINTER(ctypes.c_void_p)
    if stars == 1:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[decl.split()[0]]


DEFINITIONS = _definitions()


def test_every_extern_c_entry_is_bound():
    assert sorted(DEFINITIONS) == sorted(_build.ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_entry_defined_once_with_its_ctypes_signature(name):
    """One definition in one .cu file (never in a shared header), whose
    parameters are the table's argument types and the stream last."""
    defs = DEFINITIONS.get(name, [])
    assert len(defs) == 1, (name, [f for f, _ in defs])
    path, decls = defs[0]
    assert path.endswith(".cu")
    assert [_ctype(d) for d in decls] == _build.ENTRY_POINTS[name] + [ctypes.c_void_p], decls
    assert decls[-1].endswith("stream")


def test_retired_quad_and_woven_entries_live_in_the_redesigned_kernels():
    """K1 runs K4's U = 2 instance, K3 K5's kernel at u = 1 and K2 the same
    kernel at u = 2: their entry points are defined beside those kernels,
    and the first-design sources are gone.  K10c, the copy probe of that
    kernel's data movement, is its copy-only instance; K6 its instance on
    block-local bands with halo rows by pointer, and K3's column-halo entry
    the u = 1 kernel with halo columns by pointer."""
    assert DEFINITIONS["vkr_cas_quad_u2"][0][0] == "cas_grid.cu"
    for entry in ("vkr_cas_woven", "vkr_cas_parity_u2", "vkr_copy_quantize_rows",
                  "vkr_cas_blocked", "vkr_cas_woven_halo_cols"):
        assert DEFINITIONS[entry][0][0] == "cas_rows.cu", entry
    for retired in ("cas_quad.cu", "cas_woven.cu", "cas_parity.cu", "cas_blocked.cu"):
        assert not os.path.exists(os.path.join(_build.CSRC_DIR, retired)), retired

"""The kernel build's cache key and sources, without nvcc: a library is
named by a hash of its source, of every header in ``csrc/`` and of the
flags, so that an edited header rebuilds every library that may include
it, and only ``*.cu`` files are built."""

import re
import shutil

import pytest

from fiber_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads instead of the package's."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_sources_are_the_cu_files_alone(csrc):
    assert _build.sources() == ["dma_ring", "flash_bwd_dkv", "flash_bwd_dq",
                                "flash_fwd"]
    assert (csrc / "mma_sm90.cuh").is_file()


def test_header_edit_changes_every_library_name(csrc):
    names = _build.sources()
    before = {n: _build._lib_path(n) for n in names}
    assert before == {n: _build._lib_path(n) for n in names}   # stable
    header = csrc / "mma_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith(f"{n}-")
               for n, p in after.items())


def test_source_edit_changes_its_own_library_name(csrc):
    names = _build.sources()
    before = {n: _build._lib_path(n) for n in names}
    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    changed = {n for n in names if _build._lib_path(n) != before[n]}
    assert changed == {"flash_fwd"}


def test_every_quoted_include_is_a_header_of_csrc():
    """The headers a source includes sit in ``csrc/``, where the hash
    reads them; the three flash kernels, all on the tensor cores, share
    ``mma_sm90.cuh``."""
    includes = {}
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        includes[src.stem] = re.findall(r'#include "([^"]+)"',
                                        src.read_text())
        for name in includes[src.stem]:
            assert (_build.SRC_DIR / name).is_file() and name.endswith(
                ".cuh")
    assert "mma_sm90.cuh" in includes["flash_fwd"]
    assert "mma_sm90.cuh" in includes["flash_bwd_dq"]
    assert "mma_sm90.cuh" in includes["flash_bwd_dkv"]


@pytest.mark.parametrize("mangled, short", [
    ("_ZN69_GLOBAL__N__flash_fwd_cu_16flash_fwd_kernelIfLi32EEvPKT_S4_S4_"
     "PS2_Pfiiii7Stridesiiif", "flash_fwd_kernel<float,32>"),
    ("_ZN69_GLOBAL__N__flash_fwd_cu_16flash_fwd_kernelI13__nv_bfloat16"
     "Li64EEvPKT_S5_S5_PS3_Pfiiii7Stridesiiif",
     "flash_fwd_kernel<bfloat16,64>"),
    ("_Z20ring_exchange_kernelPKPKvPKPvPKxii", "ring_exchange_kernel"),
])
def test_ptxas_report_names_each_template(tmp_path, monkeypatch, mangled,
                                          short):
    """``ptxas_report`` reads the compiler's log of a build: one row per
    kernel template, with registers and spill bytes."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    (tmp_path / "lib.log").write_text(
        f"ptxas info    : Compiling entry function '{mangled}' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    assert _build.ptxas_report("lib") == [
        {"function": short, "registers": 168, "spill_stores": 8,
         "spill_loads": 4}]
    assert _build.ptxas_report("absent") == []

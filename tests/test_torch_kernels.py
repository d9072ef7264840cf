"""How ``heat_tpu_torch.kernels`` names and reports its libraries, on the CPU.

No ``nvcc`` is needed: these tests read what names a library and what the
build log says, on a copy of ``csrc/`` in a temporary directory.  A
library's name must change with anything it is built from -- its source,
every header in ``csrc/`` and its flags -- so that an edit never loads a
stale library, and stay the same when none of these changes.  The flash
library reports its tiles, and loading it checks them against the
wrapper's ``kernel_blocks``.
"""

import importlib
import shutil
from types import SimpleNamespace

import pytest
import torch

from heat_tpu_torch import kernels

fa = importlib.import_module("heat_tpu_torch.parallel.flash_attention")

SOURCES = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``kernels`` reads instead of the package's."""
    dst = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, dst)
    monkeypatch.setattr(kernels, "CSRC", dst)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return dst


def test_sources_and_header_are_there():
    assert SOURCES == ["blockquant", "flash_attention"]
    assert (kernels.CSRC / "hopper.cuh").exists()
    assert '#include "hopper.cuh"' in (kernels.CSRC / "flash_attention.cu").read_text()


@pytest.mark.parametrize("name", SOURCES)
def test_library_name_is_stable(csrc, name):
    first = kernels._target(name)
    assert kernels._target(name) == first
    assert first.parent == kernels.BUILD_DIR and first.name.startswith(f"lib{name}-")
    # a file that is neither a source nor a header does not count
    (csrc / "NOTES.txt").write_text("not built\n")
    assert kernels._target(name) == first


@pytest.mark.parametrize("name", SOURCES)
def test_library_name_follows_an_edited_header(csrc, name):
    before = kernels._target(name)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// one more line\n")
    assert kernels._target(name) != before


@pytest.mark.parametrize("name", SOURCES)
def test_library_name_follows_a_new_or_renamed_header(csrc, name):
    before = kernels._target(name)
    extra = csrc / "extra.cuh"
    extra.write_text("#pragma once\n")
    added = kernels._target(name)
    assert added != before
    extra.rename(csrc / "other.cuh")
    assert kernels._target(name) not in (before, added)


@pytest.mark.parametrize("name", SOURCES)
def test_library_name_follows_source_and_flags(csrc, name, monkeypatch):
    before = kernels._target(name)
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n")
    edited = kernels._target(name)
    assert edited != before
    flags = dict(kernels._SOURCE_FLAGS)
    flags[name] = flags.get(name, ()) + ("-lineinfo",)
    monkeypatch.setattr(kernels, "_SOURCE_FLAGS", flags)
    assert kernels._target(name) not in (before, edited)


def test_ptxas_report_reads_the_build_log(csrc):
    log = kernels._target("flash_attention").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z5firstv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z5firstv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 640 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z6secondv' for 'sm_90a'\n"
        "ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count\n"
        "ptxas info    : Function properties for _Z6secondv\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 2 barriers\n"
    )
    first, second = kernels.ptxas_report("flash_attention")
    assert first == {"entry": "_Z5firstv", "registers": 168, "spill_stores": 0,
                     "spill_loads": 0, "warnings": []}
    assert (second["registers"], second["spill_stores"], second["spill_loads"]) == (255, 12, 16)
    assert len(second["warnings"]) == 1 and "C7508" in second["warnings"][0]
    assert kernels.ptxas_report("blockquant") == []  # no log: nothing built yet


class _FakeFlashLib:
    """Stands in for the flash library's C interface: ``flash_attention_tiles``
    writes ``tiles[dtype code]`` through its two pointers."""

    def __init__(self, tiles):
        def report(code, bq, bk):
            bq._obj.value, bk._obj.value = tiles[code]
            return 0

        self.flash_attention_launch = SimpleNamespace()
        self.flash_attention_tiles = report


def test_flash_library_tiles_are_checked_when_declared():
    tiles = {code: fa.kernel_blocks(dt) for dt, code in fa._DTYPE_CODE.items()}
    lib = _FakeFlashLib(tiles)
    assert fa._declare(lib) is lib
    assert lib.flash_attention_launch.restype is not None
    tiles[fa._DTYPE_CODE[torch.float32]] = (128, 128)
    with pytest.raises(RuntimeError, match="differ from kernel_blocks"):
        fa._declare(_FakeFlashLib(tiles))

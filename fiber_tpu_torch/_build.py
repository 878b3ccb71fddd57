"""Builds the port's CUDA kernels from the sources in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Libraries go into ``_build/`` beside this file, named by a
hash of the source, every header in ``csrc/`` (``*.cuh``, which a
source may include) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. Nothing is built at
import time: the first call of a kernel builds it, and
:func:`build_all` builds every source at once (one ``nvcc`` process per
source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict = {}


def sources() -> list:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's standard location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are compiled from csrc/ at first use")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    The compiler's report (registers, shared memory, spills) is kept in
    ``_build/<name>.log``. Raises with the compiler's output on failure."""
    src = SRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    out = _lib_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> dict:
    """Build every source in parallel; returns ``{name: library path}``."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def ptxas_report(name: str, build_dir=None) -> list:
    """What ptxas said of each kernel in the last build of ``name`` (in
    ``build_dir``, by default ``BUILD_DIR``): one ``{"function",
    "registers", "spill_stores", "spill_loads"}`` per kernel (bytes of
    spills), with a template kernel named as
    ``flash_bwd_dkv_kernel<float,32>``. Empty if ``name`` was not built."""
    log = Path(build_dir or BUILD_DIR) / f"{name}.log"
    if not log.is_file():
        return []
    rows, row = [], None
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            row = {"function": _short_name(entry.group(1))}
            rows.append(row)
        elif row is not None and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            row.update(spill_stores=int(stores), spill_loads=int(loads))
        elif row is not None and "registers" in line:
            row["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return rows


def _short_name(mangled: str) -> str:
    """``..._kernelIfLi32EE...`` -> ``..._kernel<float,32>``: the kernel's
    name and template arguments (element type ``float``, ``bfloat16`` or
    ``float16``, padded head_dim)."""
    m = re.search(r"([a-z_]+_kernel)I(f|13__nv_bfloat16|6__half)Li(\d+)E",
                  mangled)
    if m:
        kind = {"f": "float", "13__nv_bfloat16": "bfloat16",
                "6__half": "float16"}[m.group(2)]
        return f"{m.group(1)}<{kind},{m.group(3)}>"
    m = re.search(r"([a-z_]+_kernel)", mangled)
    return m.group(1) if m else mangled


def sass_counts(name: str, *opcodes: str):
    """How many SASS instructions of the built library of ``name`` start
    with each of ``opcodes`` (e.g. ``HMMA``, the tensor cores' warp-level
    product, and ``HGMMA``, the warpgroup-level one), from one
    disassembly by the toolkit's ``cuobjdump``: ``{opcode: count}``, or
    None where the toolkit has none."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    proc = subprocess.run([str(tool), "-sass", str(build(name))],
                          capture_output=True, text=True, check=True)
    # an instruction line reads "/*0a40*/  HMMA.16816.F32.BF16 R4, ... ;"
    ops = [line.split("*/", 1)[-1].strip()
           for line in proc.stdout.splitlines()]
    return {op: sum(1 for x in ops if x.startswith(op)) for op in opcodes}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib

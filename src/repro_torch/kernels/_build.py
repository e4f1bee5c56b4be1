"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries land in ``src/repro_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  :func:`build` starts one
``nvcc`` per missing library, all at once; the first call of a kernel's
wrapper builds its library if :func:`build` has not run.

Flags: ``sm_90a`` (Hopper), ``-O3``, and neither ``--use_fast_math`` nor
FMA contraction, so ``expf``/``logf`` and every float op round as the plain
PyTorch versions' separate ops do.

Every C entry point takes the stream last and returns
``cudaGetLastError()`` after its launch.  Wrappers launch only through
:func:`launch`, which makes the tensors' device the current one around the
C call (so the launch, its stream and any host-side setup of the entry go
to that device, not to whichever device was current), then
:func:`check` raises on a non-zero code.  :data:`LAUNCHES` counts, per
wrapper, the launches it made, and per kernel where a wrapper chooses
between two (``"flash_attention:bf16_tc"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: the ops wrappers, each with its launch count and a source of its name
KERNELS = ("dual_solve", "merge", "point_read", "flash_attention", "rwkv6",
           "bloom_probe")
#: every ``csrc/<name>.cu``; ``flash_attention`` launches
#: ``flash_attention`` (float32) or ``flash_attention_wgmma`` (bfloat16),
#: ``rwkv6`` launches ``rwkv6`` (float32) or ``rwkv6_mma`` (bfloat16)
SOURCES = KERNELS + ("flash_attention_wgmma", "rwkv6_mma")
#: per-kernel counts of a wrapper that dispatches between two kernels
VARIANTS = ("flash_attention:bf16_tc", "flash_attention:f32_cuda_core",
            "rwkv6:bf16_tc", "rwkv6:f32_cuda_core")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: launches per kernel, counted by each ops.py wrapper where it launches
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS + VARIANTS, 0)

_FNS: Dict[tuple, ctypes._CFuncPtr] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def _target(name: str) -> tuple:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library not built yet, one ``nvcc`` per source, all
    started together.  Returns ``{name: nvcc/ptxas report}`` for the ones
    it compiled; raises with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    try:
        for name in names:
            src, out = _target(name)
            if out.exists():
                continue
            nvcc = nvcc or nvcc_path()
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out)
        reports = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            reports[name] = log
        return reports
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        _, out = _target(name)
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def kernel_fn(name: str, symbol: str, argtypes: Sequence):
    """The C entry ``symbol`` of kernel ``name``'s library, typed."""
    key = (name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def library_int(name: str, symbol: str) -> int:
    """The ``int`` constant ``symbol`` that kernel ``name``'s library
    exports (a size its wrapper must know to allocate for the entry)."""
    return ctypes.c_int.in_dll(_library(name), symbol).value


def check(name: str, rc: int, variant: str = "") -> None:
    """Raise if a launch returned a CUDA error; count it otherwise."""
    if rc != 0:
        msg = _library(name).kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    LAUNCHES[name] += 1
    if variant:
        LAUNCHES[f"{name}:{variant}"] += 1


def launch(name: str, fn, *args, device, variant: str = "") -> None:
    """Call the C entry ``fn(*args, stream)`` with ``device`` current and
    PyTorch's current stream on it, then :func:`check` (and count) the
    launch of wrapper ``name`` (and of its kernel ``variant``)."""
    import torch
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(name, rc, variant)


P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float

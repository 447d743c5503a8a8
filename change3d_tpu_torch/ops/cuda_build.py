"""Build and load the port's native libraries: the CUDA kernels (nvcc into
a shared library with a plain C interface) and the host METEOR scorer (the
host C++ compiler), both bound with ctypes.

Each ``csrc/*.cu`` compiles on its own for ``sm_90a`` into
``change3d_tpu_torch/_build/<name>-<source hash>.so`` at first use; the hash
covers the source and every ``csrc/*.cuh`` header, and a library whose hash
is unchanged is reused. Each ``csrc/*.cpp`` (host code: ``meteor.cpp``)
compiles the same way with ``$CXX`` (default ``c++``) and ``CXX_FLAGS``,
never with nvcc. Build and load failures raise: there is no fallback.

``build`` and ``load`` are safe under threads: one lock serialises first
use within the process, so two threads that reach a kernel together build
it once and share one handle. Each build writes to a temporary name of its
own (process and thread id), renamed into place, so processes that build
together never see half a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_char_p
_D = ctypes.c_double
# C signatures of every exported function, by library name.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "fused_block": {
        # ..., then the design, the xa pass's output (or null) and the stream
        "c3d_fused_block_fwd": (
            [_I] + [_VP] * 12 + [_I] * 11 + [_VP] * 2, _I,
        ),
        "c3d_fused_block_se_sums": (
            [_I] + [_VP] * 8 + [_I] * 11 + [_VP] * 2, _I,
        ),
        # x, xa, w_a, a_a, b_a, B, T, H, W, C, Ci, shared-memory bytes, stream
        "c3d_fused_block_xa": ([_VP] * 5 + [_I] * 7 + [_VP], _I),
        "c3d_fused_block_blocks_per_sm": ([_I] * 10, _I),
        "c3d_error_string": ([_I], ctypes.c_char_p),
    },
    "depthwise_conv3d": {
        # dtype, x, w, out, B, T, H, W, C, kt, kh, kw, st, sh, sw, pt, ph, pw,
        # then plan_depthwise's vec, tt, oh, ow, cc and shared-memory bytes
        "c3d_depthwise_conv3d": ([_I] + [_VP] * 3 + [_I] * 20 + [_VP], _I),
        "c3d_error_string": ([_I], ctypes.c_char_p),
    },
    "repros": {
        "c3d_dot_1d": ([_VP] * 3 + [_I] * 3 + [_VP], _I),
        # x, out, N, R, C, then manual_dma_plan's chunk, per_slab, per_block, grid
        "c3d_manual_dma": ([_VP] * 2 + [_I] * 7 + [_VP], _I),
        "c3d_error_string": ([_I], ctypes.c_char_p),
    },
    "meteor": {  # host code (csrc/meteor.cpp)
        "meteor_abi_version": ([], _I),
        # hypothesis, newline-joined references, alpha, beta, gamma
        "meteor_sentence": ([_S, _S, _D, _D, _D], _D),
        # ..., delta, stem weight, out[7]
        "meteor_segment_stats": ([_S, _S] + [_D] * 5 + [ctypes.POINTER(_D)], None),
        "meteor_set_paraphrase_table": ([_S], _I),
        "meteor_set_synonym_table": ([_S], _I),
        "meteor_set_function_words": ([_S], _I),
        "meteor_stem": ([_S, _S, _I], _I),
    },
}


_LOCK = threading.RLock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA kernels cannot be built")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA source) or ``csrc/<name>.cpp`` (host code)."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and, for a CUDA
    source, of every header in csrc/ (it may include any of them)."""
    src = source_path(name)
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")) if src.suffix == ".cu" else ():
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(cmd) -> subprocess.Popen:
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot start {cmd[0]} on {cmd[-1]}: {e}") from e


def _start_nvcc(name: str, out: Path) -> subprocess.Popen:
    """Start nvcc on ``csrc/<name>.cu`` writing ``out``; stdout carries its
    report and errors."""
    return _start([nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")])


def _start_cxx(name: str, out: Path) -> subprocess.Popen:
    """Start the host C++ compiler ($CXX, default c++) on
    ``csrc/<name>.cpp`` writing ``out``."""
    return _start([os.environ.get("CXX") or "c++", *CXX_FLAGS, "-o", str(out),
                   str(CSRC_DIR / f"{name}.cpp")])


def build(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named source that has no current library, one compiler
    per source, all started together. Returns each source's report (ptxas's
    registers, shared memory and spills for a CUDA source); raises with the
    compiler's output on failure."""
    with _LOCK:
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        start = _start_nvcc if source_path(name).suffix == ".cu" else _start_cxx
        procs[name] = (start(name, tmp), tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{source_path(name).name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("native library build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed, with every exported
    function's argument and result types declared; one handle per process."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LOADED:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _LOADED[name] = lib
        return _LOADED[name]


def aligned(t: "torch.Tensor") -> "torch.Tensor":
    """t, contiguous, at a 16-byte aligned address (the kernels' 16-byte
    loads and stores need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (refused launches never run,
    and a later synchronize would not report them)."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.c3d_error_string(err).decode()})")

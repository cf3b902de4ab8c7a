"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file compiles to an object (all ``nvcc`` processes run
at once), and the objects link into ONE shared library with a plain C
interface.  The library lands in ``kernels/_build/`` (listed in
``.gitignore``) under a name derived from the sources and flags, so an
edited source never loads a stale build.  Nothing is built at import time:
the first kernel launch calls `library()`.

``torch.utils.cpp_extension.load`` is not used: including PyTorch's
headers makes a build take minutes, where ``nvcc`` on a plain C interface
takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)   # a host array of device pointers
_PI = ctypes.POINTER(ctypes.c_int)      # a host array of ints
# C signature of every kernel entry point: argtypes must be declared, or
# ctypes passes each pointer as a 32-bit int and cuts it.
SIGNATURES = {
    "repro_decode_attention_bf16":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "repro_flash_attention_bf16":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "repro_fused_lookup_f32":
        [_PP, _PI, _PI, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_fused_lookup_q8":
        [_PP, _PP, _PI, _PI, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_embedding_lookup_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_embedding_scatter_f32": [_P, _P, _P, _L, _I, _I, _P],
    "repro_embedding_gather_f32": [_P, _P, _P, _L, _I, _I, _P],
    "repro_fused_scatter_keys": [_PI, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_fused_scatter_f32":
        [_PP, _PI, _PI, _I, _P, _P, _L, _P, _P, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log: str = ""                     # nvcc's messages (ptxas -v included)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``.  Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of repro_torch are built at first launch")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one ``.so``;
    returns its path.  Reuses an existing library built from the same
    sources and flags.  ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel) to `build_log`."""
    global build_seconds, build_log
    # -Xptxas -v only adds messages, so it stays out of the digest
    out = BUILD_DIR / f"libreprotorch_{_digest(NVCC_FLAGS)}.so"
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [exe, *flags, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for cmd, obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(text)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = Path(tmp) / out.name
        link = [exe, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
                *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed: {' '.join(link)}\n"
                               f"{res.stdout}")
        os.replace(lib_tmp, out)   # atomic: a reader never sees half a file
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use.  Raises if the build
    or the load fails; there is no fallback."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point
    (its ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_tensor(name, t, dtype, ndim, align=16):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``ndim`` dims whose data is ``align``-byte aligned (what the kernels
    take before a pointer crosses into C)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")

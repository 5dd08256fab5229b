"""Build the package's CUDA kernels and bind them with ctypes.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package (and
nothing else) for ``sm_90a`` into one shared library with a plain C
interface, under ``build/torch_kernels/`` beside the package. The library's
name carries a hash of its sources and flags, so an edit forces a rebuild
and an unchanged tree reuses the build. There is no fallback: a missing
``nvcc`` or a failed build raises.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on
a non-zero code.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name → argtypes of every C entry point (all return a cudaError_t as int).
_SIGNATURES = {
    # x, w_in, b_in, w_hid, b_hid, w_out, b_out, y, n, d, h, l, o, act, stream
    "mlp_forward": [_P] * 8 + [_I] * 6 + [_P],
    # B, H, L
    "heat_scratch_floats": [_I] * 3,
    # p, u, scratch, grad, loss, B, H, L, x_max, t_max, kappa, stream
    "heat_grad": [_P] * 5 + [_I] * 3 + [_F] * 3 + [_P],
    # p, m, v, u, scratch, losses, K, B, H, L, x_max, t_max, kappa, lr,
    # step0, stream
    "heat_train": [_P] * 6 + [_I] * 4 + [_F] * 4 + [_I, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdednn_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a build of the same sources exists.
    Returns the library path; the compiler's report is kept beside it."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_f32(name: str, t, shape=None) -> None:
    """The checks every wrapper makes before handing a pointer to C."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 (got {t.dtype})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")

"""Build the package's CUDA kernels and bind them with ctypes.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package (and
nothing else) for ``sm_90a``, one compiler per source in parallel, and links
them into one shared library with a plain C interface, under
``build/torch_kernels/`` beside the package. The library's
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_CONSTS = ctypes.POINTER(ctypes.c_float)
# name → argtypes of every C entry point (all return a cudaError_t as int,
# except the scratch sizes).
_SIGNATURES = {
    # x, w_in, b_in, w_hid, b_hid, w_out, b_out, y, n, d, h, l, o, act, stream
    "mlp_forward": [_P] * 8 + [_I] * 6 + [_P],
    # n, d, h, o, out[5]: rows per CTA tile, threads per CTA, ring depth,
    # shared memory bytes, CTAs per cluster
    "mlp_forward_plan": [_I] * 4 + [_P],
    # xt, x0, xb1, xb2, w_in, b_in, w_hid, b_hid, w_out, b_out, out, trials,
    # n, h, l, o, act, stream
    "heat_streams": [_P] * 11 + [_I] * 6 + [_P],
    # h, o, out[6]: cluster size, points per cluster, k-tile, threads,
    # ring depth, shared memory bytes
    "heat_streams_plan": [_I] * 2 + [_P],
    # B, H, L
    "heat_scratch_floats": [_I] * 3,
    "heat_train_smem_bytes": [],
    "heat_args_bytes": [],
    # p, u, scratch, grad, loss, B, H, L, x_max, t_max, kappa, bf16, stream
    # (bf16: 1 for the "default" precision's instances, 0 for "highest")
    "heat_grad": [_P] * 5 + [_I] * 3 + [_F] * 3 + [_I, _P],
    # B, H, L, x_max, t_max, kappa, bf16, S, args, scratch, exec (out)
    "heat_graph_build": [_I] * 3 + [_F] * 3 + [_I, _I, _P, _P,
                                               ctypes.POINTER(ctypes.c_void_p)],
    # exec
    "heat_graph_free": [_P],
    # p, m, v, u, scratch, losses, K, B, H, L, x_max, t_max, kappa, lr,
    # step0, bf16, stream, args, exec, S, side0, side1
    "heat_train": [_P] * 6 + [_I] * 4 + [_F] * 4 + [_I, _I, _P, _P, _P, _I,
                                                     _P, _P],
    # spec, B, H, L, F (folded groups)
    "engine_scratch_floats": [_I] * 5,
    # spec, H
    "engine_smem_bytes": [_I] * 2,
    "engine_args_bytes": [],
    # spec, consts, const, p, u, scratch, grad, loss, args, B, H, L, F,
    # bf16, stream
    "engine_grad": [_I, _CONSTS] + [_P] * 7 + [_I] * 5 + [_P],
    # spec, consts, B, H, L, F, N, bf16, S, sweep, args, scratch, exec (out)
    "engine_graph_build": [_I, _CONSTS] + [_I] * 8
                          + [_P, _P, ctypes.POINTER(ctypes.c_void_p)],
    # exec
    "engine_graph_free": [_P],
    # spec, consts, const, p, m, v, u, scratch, losses, args, exec, S, N, K,
    # B, H, L, F, bf16, lr, step0, schedule, horizon, decay, half_span,
    # log_decay, lr_vec, bs_vec, steps_vec, trial_horizon, step_math_runs,
    # stream, side0, side1 (the three vectors: device pointers or None)
    "engine_train_packed": [_I, _CONSTS] + [_P] * 9 + [_I] * 8
                           + [_F, _I, _I] + [_F] * 4 + [_P] * 3 + [_I]
                           + [ctypes.POINTER(_I), _P, _P, _P],
    # kind, B, H, launches, params, scratch, args, stream
    "engine_probe": [_I] * 4 + [_P] * 4,
    # R, B, H, L, O
    "dgm_scratch_floats": [_I] * 5,
    "dgm_max_streams": [],
    "dgm_args_bytes": [],
    # spec, consts, const, p, u, scratch, grad, loss, args, R, B, H, L, O,
    # act, value_mask, bf16, stream
    "dgm_grad": [_I, _CONSTS] + [_P] * 7 + [_I] * 6 + [_U, _I, _P],
    # spec, R, B, H, L, O, act, value_mask, N, bf16, S, sweep, args,
    # scratch, exec (out)
    "dgm_graph_build": [_I] * 7 + [_U, _I, _I, _I, _I, _P, _P,
                                   ctypes.POINTER(ctypes.c_void_p)],
    # exec
    "dgm_graph_free": [_P],
    # spec, consts, const, p, m, v, u, scratch, losses, args, exec, S, N, K,
    # R, B, H, L, O, act, value_mask, bf16, lr, step0, schedule, horizon,
    # decay, half_span, log_decay, lr_vec, bs_vec, steps_vec, trial_horizon,
    # step_math_runs, stream, side0, side1
    "dgm_train_packed": [_I, _CONSTS] + [_P] * 9 + [_I] * 9
                        + [_U, _I, _F, _I, _I] + [_F] * 4 + [_P] * 3 + [_I]
                        + [ctypes.POINTER(_I), _P, _P, _P],
    # trans, A, W, C, args, rows, K, M, replicas, ss, launches, stream
    "dgm_gemm_probe": [_I] + [_P] * 4 + [_I] * 4
                      + [ctypes.c_longlong, _I, _P],
    # nodes, blocks, threads, reps, out[2]
    "probe_graph_gap": [_I] * 4 + [_P],
    # blocks, threads, syncs, out[2]
    "probe_grid_sync": [_I] * 3 + [_P],
    # cluster size, clusters, syncs, out[2]
    "probe_cluster_sync": [_I] * 3 + [_P],
}
_RESTYPES = {"heat_scratch_floats": ctypes.c_longlong,
             "heat_train_smem_bytes": ctypes.c_longlong,
             "engine_scratch_floats": ctypes.c_longlong,
             "engine_smem_bytes": ctypes.c_longlong,
             "dgm_scratch_floats": ctypes.c_longlong}


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
    """Compile the kernels unless a build of the same sources exists: one
    nvcc per source, all started together, then one link. Returns the
    library path; the compilers' reports are kept beside it."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report, failed = [], []
        for cmd, obj, proc in jobs:  # waits for every compiler
            out = proc.communicate()[0]
            report.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out[-4000:]}")
        so = os.path.join(tmp, lib.name)
        if not failed:
            cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", so,
                   *(obj for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            report.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        lib.with_suffix(".log").write_text("\n".join(report))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(so, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is
    no GPU (the CPU runs only when a caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the GPU (pass device='cpu' to run the plain "
                           "PyTorch versions)")
    return device


def sync(device) -> None:
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of the package (with the
headers beside them) for ``sm_90a``, one process per source, all started
together, and links the objects into one shared library with a plain C
interface, ``build/cudabulletproof_tpu_torch/libbp_kernels-<hash>.so`` at the
root of the checkout, which ``ctypes`` loads.  The hash covers the sources
and the flags, so an edited kernel is rebuilt and a stale library is never
loaded.  ptxas' per-kernel report (registers, spills) is kept beside the
library as ``.log``.

Not ``torch.utils.cpp_extension.load``: a source that includes PyTorch's
headers takes minutes to compile, a plain C interface seconds.

``load`` binds every entry once and refuses a library whose
``bp_abi_version()`` is not ``ABI`` (one built from sources whose C entries
take other arguments: calling it would pass the wrong pointers).
``launch`` is the one call path of every wrapper: it takes PyTorch's
current raw stream and enters the operand's device only when it is not the
current one.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cudabulletproof_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_N = ctypes.c_int64
# C entry points: name -> argument types.  Every pointer and the stream are
# c_void_p (ctypes would otherwise pass a Python int as a 32-bit int and cut
# the pointer); every count is c_int64.  Each returns cudaGetLastError().
ABI = 7                # bp_abi_version() of the sources below
SIGNATURES = {
    # a, row stride of a, b, row stride of b, out, n, stream
    "bp_fe_mul": [_P, _N, _P, _N, _P, _N, _P],
    "bp_fe_sq": [_P, _N, _P, _N, _P],           # a, row stride, out, n, stream
    "bp_fe_pow2523": [_P, _P, _N, _N, _P],      # a, out, n, lanes, stream
    # p's x, y, z, t pointers and their row strides, q's, out, n, stream
    "bp_ge_add": [*[_P] * 4, *[_N] * 4, *[_P] * 4, *[_N] * 4, _P, _N, _P],
    # p's x, y, z, t pointers and their row strides, out, n, stream
    "bp_ge_double": [*[_P] * 4, *[_N] * 4, _P, _N, _P],
    "bp_ge_ladder_win": [_P, _P, _P, _N, _P],   # p, s, out, n, stream
    "bp_ge_ladder_bin": [_P, _P, _P, _N, _P],   # p, s, out, n, stream
    "bp_fe_invert": [_P, _P, _N, _N, _P],       # a, out, n, lanes, stream
    "bp_fe_add": [_P, _P, _P, _N, _P],          # a, b, out, n, stream
    "bp_fe_sub": [_P, _P, _P, _N, _P],          # a, b, out, n, stream
    # a, b, out, scratch, tickets, n, stream
    "bp_fe_inner_product": [_P, _P, _P, _P, _P, _N, _P],
    # a, b, out, scratch, tickets, rows, n, stream
    "bp_fe_inner_product_batched": [_P, _P, _P, _P, _P, _N, _N, _P],
    # p's x, y, z, t pointers and their row strides, out, n, stream
    "bp_ge_reduce": [*[_P] * 4, *[_N] * 4, _P, _N, _P],
    # pre, dg, part, out, n, nw, w, threads, slices, stream
    "bp_ge_bucket_accum": [_P, _P, _P, _P, _N, _N, _N, _N, _N, _P],
    # pt, ht, out, carry, buf, flags, depth, lanes, stream
    "bp_ge_seg_scan": [_P, _P, _P, _P, _P, _P, _N, _N, _P],
    # body, buf, wacc, out, m, depth, lanes, stream
    "bp_ge_bucket_fold": [_P, _P, _P, _P, _N, _N, _N, _P],
    # keys, counts, nblk, radix, stream
    "bp_sort_hist": [_P, _P, _N, _N, _P],
    # keys, base, rank, nblk, radix, stream
    "bp_sort_rank": [_P, _P, _P, _N, _N, _P],
    "bp_fe_mul_chain": [_P, _P, _P, _N, _N, _P],  # a, b, out, n, reps, stream
    "bp_r16_mul": [_P, _P, _P, _N, _P],         # a, b, out, n, stream
    "bp_r16_sq": [_P, _P, _N, _P],              # a, out, n, stream
    "bp_r16_mul_chain": [_P, _P, _P, _N, _N, _P],  # a, b, out, n, reps, stream
    # p, out, n, k, op, pass pair, stream
    "bp_ge_add_chain": [_P, _P, _N, _N, _N, _N, _P],
    # pt, dg, out, buckets, totals, nw, steps, unroll, lanes, nb, variant,
    # shared, stream
    "bp_ge_accum_window": [_P, _P, _P, _P, _P, _N, _N, _N, _N, _N, _N, _N,
                           _P],
}

_lib = None
build_seconds = None     # wall time of the nvcc run that produced the library


def sources(csrc: Path = CSRC) -> list:
    return sorted(Path(csrc).glob("*.cu"))


def _digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(Path(csrc).glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(csrc: Path = CSRC) -> Path:
    return BUILD_DIR / f"libbp_kernels-{_digest(csrc)}.so"


def build(csrc: Path = CSRC) -> Path:
    """Compile the kernels of `csrc` (the package's own by default; another
    checkout's for an A/B) unless the library for these sources exists."""
    global build_seconds
    out = library_path(csrc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in sources(csrc):
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", "-o", str(obj),
                   str(src)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{text[-4000:]}")
        if not failed:
            tmp = work / "lib.so"
            link = subprocess.run(
                [nvcc, *ARCH, "-shared", "-o", str(tmp),
                 *(str(obj) for _, obj, _ in jobs)],
                capture_output=True, text=True)
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
        build_seconds = time.perf_counter() - t0
        out.with_suffix(".log").write_text("".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library with the entry points bound (``.entries``,
    name -> function with its argument types set); raises if its C
    interface is not this checkout's."""
    handle = ctypes.CDLL(str(path))
    abi = handle.bp_abi_version() if hasattr(handle, "bp_abi_version") else 1
    if abi != ABI:
        raise RuntimeError(
            f"{path}: C interface version {abi}, this checkout calls {ABI}: "
            "its kernels take other arguments (compare such a checkout with "
            "its own wrappers: benchmarks/bench_calls.py --against)")
    handle.entries = {}
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        handle.entries[name] = fn
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def launch(name: str, device, *args) -> None:
    """Call C entry `name` on PyTorch's current stream of CUDA `device`
    (a torch.device with its index), entering the device only when it is
    not the current one; raise on a refused launch.  Tensors pass as their
    data pointers, ints as themselves."""
    import torch
    fn = lib().entries[name]
    conv = [a if type(a) is int else a.data_ptr() for a in args]
    index = device.index
    # the raw cudaStream_t as an int, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        rc = fn(*conv, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")

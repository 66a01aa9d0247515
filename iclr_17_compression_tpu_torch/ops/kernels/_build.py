"""Build and load the port's native libraries.

Three shared libraries with a plain C interface, loaded with ctypes:

- ``libiclr17c_kernels.so``: every ``csrc/*.cu`` in one ``nvcc`` call for
  ``sm_90a`` (H100). No source includes PyTorch's or CUTLASS's headers, so
  the build takes seconds, not the minutes of ``torch.utils.cpp_extension``.
- ``librans.so``: the port's copy of the rANS coder
  (``coding/src/rans.cc``), built with ``g++``. The CPU path needs only this
  and the next.
- ``libarctx.so``: the port's copy of the joint-AR host context library
  (``coding/src/ar_ctx.cc``), built with ``g++``; it finds its BLAS at run
  time (``coding/ar_native.py``).

Both go to ``build/iclr17c_torch/`` at the root of the checkout on first use.
A build is keyed by a hash of its sources and command, so an edited source
rebuilds, and it runs under a file lock, so concurrent processes (parallel
test workers) build once. A failed build raises with the compiler's stderr;
a good one leaves the compiler's output beside the library (``<name>.log``:
for the kernels, ``ptxas`` registers, shared memory and spills of each).
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = _PKG.parent / "build" / "iclr17c_torch"
CSRC = Path(__file__).resolve().parent / "csrc"
RANS_SRC = _PKG / "coding" / "src" / "rans.cc"
AR_CTX_SRC = _PKG / "coding" / "src" / "ar_ctx.cc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_c = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from source on first use"
        )
    return found


def build(name: str, compiler: str, flags: list, sources: list, deps: list = ()) -> tuple:
    """Compile ``sources`` into ``BUILD_DIR/name`` unless an up-to-date copy
    exists: several sources each by its own compiler process, all at once,
    then one link. Returns (path, seconds spent compiling; 0.0 for a cache
    hit)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(" ".join([Path(compiler).name] + flags).encode())
    for path in sorted(list(sources) + list(deps)):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    key = digest.hexdigest()
    lib = BUILD_DIR / name
    stamp = BUILD_DIR / (name + ".sha256")
    with open(BUILD_DIR / (name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and stamp.exists() and stamp.read_text() == key:
            return lib, 0.0
        tmp = BUILD_DIR / f"{name}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        if len(sources) == 1:
            log = _run(name, [compiler] + flags + ["-o", str(tmp), str(sources[0])], tmp)
        else:
            # one compiler a source, all started together, then one link
            objs = [BUILD_DIR / f"{name}.{Path(src).stem}.{os.getpid()}.o" for src in sources]
            compile_flags = [f for f in flags if f != "-shared"] + ["-c"]
            procs = [(subprocess.Popen([compiler] + compile_flags + ["-o", str(obj), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), obj) for src, obj in zip(sources, objs)]
            log = ""
            try:
                for proc, obj in procs:
                    out, err = proc.communicate()
                    log += err + out
                    if proc.returncode != 0:
                        raise RuntimeError(f"building {name} failed ({' '.join(proc.args)}):"
                                           f"\n{err}{out}")
                log += _run(name, [compiler] + flags + ["-o", str(tmp)] + [str(o) for o in objs],
                            tmp)
            finally:
                for proc, obj in procs:
                    proc.kill()
                    proc.wait()
                    obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        os.replace(tmp, lib)
        (BUILD_DIR / (name + ".log")).write_text(log)
        stamp.write_text(key)
    return lib, seconds


def _run(name: str, cmd: list, tmp: Path) -> str:
    """Run one compiler command that writes ``tmp``; its output, or raise."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name} failed ({' '.join(cmd)}):\n{proc.stderr}{proc.stdout}")
    return proc.stderr + proc.stdout


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The CUDA kernels K1-K3, each in fp32 and bf16, and an empty kernel,
    whose launch is the floor under K3's time (built on first call)."""
    sources = sorted(CSRC.glob("*.cu"))
    path, _ = build(
        "libiclr17c_kernels.so", _nvcc(), NVCC_FLAGS, sources, sorted(CSRC.glob("*.cuh"))
    )
    lib = ctypes.CDLL(str(path))
    for fn in (lib.iclr17c_gdn, lib.iclr17c_gdn_bf16):
        fn.restype = _i
        fn.argtypes = [_c, _c, _c, _c, _ll, _i, _i, _c]
    lib.iclr17c_conv_gdn.restype = _i
    lib.iclr17c_conv_gdn.argtypes = [_c] * 7 + [_i] * 14 + [_c]
    lib.iclr17c_conv_gdn_bf16.restype = _i
    lib.iclr17c_conv_gdn_bf16.argtypes = [_c] * 6 + [_i] * 15 + [_c]
    lib.iclr17c_conv_gdn_smem_bytes_bf16.restype = ctypes.c_size_t
    lib.iclr17c_conv_gdn_smem_bytes_bf16.argtypes = [_i, _i]
    for fn in (lib.iclr17c_conv_gdn_smem_bytes, lib.iclr17c_gdn_smem_bytes,
               lib.iclr17c_gdn_bf16_smem_bytes):
        fn.restype = ctypes.c_size_t
        fn.argtypes = [_i]
    lib.iclr17c_conv_gdn_blocks_per_sm.restype = _i
    lib.iclr17c_conv_gdn_blocks_per_sm.argtypes = [_i]
    for fn in (lib.iclr17c_quant_pack, lib.iclr17c_quant_pack16):
        fn.restype = _i
        fn.argtypes = [_c, _c, _c, _ll, ctypes.c_float, _i, _c]
    for fn in (lib.iclr17c_quant_pack_bf16, lib.iclr17c_quant_pack16_bf16):
        fn.restype = _i
        fn.argtypes = [_c, _c, _c, _ll, ctypes.c_float, ctypes.c_float, _i, _c]
    lib.iclr17c_empty.restype = _i
    lib.iclr17c_empty.argtypes = [_c]
    return lib


@functools.lru_cache(maxsize=None)
def rans() -> ctypes.CDLL:
    """The host rANS coder (built on first call)."""
    path, _ = build("librans.so", "g++", GXX_FLAGS, [RANS_SRC])
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def ar_ctx() -> ctypes.CDLL:
    """The joint-AR host context library (built on first call)."""
    path, _ = build("libarctx.so", "g++", GXX_FLAGS + ["-ldl"], [AR_CTX_SRC])
    return ctypes.CDLL(str(path))


def check_launch(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


# The element types the kernels take; each wrapper names, for the type of its
# input, the types of its other operands (the Pallas wrappers' dtype flow).
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def kernel_dtype(what: str, x) -> torch.dtype:
    """The element type of ``x`` if a kernel variant takes it, else raise:
    a tensor of another type is never converted to one the kernel takes."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the kernels take float32 or bfloat16, got {x.dtype}")
    return x.dtype


def check_tensor(name: str, t, shape: tuple = None, dtype=torch.float32) -> None:
    """Validate a tensor handed to a kernel: on CUDA, of ``dtype``,
    C-contiguous, 16-byte aligned, and of ``shape`` where one is given."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def forward_only(what: str, *tensors) -> None:
    """Refuse a call that autograd would need to differentiate, for a kernel
    that has no gradient (K3, as its Pallas twin has none)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is forward-only on CUDA; call it under torch.no_grad()"
        )

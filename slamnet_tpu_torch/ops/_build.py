"""Build the port's CUDA kernels with nvcc and load them with ctypes.

On first use, one ``nvcc -c`` a source compiles every
``slamnet_tpu_torch/csrc/*.cu``, all started together so the build takes as
long as the slowest source however many there are, and one more ``nvcc``
links the objects into
``build/slamnet_tpu_torch/<hash of sources and flags>/libslamnet_kernels.so``
at the repository root.  The sources have a plain C interface
(``extern "C"`` launchers that take the CUDA stream and return
``cudaGetLastError()``), so nothing includes PyTorch's headers and the build
takes seconds.  A rebuilt source gets a new hash and a new directory.

Every launch goes through ``launch``, which makes the tensors' card the
current device for the call: a ``<<<..., stream>>>`` launch goes to the
calling thread's current device, whatever card the stream and the pointers
belong to.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "slamnet_tpu_torch"
LIB_NAME = "libslamnet_kernels.so"
# no --use_fast_math: sinf/cosf/expf/atan2f/sqrtf and division stay accurate.
# -fmad=false keeps a*b+c as two rounded operations, as the plain PyTorch
# versions (one kernel per operator) compute them, so roundings to map cells
# agree between the kernels and their plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")
# per source: the match kernel's 512-thread instantiation uses up to 128
# registers (ptxas otherwise keeps it to 64 and spills); its 1024-thread one
# stays at 64 by its launch bounds
SOURCE_FLAGS = {"match.cu": ("-maxrregcount=128",)}


def flags(src: Path) -> tuple[str, ...]:
    """nvcc's flags for one source."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(src.name, ())


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).is_file():
        raise RuntimeError(
            "slamnet_tpu_torch kernels need nvcc (CUDA toolkit) to build; none "
            f"on PATH or under {cuda_home}/bin")
    return found


@functools.cache
def check_device(index: int) -> None:
    """Raise unless card ``index`` exists and is a Hopper (sm_90a) card."""
    if not torch.cuda.is_available():
        raise RuntimeError("slamnet_tpu_torch kernels need a CUDA device")
    major, minor = torch.cuda.get_device_capability(index)
    if major != 9:
        raise RuntimeError(
            "slamnet_tpu_torch kernels are built for sm_90a (Hopper); device "
            f"cuda:{index} is compute capability {major}.{minor}")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build() -> tuple[Path, str]:
    """Compile the kernels unless this exact build exists; returns the
    library path and nvcc's output (``-Xptxas=-v`` register/shared-memory
    report; empty when the library was already built)."""
    if not torch.cuda.is_available():
        raise RuntimeError("slamnet_tpu_torch kernels need a CUDA device")
    check_device(torch.cuda.current_device())
    nvcc = _nvcc()
    srcs = sources()
    h = hashlib.sha256()
    for src in srcs:
        h.update(" ".join(flags(src)).encode())
    for src in srcs + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    cmds = [[nvcc, *flags(s), "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                  stderr=subprocess.STDOUT)
                 for cmd in cmds]          # every source at once, one nvcc each
        outs = [p.communicate()[0] for p in procs]   # all end before any raise
        for cmd, out, p in zip(cmds, outs, procs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        tmp.replace(lib)    # atomic: a concurrent loader never sees half a file
    finally:                # no object or partial library outlives the build
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return lib, "".join(outs) + proc.stdout + proc.stderr


@functools.cache
def library() -> tuple[ctypes.CDLL, float, str]:
    """The loaded kernel library, the seconds its build took and nvcc's
    report.  Built once per process; each op module declares the argtypes of
    its own launcher."""
    t0 = time.perf_counter()
    path, log = build()
    return ctypes.CDLL(str(path)), time.perf_counter() - t0, log


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the integer ctypes passes."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(what: str, fn, device: torch.device, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` for tensors on ``device``
    (PyTorch's current stream there) and raise on its error code.

    The launcher's ``<<<..., stream>>>`` goes to the thread's current
    device, so ``device`` is made current for the call alone: otherwise a
    kernel for ``cuda:1`` would run on the current card with card 1's
    pointers (the default stream's handle is 0) or be refused (a
    non-default stream of another card).  PyTorch's device guard does it,
    rather than a ``cudaSetDevice`` in each C launcher, so the caller's
    current device comes back after the call and PyTorch's own record of it
    stays true."""
    check_device(device.index)
    with torch.cuda.device(device):
        code = fn(*args, stream_handle(device))
    raise_on_error(code, what)


def check_tensors(kernel: str, device: torch.device, specs) -> None:
    """Raise ValueError unless every (name, tensor, dtype, shape) of
    ``specs`` is a contiguous tensor of that dtype and shape on ``device``."""
    for name, t, dtype, shape in specs:
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{kernel} {name}: want contiguous {dtype} {tuple(shape)} on "
                f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def raise_on_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")

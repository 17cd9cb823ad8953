"""Build and load the port's CUDA kernels (nvcc into shared libraries, ctypes).

Each `csrc/<name>.cu` is compiled on its own, at first use, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

into `desed_task_tpu_torch/_kernels_build/` (listed in .gitignore). The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. All missing libraries are built
together, one nvcc process per source, started at once.

Each library exposes a plain C interface whose entries return
`cudaGetLastError()` as an int; `check` raises when it is not 0. Pointers and
the stream are passed as `ctypes.c_void_p`, never as 32-bit ints.

`LAUNCHES` counts kernel launches per wrapper: each wrapper calls
`count_launch` once where it launches its kernel, and nowhere else.

The forward entries that serving and an exported program call are ops of
the torch.library namespace `desed_torch` (`define_op`): the CUDA kernel
for CUDA tensors, the plain version for CPU tensors, and a fake function
through which torch.export traces them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: dict[str, int] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}

P = ctypes.c_void_p
I = ctypes.c_int
Fl = ctypes.c_float


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{h[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu whose library is missing; return name -> path."""
    sources = sorted(CSRC.glob("*.cu"))
    out = {s.stem: library_path(s) for s in sources}
    todo = [s for s in sources if not out[s.stem].is_file()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in todo:
        tmp = out[src.stem].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {src.name} failed (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[src.stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library csrc/<name>.cu, building all sources if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _LIBS[name] = lib
    return lib


def function(name: str, fn: str, argtypes):
    """C entry `fn` of library `name`, its argument types declared once."""
    f = _FUNCS.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FUNCS[(name, fn)] = f
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of t's card (the raw handle, without building the
    torch.cuda.Stream object that current_stream returns)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def op_library() -> torch.library.Library:
    """A fragment of the torch.library namespace desed_torch, where the
    kernels' forward entries are registered as ops."""
    return torch.library.Library("desed_torch", "FRAGMENT")


def define_op(lib: torch.library.Library, schema: str, cuda, cpu, fake) -> None:
    """Define desed_torch::<schema> with its CUDA kernel launch, its plain
    version for CPU tensors and its fake function (output shapes and dtypes,
    for torch.export); no other device has an implementation."""
    name = schema.split("(", 1)[0]
    lib.define(schema)
    lib.impl(name, cuda, "CUDA")
    lib.impl(name, cpu, "CPU")
    torch.library.register_fake(f"desed_torch::{name}", fake, lib=lib)


def require_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous `dtype` CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one card."""
    require_cuda(name, torch.float32, *tensors)

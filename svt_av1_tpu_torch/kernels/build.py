"""Build and load the port's compiled code from the sources in this checkout.

Two kinds of shared object land in ``build/torch_kernels/`` at the repo
root (listed in .gitignore), both built at first use and keyed by a hash
of their sources and flags, so an edited source rebuilds and concurrent
processes (pytest workers, the prefetch thread) share one build:

* the four host C extensions of ``native/`` (``gcc``, loaded as Python
  extension modules);
* the CUDA kernels of ``kernels/csrc/`` (``nvcc`` for ``sm_90a`` into a
  shared library with a plain C interface, loaded with ctypes).  A kernel
  is never built when a module is imported: only a wrapper that is given
  a CUDA tensor asks for its library.

No fast-math flag is passed: the residual cost model (cost_model.cuh)
relies on IEEE division and ``log2f``.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = PKG_DIR.parent
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
CSRC_DIR = PKG_DIR / "kernels" / "csrc"
NATIVE_DIR = PKG_DIR / "native"

C_FLAGS = ["-O3", "-std=c11", "-march=native", "-shared", "-fPIC"]
# -Xptxas -v: ptxas reports each entry's registers, spills and shared
# memory; build_all_cuda keeps the report beside the library
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel library name -> its CUDA source (one nvcc per source)
CUDA_SOURCES = {
    "intra_decision": "intra_decision.cu",
    "deblock": "deblock.cu",
    "cdef_direction": "cdef_direction.cu",
    "cdef_filter": "cdef_filter.cu",
    "me_coarse": "me_coarse.cu",
    "me_refine": "me_refine.cu",
    "subpel_refine": "subpel_refine.cu",
    "inter_select": "inter_select.cu",
    "compound_joint": "compound_joint.cu",
    "block_var16": "block_var16.cu",
}

_lock = threading.Lock()
_loaded: dict = {}


def _digest(paths, flags) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(Path(p).read_bytes())
    h.update(" ".join(flags).encode())
    h.update(sys.version.encode())
    return h.hexdigest()[:16]


def _build_locked(out: Path, cmd_of) -> Path:
    """Run ``cmd_of(tmp_path)`` into ``out`` unless it exists; a file lock
    serializes processes that build the same object."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not out.exists():
                tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
                r = subprocess.run(cmd_of(tmp), capture_output=True,
                                   text=True)
                if r.returncode != 0:
                    raise RuntimeError(
                        f"build of {out.name} failed:\n{r.stderr[-4000:]}")
                os.replace(tmp, out)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return out


# --------------------------------------------------------------------------
# host C extensions (native/*.c)
# --------------------------------------------------------------------------

def load_c_extension(name: str):
    """Build (if needed) and import ``native/<name>.c`` as the extension
    module ``svt_av1_tpu_torch.native.<name>``."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = NATIVE_DIR / f"{name}.c"
        deps = [src] + sorted(NATIVE_DIR.glob("*.h"))
        inc = sysconfig.get_paths()["include"]
        flags = C_FLAGS + [f"-I{inc}"]
        out = BUILD_DIR / f"{name}-{_digest(deps, flags)}.so"
        cc = os.environ.get("CC", "gcc")
        _build_locked(out, lambda tmp: [cc, *flags, str(src), "-o",
                                        str(tmp)])
        full = f"svt_av1_tpu_torch.native.{name}"
        loader = importlib.machinery.ExtensionFileLoader(full, str(out))
        spec = importlib.util.spec_from_file_location(full, str(out),
                                                      loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        sys.modules[full] = mod
        _loaded[name] = mod
        return mod


# --------------------------------------------------------------------------
# CUDA kernels (kernels/csrc/*.cu)
# --------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host "
                       "with the CUDA toolkit")


def _cuda_target(name: str) -> tuple[Path, list]:
    src = CSRC_DIR / CUDA_SOURCES[name]
    deps = [src] + sorted(CSRC_DIR.glob("*.cuh"))
    out = BUILD_DIR / f"{name}-{_digest(deps, NVCC_FLAGS)}.so"
    return out, [*NVCC_FLAGS, "-I", str(CSRC_DIR), str(src), "-o"]


def build_all_cuda() -> dict:
    """Build every CUDA kernel library at once: one ``nvcc`` per source,
    all started together, each with ptxas's report written beside it
    (``ptxas_report``).  Returns {name: seconds until its build ended}
    (0.0 for an object already built)."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in CUDA_SOURCES:
        out, args = _cuda_target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (subprocess.Popen([nvcc, *args, str(tmp)],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    took = {name: 0.0 for name in CUDA_SOURCES}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        _, err = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}:\n{err[-4000:]}")
        else:
            out.with_suffix(".ptxas").write_text(err)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    return took


def ptxas_report(name: str) -> list:
    """What nvcc printed in a kernel library's last build_all_cuda: ptxas's
    lines on each entry's registers, spills and shared memory ([] if the
    library was built elsewhere)."""
    log = _cuda_target(name)[0].with_suffix(".ptxas")
    return [ln.strip() for ln in log.read_text().splitlines()
            if ln.strip()] if log.exists() else []


def cuda_lib(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built on first call."""
    key = ("cuda", name)
    with _lock:
        if key in _loaded:
            return _loaded[key]
        out, args = _cuda_target(name)
        nvcc = _nvcc()
        _build_locked(out, lambda tmp: [nvcc, *args, str(tmp)])
        lib = ctypes.CDLL(str(out))
        _loaded[key] = lib
        return lib


@functools.cache
def cuda_fn(name: str, entry: str, argtypes: tuple):
    """A kernel library's C entry with its ctypes types, bound once."""
    fn = getattr(cuda_lib(name), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise when a kernel's C entry reports a CUDA error (the launch was
    refused or an earlier asynchronous fault surfaced)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor for a ctypes call."""
    return ctypes.c_void_p(t.data_ptr())


def raw_stream(t) -> int:
    """The handle of PyTorch's current CUDA stream on the tensor's device
    (torch.cuda.current_stream builds a Stream object: about 6 us of host
    time per call on the H100's host, against 0.2 us for the handle)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def stream(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the tensor's device."""
    return ctypes.c_void_p(raw_stream(t))

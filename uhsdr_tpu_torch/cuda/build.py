"""Build and load the hand-written Hopper kernels.

Each source under `uhsdr_tpu_torch/kernels/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface and loaded with
`ctypes` (no PyTorch headers, so a build takes seconds).  Libraries go to
`uhsdr_tpu_torch/_build/` (listed in `.gitignore`) under a name that
carries a hash of the source and flags, so an edited source never loads a
stale build.  Nothing is built at import: the first launch builds its own
library, and `build_all` builds every kernel at once, one `nvcc` process
per source, all started together.  A source may include headers of its
own directory (`#include "ring.cuh"`); they count in its hash.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import weakref

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
KERNEL_DIR = _PKG / "kernels"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# the most dynamic shared memory a block may ask for on an H100
SMEM_OPT_IN = 227 * 1024

_ALL: list["CudaKernel"] = []
_LOCAL_INCLUDE = re.compile(r'^#include "([^"]+)"[^\n]*$', re.M)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels build from source at first use")
    return found


class CudaKernel:
    """One kernel source: built on first use, counted per launch.

    ``launches`` is incremented by the wrapper each time it launches the
    kernel, and nowhere else, so a run can show the kernel was used.
    ``signatures`` maps each exported C function to (argtypes, restype).
    A second kernel of one source names the first as ``lib_of`` and uses
    its library, so the source is compiled once."""

    def __init__(self, name: str, source: str, signatures: dict | None = None,
                 extra_flags: tuple = (), lib_of: "CudaKernel | None" = None):
        self.name = name
        self.source = KERNEL_DIR / source
        self.signatures = signatures or {}
        self.flags = BASE_FLAGS + ARCH_FLAGS + tuple(extra_flags)
        self.lib_of = lib_of
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        _ALL.append(self)

    def source_text(self) -> str:
        """The source with the headers it includes from its own directory
        written in place (each once), as one translation unit."""
        seen = set()

        def expand(path: pathlib.Path) -> str:
            def sub(m):
                inc = path.parent / m.group(1)
                if inc in seen:
                    return ""
                seen.add(inc)
                return expand(inc)
            return _LOCAL_INCLUDE.sub(sub, path.read_text())
        return expand(self.source)

    def _lib_path(self) -> pathlib.Path:
        h = hashlib.sha1(self.source_text().encode())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start nvcc for this source unless the library exists; returns
        the process (or None)."""
        out = self._lib_path()
        if self.lib_of is not None or out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a temporary name of this process and thread: `build_all` on one
        # thread and a first launch on another (the radio server's pump)
        # may build one source at once, each into its own file
        tmp = out.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *self.flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.out_tmp = tmp
        return proc

    def finish_build(self, proc):
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(proc.out_tmp, self._lib_path())

    def lib(self):
        """The loaded library, building it first if needed."""
        if self.lib_of is not None:
            return self.lib_of.lib()
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self._lib_path()))
                for fn, (argtypes, restype) in self.signatures.items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = restype
                lib.uhsdr_error_string.argtypes = [ctypes.c_int]
                lib.uhsdr_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def check(self, err: int):
        """Raise if a launch function returned a CUDA error code."""
        if err != 0:
            msg = self.lib().uhsdr_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaError {err} ({msg})")


def build_all():
    """Build every registered kernel, one nvcc per source in parallel.
    Returns {name: nvcc log} (the -Xptxas -v register/smem report)."""
    # importing the wrapper modules registers their kernels
    from . import (agc, alc, blanker, cw, elemwise, fir,  # noqa: F401
                   fm_mod, iir, iqcorr, lattice, lms, nr, pll, psk, rtty,
                   sam)
    procs = [(k, k.start_build()) for k in _ALL]
    errors = []
    for k, p in procs:
        try:
            k.finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in _ALL:
        k.lib()
    return {k.name: k.build_log for k in _ALL}


def resource_usage(lib: pathlib.Path) -> dict:
    """{entry function (mangled): {"registers", "stack", "local"}} of a
    built library, from `cuobjdump --dump-resource-usage` (local memory
    past the stack is where registers spill)."""
    cuobjdump = pathlib.Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "--dump-resource-usage",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) "
                         r"SHARED:\d+ LOCAL:(\d+)", text):
        out[m.group(1)] = {"registers": int(m.group(2)),
                           "stack": int(m.group(3)),
                           "local": int(m.group(4))}
    return out


def kernels() -> list[CudaKernel]:
    from . import (agc, alc, blanker, cw, elemwise, fir,  # noqa: F401
                   fm_mod, iir, iqcorr, lattice, lms, nr, pll, psk, rtty,
                   sam)
    return list(_ALL)


_DERIVED: dict = {}


def derived(t: torch.Tensor, key, make):
    """A table derived on the host from the values of tensor `t` (the
    taps or coefficients a kernel's wrapper rebuilds into its own form):
    `make(values as a numpy array)` runs once per (tensor, version, key)
    and is cached while `t` lives, so a stream's blocks pay no
    device-to-host copy."""
    slot = (id(t), key)
    hit = _DERIVED.get(slot)
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    out = make(t.detach().cpu().numpy())
    _DERIVED[slot] = (weakref.ref(t, lambda _: _DERIVED.pop(slot, None)),
                      t._version, out)
    return out


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`, the launch rules' `sms`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(device) -> int:
    """PyTorch's current stream on `device`, as the kernels' launch stream."""
    return torch.cuda.current_stream(device).cuda_stream

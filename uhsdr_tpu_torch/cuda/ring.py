"""The layout of `kernels/ring.cuh`, the warp-specialised tile ring that
K11 (`kernels/biquad.cu`) and SAM's sideband stage (`kernels/sam.cu`)
walk their recurrences on: walker warps a block (one per scheduler of an
SM), the time tile, the stage buffers, threads a block (walkers, the
front warp, an output warp per walker).  The launch rules
(`cuda/iir.py::biquad_geometry`, `cuda/sam.py::sam_geometry`) size their
blocks from it; `checked_lib` holds a built library to it.
"""
from __future__ import annotations

from .build import CudaKernel

WALKERS = 4
TILE = 32
STAGES = 4
THREADS = 32 * (2 * WALKERS + 1)
# the SMs of an H100 SXM, the rules' default
SMS = 132


def checked_lib(kernel: CudaKernel, prefix: str):
    """`kernel`'s library, its exported layout (`uhsdr_<prefix>_walkers`,
    `_tile`, `_stages`, `_threads`) checked against this module's when it
    is first used (the mark lives on the library)."""
    lib = kernel.lib()
    if not getattr(lib, "geometry_checked", False):
        got = tuple(getattr(lib, f"uhsdr_{prefix}_{what}")()
                    for what in ("walkers", "tile", "stages", "threads"))
        want = (WALKERS, TILE, STAGES, THREADS)
        if got != want:
            raise RuntimeError(f"{kernel.source.name}'s layout {got} differs "
                               f"from cuda/ring.py's {want}")
        lib.geometry_checked = True
    return lib

"""Build and load the port's CUDA kernels.

`nvcc` compiles the `.cu` sources under raytracer2_tpu_torch/csrc (and
nothing else) into one shared library with a plain C interface, at first
use, into build/kernels/ at the repository root: one `nvcc -c` per source,
all started together, then one link. The output name carries a hash of the
sources and flags, so an edited kernel never loads a stale library. The library is loaded with ctypes; every pointer argument is
declared c_void_p (an undeclared pointer would be cut to 32 bits).

--fmad=false keeps every multiply and add separately rounded, in the order
the source writes them, and fuses only the explicit __fmaf_rn of the Wald
test (csrc/walk_common.cuh, csrc/hit_decode.cu): the kernel then computes
the same bits as the plain torch version of each kernel
(ops/cuda_traverse.py, ops/cull.py, ops/cuda_pairs.py; ops/binning.py's
kernel is integer work; csrc/di_spatial.cu keeps the plain version's
order of operations, its transcendentals aside).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "--fmad=false", "-std=c++17", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str  # nvcc's stderr (ptxas register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


@functools.cache
def build() -> Build:
    """Compile the kernel library if this source hash is not built yet."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libraytracer2_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    tmp.replace(out)
    return Build(out, seconds, "".join(logs))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build().path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for entry in ("rt2_walk_closest", "rt2_walk_occluded"):
        getattr(lib, entry).restype = ci
        getattr(lib, entry).argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,  # rays8, cand_idx,
            #   cand_t, cand_count, lane coeffs, lane count, order scratch,
            #   out, aux (lean) or null, steps or null
            ci, ci, ci, ci, ci, ci, ci,  # n_bundles, p, k, s_pad, group,
            #   sc_m (0: cluster walk), n_clusters
            ci, ci, ci,  # depth, mb, mm
            vp]  # stream
        getattr(lib, f"{entry}_occupancy").restype = ci
        getattr(lib, f"{entry}_occupancy").argtypes = [
            ci, ci, ci, ci, ci, vp]  # p, s_pad, sc, depth, mm, out
    lib.rt2_nearest_box_occupancy.restype = ci
    lib.rt2_nearest_box_occupancy.argtypes = [vp]  # out
    lib.rt2_bundle_union_occupancy.restype = ci
    lib.rt2_bundle_union_occupancy.argtypes = [ci, vp]  # cap, out
    lib.rt2_nearest_box.restype = ci
    lib.rt2_nearest_box.argtypes = [vp, vp, vp,  # rays8, boxes, out
                                    ci, ci,  # n, c
                                    vp]  # stream
    lib.rt2_bundle_union.restype = ci
    lib.rt2_bundle_union.argtypes = [vp, vp, vp, vp,  # rays8, boxes, out,
                                     #   cap or null
                                     ci, ci, ci,  # n_bundles, p, c
                                     vp]  # stream
    lib.rt2_pair_sweep.restype = ci
    lib.rt2_pair_sweep.argtypes = [
        vp, vp, vp, vp, vp, vp,  # rays8, block_sc, block_live, lane
        #   coeffs, lane count, keys
        ci, ci, ci, ci, ci, ci,  # n_blocks, n_sc, n_clusters, group,
        #   s_pad, slot_mask
        vp]  # stream
    lib.rt2_pair_sweep_occupancy.restype = ci
    lib.rt2_pair_sweep_occupancy.argtypes = [ci, vp]  # s_pad, out
    lib.rt2_bin_scatter_occupancy.restype = ci
    lib.rt2_bin_scatter_occupancy.argtypes = [ci, ci, vp]  # kernel,
    #   n_bins, out
    ll = ctypes.c_longlong
    lib.rt2_bin_scatter.restype = ci
    lib.rt2_bin_scatter.argtypes = [
        vp, vp, vp, vp, vp,  # ids, scratch, counts, out, ranks
        ll, ci, ci, ci, ci, ll,  # n, n_bins, n_write, pad, div, out_size
        vp]  # stream
    lib.rt2_hit_decode.restype = ci
    lib.rt2_hit_decode.argtypes = [
        vp, vp, vp,  # code, perm or null, meta rows
        ll,  # n_rows
        vp, vp, vp,  # origins, directions, t_max
        vp, vp, vp, vp, vp, vp,  # t, u, v, geometry, primitive, triangle
        ci,  # n
        vp]  # stream
    lib.rt2_hit_decode_occupancy.restype = ci
    lib.rt2_hit_decode_occupancy.argtypes = [vp]  # out
    lib.rt2_di_spatial.restype = ci
    lib.rt2_di_spatial.argtypes = [vp, vp, vp, vp,  # pointers, lane
                                   #   strides, ints, floats (host arrays)
                                   vp]  # stream
    lib.rt2_di_spatial_occupancy.restype = ci
    lib.rt2_di_spatial_occupancy.argtypes = [vp]  # out
    lib.rt2_error_string.restype = ctypes.c_char_p
    lib.rt2_error_string.argtypes = [ci]
    return lib


def occupancy(entry: str, *args: int) -> dict:
    """A kernel's residency on the card, from its occupancy entry point
    (rt2_walk_closest_occupancy(p, s_pad, sc, depth, mm) and
    rt2_walk_occluded_occupancy(...) of an instance, rt2_nearest_box_
    occupancy(), rt2_bundle_union_occupancy(cap),
    rt2_pair_sweep_occupancy(s_pad),
    rt2_bin_scatter_occupancy(kernel,
    n_bins) for B6's count (0), scan (1) and scatter (2) kernels,
    rt2_hit_decode_occupancy(), rt2_di_spatial_occupancy()):
    resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    threads per block, registers per thread and shared bytes per block."""
    lib = library()
    out = (ctypes.c_int * 4)()
    err = getattr(lib, entry)(*args, out)
    if err != 0:
        raise RuntimeError(f"{entry} failed: "
                           f"{lib.rt2_error_string(err).decode()} ({err})")
    return dict(zip(("blocks_per_sm", "threads", "registers", "smem_bytes"),
                    out))

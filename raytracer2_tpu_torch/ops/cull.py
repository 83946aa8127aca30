"""The exact cull's two dense slab passes, port of
raytracer2_tpu/ops/pallas_cull.py: the wrappers of the kernels that replace
its Pallas kernels (csrc/cull.cu) and their plain torch versions.

- nearest_box (B3, _key_kernel): per ray, the index of the cluster box of
  least conservative entry distance, the first index on ties, C where the
  ray's segment overlaps no box. The dense pass of the cand0 sort key.
- bundle_union (B4, _union_kernel): per bundle of P consecutive rays and
  per box, the least entry distance over the bundle's rays, +inf where
  none overlaps. The [B, C] table the candidate ranking sorts. With
  cap=True (t_cap, JAX's _entry_exact_cap) also per ray the farthest exit
  distance over the boxes it overlaps, -inf where it overlaps none.

Rays are [N, 8] f32 rows (ox oy oz dx dy dz t_min t_max); boxes are the
clusters' [C, 3] corners. On a CUDA tensor a wrapper launches its kernel
(and counts the launch in `<wrapper>.launches`); on a CPU tensor it runs
the plain version. The plain versions chunk the [rays, C] slab temporary
to CULL_CHUNK_BYTES. Both forms give the same bits: entry distances of
zero are +0 in both (the JAX package's max(near, 0.0) gives +0 too).
"""

from __future__ import annotations

import ctypes

import torch

CULL_CHUNK_BYTES = 48 << 20  # bound on one [rays, C] f32 cull temporary (CPU)
MAX_BUNDLE = 256  # rays per bundle bundle_union's kernel takes (csrc/cull.cu)


def chunk_bytes(device: torch.device) -> int:
    """Bytes allowed for one [rays, C] f32 temporary of a plain pass: the
    JAX bound on the CPU, a share of free memory on the card. Results do
    not depend on it."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(CULL_CHUNK_BYTES, free // 64)
    return CULL_CHUNK_BYTES


def _entry_exact(o, d, tn, tx, amin, amax):
    """Exact per-ray slab test vs every cluster AABB: [n, C] conservative
    entry distance, +inf where the ray's [tn, tx] segment misses the box;
    dead rays (tx < 0) get all-inf rows. torch.minimum/maximum propagate
    NaN, so a NaN ray misses every box."""
    near, _, hit = _slab(o, d, tn, tx, amin, amax)
    # max(near, +0) with a +0 result for near = -0 on every device
    return torch.where(hit, torch.where(near > 0.0, near, 0.0), torch.inf)


def _entry_exact_cap(o, d, tn, tx, amin, amax):
    """_entry_exact and, per ray, the farthest exit over the boxes it
    overlaps ([n]; -inf where none), with -0 made +0 (far + 0.0): the max
    is then one value whatever the order, as the kernel's integer max."""
    near, far, hit = _slab(o, d, tn, tx, amin, amax)
    entry = torch.where(hit, torch.where(near > 0.0, near, 0.0), torch.inf)
    cap = torch.where(hit, far + 0.0, -torch.inf).amax(dim=1)
    return entry, cap


def _slab(o, d, tn, tx, amin, amax):
    """The [n, C] slab test: (near, far, hit)."""
    eps = 1e-12
    ds = torch.where(torch.abs(d) < eps, torch.where(d >= 0, eps, -eps), d)
    inv = 1.0 / ds  # [n, 3]
    near = far = None
    for ax in range(3):
        ia = inv[:, ax:ax + 1]
        oa = o[:, ax:ax + 1]
        t0 = (amin[None, :, ax] - oa) * ia  # [n, C]
        t1 = (amax[None, :, ax] - oa) * ia
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    hit = ((near <= far) & (far >= tn[:, None]) & (near <= tx[:, None])
           & (tx >= 0.0)[:, None])
    return near, far, hit


def _check(rays8, amin, amax):
    for name, x, width in (("rays8", rays8, 8), ("amin", amin, 3),
                           ("amax", amax, 3)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != width:
            raise ValueError(f"{name} must be [n, {width}], "
                             f"got {tuple(x.shape)}")
        if x.device != rays8.device:
            raise ValueError(f"{name} is on {x.device}, rays8 on "
                             f"{rays8.device}")
    if amin.shape != amax.shape or amin.shape[0] == 0:
        raise ValueError(f"amin {tuple(amin.shape)} and amax "
                         f"{tuple(amax.shape)} must be the same [C, 3], C > 0")
    if rays8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the cull runs on cuda or cpu, not {rays8.device}")


def _launch(entry: str, name: str, rays8, amin, amax, *outs_counts):
    """Launch one cull kernel of the library on the current stream; raises
    if the launch is refused. Boxes go to the kernel as [6, C] rows;
    outs_counts are its outputs' pointers (None a null pointer) and
    counts."""
    from raytracer2_tpu_torch.ops import _build

    lib = _build.library()
    rays8 = rays8.contiguous()
    boxes = torch.cat([amin.T, amax.T]).contiguous()
    with torch.cuda.device(rays8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            rays8.data_ptr(), boxes.data_ptr(),
            *(x.data_ptr() if isinstance(x, torch.Tensor) else x
              for x in outs_counts), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.rt2_error_string(err).decode()} ({err})")


def nearest_box(rays8: torch.Tensor, amin: torch.Tensor,
                amax: torch.Tensor) -> torch.Tensor:
    """[N] i32: per ray the box of least entry distance (first index on
    ties), C where the ray overlaps none. A CUDA tensor launches
    csrc/cull.cu::rt2_nearest_box; a CPU tensor runs the plain version."""
    _check(rays8, amin, amax)
    if rays8.device.type == "cpu":
        return nearest_box_reference(rays8, amin, amax)
    out = torch.empty(rays8.shape[0], dtype=torch.int32, device=rays8.device)
    _launch("rt2_nearest_box", "nearest_box", rays8, amin, amax, out,
            rays8.shape[0], amin.shape[0])
    nearest_box.launches += 1
    return out


nearest_box.launches = 0


def nearest_box_reference(rays8: torch.Tensor, amin: torch.Tensor,
                          amax: torch.Tensor) -> torch.Tensor:
    """Plain torch version of nearest_box, in chunks of rays."""
    _check(rays8, amin, amax)
    n, c = rays8.shape[0], amin.shape[0]
    chunk = max(1024, (chunk_bytes(rays8.device) // (4 * c))
                // 1024 * 1024)
    out = torch.empty(n, dtype=torch.int32, device=rays8.device)
    for s in range(0, n, chunk):
        r = rays8[s:s + chunk]
        e = _entry_exact(r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7], amin, amax)
        nearest, arg = e.min(dim=-1)  # first index among ties, as jnp.argmin
        out[s:s + chunk] = torch.where(torch.isfinite(nearest), arg, c)
    return out


def _bundles(rays8: torch.Tensor, p: int) -> int:
    if p <= 0 or rays8.shape[0] % p:
        raise ValueError(f"{rays8.shape[0]} rays are not whole bundles of {p}")
    return rays8.shape[0] // p


# the float order (bits >= 0 ? bits : bits ^ 0x7FFFFFFF) of -inf: where the
# kernel's per-ray cap starts
NEG_INF_ORDER = -2139095041


def bundle_union(rays8: torch.Tensor, amin: torch.Tensor, amax: torch.Tensor,
                 p: int, cap: bool = False):
    """[B, C] f32: per bundle of p consecutive rays and per box, the least
    entry distance over the bundle's rays, +inf where none overlaps. With
    cap=True, (that table, [N] f32 per ray the farthest exit over the boxes
    it overlaps, -inf where none). A CUDA tensor launches
    csrc/cull.cu::rt2_bundle_union (counted in bundle_union.launches, or
    with the cap in bundle_union.knob_launches["cap"]); a CPU tensor runs
    the plain version."""
    _check(rays8, amin, amax)
    b = _bundles(rays8, p)
    if rays8.device.type == "cpu":
        return bundle_union_reference(rays8, amin, amax, p, cap=cap)
    if p > MAX_BUNDLE:
        raise ValueError(f"bundle size {p} exceeds {MAX_BUNDLE}")
    out = torch.empty((b, amin.shape[0]), dtype=torch.float32,
                      device=rays8.device)
    order = (torch.full((rays8.shape[0],), NEG_INF_ORDER, dtype=torch.int32,
                        device=rays8.device) if cap else None)
    _launch("rt2_bundle_union", "bundle_union", rays8, amin, amax, out,
            order, b, p, amin.shape[0])
    if not cap:
        bundle_union.launches += 1
        return out
    bundle_union.knob_launches["cap"] = (
        bundle_union.knob_launches.get("cap", 0) + 1)
    # float order -> float bits
    return out, torch.where(order >= 0, order, order ^ 0x7FFFFFFF).view(
        torch.float32)


bundle_union.launches = 0
bundle_union.knob_launches = {}


def bundle_union_reference(rays8: torch.Tensor, amin: torch.Tensor,
                           amax: torch.Tensor, p: int, cap: bool = False):
    """Plain torch version of bundle_union, in chunks of whole bundles."""
    _check(rays8, amin, amax)
    b, c = _bundles(rays8, p), amin.shape[0]
    cb = max(1, chunk_bytes(rays8.device) // (4 * c * p))
    out = torch.empty((b, c), dtype=torch.float32, device=rays8.device)
    caps = torch.empty(b * p, dtype=torch.float32, device=rays8.device)
    for b0 in range(0, b, cb):
        r = rays8[b0 * p:(b0 + cb) * p]
        args = (r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7], amin, amax)
        if cap:
            e, caps[b0 * p:(b0 + cb) * p] = _entry_exact_cap(*args)
        else:
            e = _entry_exact(*args)
        out[b0:b0 + cb] = e.reshape(-1, p, c).amin(dim=1)
    return (out, caps) if cap else out

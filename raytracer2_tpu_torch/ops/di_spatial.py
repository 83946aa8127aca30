"""The ReSTIR DI spatial resampling stage as one CUDA kernel
(csrc/di_spatial.cu), for bias-correction modes 0-2.

make_runner(...) closes over the frame's scene data, as make_bridge's
closures do (render/app_bridge.py): the G-buffer planes and view constants
of get_gbuffer_surface, the light table of load_light_info, the skybox of
sample_polymorphic_light, the neighbour offsets and the viewport. The
runner takes restir/di_resampling.py::di_spatial_resampling's own
arguments and returns what it returns; di_spatial_resampling calls it on
CUDA tensors for bias modes 0-2, and runs its plain version,
di_spatial_resampling_plain, otherwise. Every launch counts in the
profiler counter di.spatial.kernel.

The kernel reads the lane inputs (the launch grid, the centre surface,
reservoir and RNG state) through a lane stride each, so the surface's
views into the unpacked G-buffer words need no copy; the planes, the light
table and the offsets it reads contiguous. It has no CPU mode: a tensor
off the card raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytracer2_tpu_torch.restir.di_reservoir import DIReservoir
from raytracer2_tpu_torch.utils import rng as rtrng
from raytracer2_tpu_torch.utils.profiler import count

# the reservoir fields the kernel reads of the centre and of a neighbour
# (nothing reads a canonical weight, nor a neighbour's target pdf)
CENTER_FIELDS = DIReservoir._fields[:-1]
NEIGHBOR_FIELDS = tuple(f for f in CENTER_FIELDS if f != "target_pdf")
# the kernel's pointer slots (csrc/di_spatial.cu: enum Slot), in order
SLOTS = (
    "px", "py", "world_pos", "view_dir", "view_depth", "normal",
    "geo_normal", "diffuse_albedo", "specular_f0", "roughness",
    *(f"c_{f}" for f in CENTER_FIELDS), "seed", "index",
    *(f"r_{f}" for f in NEIGHBOR_FIELDS),
    "g_depth", "g_normals", "g_geo_normals", "g_diffuse_albedo",
    "g_specular_rough",
    "l_center", "l_color_type_and_flags", "l_direction1", "l_direction2",
    "l_scalars", "l_log_radiance", "l_shaping_axis", "l_shaping_cone",
    "skybox", "offsets",
    *(f"o_{f}" for f in DIReservoir._fields), "o_index")
# the centre surface's fields the kernel reads, with their widths
SURFACE = (("world_pos", 3), ("view_dir", 3), ("view_depth", 1),
           ("normal", 3), ("geo_normal", 3), ("diffuse_albedo", 3),
           ("specular_f0", 3), ("roughness", 1))
# DIReservoir's fields: dtype and trailing width
RESERVOIR = {"light_data": (torch.int64, 1), "uv_data": (torch.int64, 1),
             "weight_sum": (torch.float32, 1),
             "target_pdf": (torch.float32, 1), "m": (torch.float32, 1),
             "packed_visibility": (torch.int64, 1),
             "spatial_distance": (torch.int32, 2),
             "age": (torch.int64, 1), "canonical_weight": (torch.float32, 1)}
LIGHT_FIELDS = ("center", "color_type_and_flags", "direction1",
                "direction2", "scalars", "log_radiance", "shaping_axis",
                "shaping_cone")
N_INTS = 19  # enum IntSlot
N_FLOATS = 34  # enum FloatSlot
MAX_BIAS_MODE = 2  # pairwise MIS; mode 3 traces rays and is not the kernel's


def _lane(x: torch.Tensor, n: int, width: int, name: str, dtype,
          dev) -> tuple[torch.Tensor, int]:
    """A lane input as [n] or [n, width] with unit stride within a lane,
    and its lane stride in elements (a view where the layout allows)."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: {x.dtype}, the kernel takes {dtype}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the launch on {dev}")
    if x.numel() != n * width:
        raise ValueError(f"{name}: {tuple(x.shape)} for {n} lanes of "
                         f"width {width}")
    t = x.reshape(n, width) if width > 1 else x.reshape(n)
    if width > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def _plane(x: torch.Tensor, name: str, dtype, dev) -> torch.Tensor:
    if x.dtype != dtype:
        raise TypeError(f"{name}: {x.dtype}, the kernel takes {dtype}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the launch on {dev}")
    return x.contiguous()


def _view_floats(view) -> list[float]:
    """viewport_size, mat_clip_to_view, mat_view_to_world[:3, :3] and the
    camera position, as the float32 values render/rays.py uploads."""
    def f32(x):
        return np.asarray(x, np.float32)

    return [*f32(view.viewport_size).reshape(2),
            *f32(view.mat_clip_to_view).reshape(16),
            *f32(view.mat_view_to_world)[:3, :3].reshape(9),
            *f32(view.camera_direction_or_position)[:3]]


def di_spatial_kernel(px, py, surface, center_sample: DIReservoir,
                      rng: rtrng.RngState, spec, cur_reservoirs: DIReservoir,
                      row_base: int, *, gbuffer, view, width: int,
                      height: int, gbuffer_row_base: int, lights,
                      skybox, neighbor_offsets: torch.Tensor
                      ) -> tuple[DIReservoir, rtrng.RngState]:
    """One launch of csrc/di_spatial.cu: di_spatial_resampling's result
    for spec's bias mode 0-2 (spec: a DISpatialSpec), on the current
    stream. gbuffer: the frame's GBuffer (a row tile whose first row is
    global row gbuffer_row_base under sharding), view its
    PlanarViewConstants, (width, height) the viewport, lights the
    LightInfo table, skybox [h, w, 3] f32 or None (no environment map).
    Raises on what the kernel does not take."""
    mode = int(spec.bias_correction_mode)
    if not 0 <= mode <= MAX_BIAS_MODE:
        raise ValueError(f"bias_correction_mode {mode}: the kernel runs "
                         f"modes 0-{MAX_BIAS_MODE}")
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"di_spatial_kernel runs on cuda, not {dev}")
    shape = tuple(px.shape)
    n = px.numel()
    if tuple(py.shape) != shape:
        raise ValueError(f"py {tuple(py.shape)} against px {shape}")
    mask = int(spec.neighbor_offset_mask)
    if neighbor_offsets.shape[0] <= mask or neighbor_offsets.shape[1:] != (2,):
        raise ValueError(f"neighbor_offsets {tuple(neighbor_offsets.shape)} "
                         f"for the offset mask {mask}")
    n_lights = lights.center.shape[0]
    if n_lights == 0:
        raise ValueError("an empty light table")

    ptrs: dict[str, int] = {}
    strides = dict.fromkeys(SLOTS, 0)
    keep = []  # the tensors behind the pointers, alive until the launch

    def lane_in(slot, x, width, dtype):
        t, s = _lane(x, n, width, slot, dtype, dev)
        keep.append(t)
        ptrs[slot], strides[slot] = t.data_ptr(), s

    def plane_in(slot, x, dtype):
        t = _plane(x, slot, dtype, dev)
        keep.append(t)
        ptrs[slot] = t.data_ptr()
        return t

    lane_in("px", px, 1, torch.int32)
    lane_in("py", py, 1, torch.int32)
    for name, width_ in SURFACE:
        lane_in(name, getattr(surface, name), width_, torch.float32)
    for name in CENTER_FIELDS:
        dtype, width_ = RESERVOIR[name]
        lane_in(f"c_{name}", getattr(center_sample, name), width_, dtype)
    planes = {name: plane_in(f"r_{name}", getattr(cur_reservoirs, name),
                             RESERVOIR[name][0])
              for name in NEIGHBOR_FIELDS}
    lane_in("seed", rng.seed, 1, torch.int64)
    lane_in("index", rng.index, 1, torch.int64)
    r_rows, r_cols = planes["m"].shape
    for name, p in planes.items():
        want = (r_rows, r_cols) + ((2,) if name == "spatial_distance" else ())
        if tuple(p.shape) != want:
            raise ValueError(f"cur_reservoirs.{name}: {tuple(p.shape)}, "
                             f"not {want}")
    g = {name: plane_in(f"g_{name}", getattr(gbuffer, name), dtype)
         for name, dtype in (("depth", torch.float32),
                             ("normals", torch.int64),
                             ("geo_normals", torch.int64),
                             ("diffuse_albedo", torch.int64),
                             ("specular_rough", torch.int64))}
    g_rows, g_cols = g["depth"].shape
    if any(tuple(p.shape) != (g_rows, g_cols) for p in g.values()):
        raise ValueError("the G-buffer planes differ in shape")
    if g_cols < width:
        raise ValueError(f"G-buffer planes of {g_cols} columns for a "
                         f"viewport {width} wide")
    for name in LIGHT_FIELDS:
        t = plane_in(f"l_{name}", getattr(lights, name),
                     torch.float32 if name == "center" else torch.int64)
        if t.shape[0] != n_lights:
            raise ValueError(f"lights.{name}: {t.shape[0]} records, "
                             f"not {n_lights}")
    sky_h = sky_w = 0
    ptrs["skybox"] = None
    if skybox is not None:
        sky = plane_in("skybox", skybox, torch.float32)
        if sky.dim() != 3 or sky.shape[2] != 3:
            raise ValueError(f"skybox {tuple(sky.shape)}, not [h, w, 3]")
        sky_h, sky_w = sky.shape[:2]
    plane_in("offsets", neighbor_offsets, torch.float32)
    for slot in ("r_spatial_distance", "offsets"):
        if ptrs[slot] % 8:
            raise ValueError(f"{slot} is not 8-byte aligned")

    out = {name: (torch.empty(shape + ((2,) if width_ == 2 else ()),
                              dtype=dtype, device=dev))
           for name, (dtype, width_) in RESERVOIR.items()}
    out_index = torch.empty(shape, dtype=torch.int64, device=dev)
    for name, t in out.items():
        ptrs[f"o_{name}"] = t.data_ptr()
    ptrs["o_index"] = out_index.data_ptr()

    ints = [n, width, height, g_rows, g_cols, gbuffer_row_base, r_rows,
            r_cols, row_base, n_lights, sky_h, sky_w, int(spec.num_samples),
            int(spec.num_disocclusion_boost_samples), mode,
            int(spec.active_checkerboard_field), mask,
            int(bool(spec.enable_material_similarity_test)),
            int(bool(spec.discount_naive_samples))]
    floats = [float(spec.target_history_length),
              float(spec.sampling_radius), float(spec.depth_threshold),
              float(spec.normal_threshold), *_view_floats(view)]
    assert len(ints) == N_INTS and len(floats) == N_FLOATS
    if n == 0:
        return DIReservoir(**out), rtrng.RngState(rng.seed, out_index)

    from raytracer2_tpu_torch.ops import _build

    lib = _build.library()
    c_ptrs = (ctypes.c_void_p * len(SLOTS))(*(ptrs[s] for s in SLOTS))
    c_strides = (ctypes.c_longlong * len(SLOTS))(*(strides[s]
                                                   for s in SLOTS))
    c_ints = (ctypes.c_int * N_INTS)(*ints)
    c_floats = (ctypes.c_float * N_FLOATS)(*floats)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt2_di_spatial(c_ptrs, c_strides, c_ints, c_floats,
                                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"di_spatial launch failed: "
                           f"{lib.rt2_error_string(err).decode()} ({err})")
    count("di.spatial.kernel")
    return DIReservoir(**out), rtrng.RngState(rng.seed, out_index)


def make_runner(gbuffer, view, width: int, height: int,
                gbuffer_row_base: int, lights, skybox,
                neighbor_offsets: torch.Tensor):
    """The Bridge's di_spatial_kernel member: di_spatial_kernel over one
    frame's data, called with di_spatial_resampling's arguments (the
    bridge itself excluded)."""
    def run(px, py, surface, center_sample, rng, spec, cur_reservoirs,
            row_base=0):
        return di_spatial_kernel(
            px, py, surface, center_sample, rng, spec, cur_reservoirs,
            row_base, gbuffer=gbuffer, view=view, width=width,
            height=height, gbuffer_row_base=gbuffer_row_base, lights=lights,
            skybox=skybox, neighbor_offsets=neighbor_offsets)

    return run

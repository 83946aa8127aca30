"""ReGIR, world-space light presampling in grid and onion layouts, port of
raytracer2_tpu/restir/regir.py (rtxdi/ReGIR.h, ReGIRSampling.hlsli and the
grid build pass, PresamplingFunctions.hlsli:168-249).

Each cell holds `lights_per_cell` RIS-selected lights weighted by their
contribution to the cell's volume; local-light sampling mode 2 draws
candidates from the surface's jittered cell. Grid: a regular
cellsX*cellsY*cellsZ lattice (ReGIRSampling.hlsli:14-61). Onion:
concentric log-spaced shells of latitude rings whose cells grow with the
distance from the centre (:64-215); the reference ships no builder for its
tables, and build_onion_layout is the JAX package's construction. The RIS
buffer holds [slots, 2] uint32 words (light index, weight bits) as int64.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracer2_tpu_torch.lights.polymorphic import (
    K_POINT, K_TRIANGLE, LightInfo, _create_triangle, gather_light,
    get_light_type, get_shaping, unpack_light_color)
from raytracer2_tpu_torch.lights.shaping import sphere_intersects_shaped_light
from raytracer2_tpu_torch.params import LightBufferRegion
from raytracer2_tpu_torch.utils import brdf
from raytracer2_tpu_torch.utils import rng as rtrng
from raytracer2_tpu_torch.utils.packing import M32


@dataclasses.dataclass(frozen=True)
class OnionLayout:
    """ReGIR_OnionParameters (rtxdi/ReGIRParameters.h:27-94): the layer
    groups and the flat ring tables, Python tuples built on the host."""

    # per layer group
    inner_radius: tuple  # float: the group's innermost shell radius
    layer_scale: tuple  # float: radial ratio between layers
    layer_count: tuple  # int
    equatorial_cell_angle: tuple  # float
    ring_offset: tuple  # int: first ring in the flat ring tables
    ring_count: tuple  # int
    cells_per_layer: tuple  # int
    layer_cell_offset: tuple  # int: global cell index of the group
    # flat ring tables (all groups concatenated)
    ring_cell_angle: tuple  # float
    ring_cell_offset: tuple  # int: offset within the layer
    ring_cell_count: tuple  # int
    # jitter curve (ReGIRSampling.hlsli:66-79)
    cubic_root_factor: float
    linear_factor: float
    num_cells: int

    @property
    def outer_radius(self) -> tuple:
        """Each layer group's outermost shell radius."""
        return tuple(r * s ** c for r, s, c in zip(
            self.inner_radius, self.layer_scale, self.layer_count))


def build_onion_layout(cell_size: float, detail_layers: int = 5,
                       coverage_layers: int = 10, detail_scale: float = 1.26,
                       coverage_scale: float = 1.6) -> OnionLayout:
    """The onion layer and ring tables (ReGIROnionStaticParameters
    defaults: 5 detail + 10 coverage layers, ReGIR.h:52-66). Cell 0 is the
    centre sphere of radius `cell_size`; each group's equatorial cell angle
    is its layerScale - 1 (cells about as wide as they are thick); ring i
    sits at elevation i*angle, rings i > 0 at +-elevation, with azimuthal
    counts shrinking by cos(elevation)."""
    groups = [(detail_layers, detail_scale),
              (coverage_layers, coverage_scale)]
    inner_radius, layer_scale, layer_count = [], [], []
    eq_angle, ring_offset, ring_count = [], [], []
    cells_per_layer, layer_cell_offset = [], []
    r_angle, r_offset, r_count = [], [], []

    inner = cell_size
    next_cell = 1  # cell 0 = centre sphere
    for n_layers, scale in groups:
        angle = scale - 1.0
        n_rings = int(math.pi / 2 / angle + 0.5) + 1
        inner_radius.append(inner)
        layer_scale.append(scale)
        layer_count.append(n_layers)
        eq_angle.append(angle)
        ring_offset.append(len(r_angle))
        ring_count.append(n_rings)
        off = 0
        for i in range(n_rings):
            elev = i * angle
            cnt = max(1, int(round(2.0 * math.pi
                                   * max(math.cos(elev), 1e-3) / angle)))
            r_angle.append(2.0 * math.pi / cnt)
            r_offset.append(off)
            r_count.append(cnt)
            off += cnt * (2 if i > 0 else 1)
        cells_per_layer.append(off)
        layer_cell_offset.append(next_cell)
        next_cell += off * n_layers
        inner *= scale ** n_layers

    return OnionLayout(
        inner_radius=tuple(inner_radius), layer_scale=tuple(layer_scale),
        layer_count=tuple(layer_count),
        equatorial_cell_angle=tuple(eq_angle),
        ring_offset=tuple(ring_offset), ring_count=tuple(ring_count),
        cells_per_layer=tuple(cells_per_layer),
        layer_cell_offset=tuple(layer_cell_offset),
        ring_cell_angle=tuple(r_angle), ring_cell_offset=tuple(r_offset),
        ring_cell_count=tuple(r_count),
        cubic_root_factor=1.0, linear_factor=groups[-1][1] - 1.0,
        num_cells=next_cell)


@dataclasses.dataclass(frozen=True)
class ReGIRGridParameters:
    """ReGIR_CommonParameters + ReGIR_GridParameters, with the onion tables
    when that layout is active (rtxdi/ReGIRParameters.h)."""

    center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    cell_size: float = 1.0
    cells: tuple[int, int, int] = (16, 16, 16)
    lights_per_cell: int = 128
    sampling_jitter: float = 1.0
    num_build_samples: int = 8
    onion: OnionLayout | None = None  # set -> the onion layout

    @property
    def num_cells(self) -> int:
        if self.onion is not None:
            return self.onion.num_cells
        return self.cells[0] * self.cells[1] * self.cells[2]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def get_jitter_scale(params: ReGIRGridParameters, world_pos=None):
    """(ReGIRSampling.hlsli:16-19 grid / :66-79 onion: the onion jitter
    grows with the distance from the centre as its cells do). torch has no
    cbrt: the distance is never negative, so its cube root is a power of
    1/3."""
    if params.onion is None or world_pos is None:
        return params.sampling_jitter * params.cell_size
    o = params.onion
    center = _f32(params.center, world_pos.device)
    d = (torch.linalg.vector_norm(world_pos - center, dim=-1, keepdim=True)
         / params.cell_size)
    scale = torch.clamp_min(torch.maximum(
        torch.pow(d, 1.0 / 3.0) * o.cubic_root_factor,
        d * o.linear_factor), 1.0)
    return scale * params.sampling_jitter * params.cell_size


def _grid_origin(params: ReGIRGridParameters, device):
    center = _f32(params.center, device)
    counts = _i32(params.cells, device)
    return center - counts.to(torch.float32) * (params.cell_size * 0.5), \
        counts


def world_pos_to_cell_index(params: ReGIRGridParameters,
                            world_pos: torch.Tensor) -> torch.Tensor:
    """RTXDI_ReGIR_WorldPosToCellIndex (ReGIRSampling.hlsli:21-34 grid /
    :81-127 onion): int32, -1 outside the covered volume."""
    if params.onion is not None:
        return _onion_world_pos_to_cell_index(params, world_pos)
    origin, counts = _grid_origin(params, world_pos.device)
    cell = torch.floor((world_pos - origin) / params.cell_size).to(
        torch.int32)
    inside = ((cell >= 0) & (cell < counts)).all(dim=-1)
    idx = cell[..., 0] + (cell[..., 1] + cell[..., 2] * counts[1]) \
        * counts[0]
    return torch.where(inside, idx, -1).to(torch.int32)


def cell_index_to_world_pos(params: ReGIRGridParameters,
                            cell_index: torch.Tensor):
    """RTXDI_ReGIR_CellIndexToWorldPos (ReGIRSampling.hlsli:36-60 grid /
    :129-215 onion): (valid, centre [..., 3], radius)."""
    if params.onion is not None:
        return _onion_cell_index_to_world_pos(params, cell_index)
    origin, counts = _grid_origin(params, cell_index.device)
    x = cell_index % counts[0]
    y = (cell_index // counts[0]) % counts[1]
    z = cell_index // (counts[0] * counts[1])
    valid = (cell_index >= 0) & (z < counts[2])
    pos = ((torch.stack([x, y, z], dim=-1).to(torch.float32) + 0.5)
           * params.cell_size + origin)
    radius = torch.full(cell_index.shape,
                        float(np.float32(params.cell_size)
                              * np.sqrt(np.float32(3.0))),
                        device=cell_index.device)
    return valid, pos, radius


def _onion_world_pos_to_cell_index(params: ReGIRGridParameters,
                                   world_pos: torch.Tensor) -> torch.Tensor:
    """(ReGIRSampling.hlsli:81-127), vectorized: the per-group branch is a
    loop over the layer groups with a select; ring tables gather by
    ringOffset + ringIndex."""
    o = params.onion
    dev = world_pos.device
    p = world_pos - _f32(params.center, dev)
    r = torch.linalg.vector_norm(p, dim=-1)
    safe_r = torch.clamp_min(r, 1e-20)
    # RTXDI_CartesianToSpherical (RtxdiMath.hlsli:81-88) + PI shift
    azimuth = torch.atan2(p[..., 2], p[..., 0]) + math.pi
    elevation = torch.asin(torch.clamp(p[..., 1] / safe_r, -1.0, 1.0))

    ca = _f32(o.ring_cell_angle, dev)
    co = _i32(o.ring_cell_offset, dev)
    cc = _i32(o.ring_cell_count, dev)

    idx = torch.full(r.shape, -1, dtype=torch.int32, device=dev)
    for g in reversed(range(len(o.layer_count))):
        inner = o.inner_radius[g]
        scale = o.layer_scale[g]
        layer = torch.floor(torch.clamp_min(
            torch.log(safe_r / inner) / torch.log(_f32(scale, dev)),
            0.0)).to(torch.int32)
        layer = torch.clamp_max(layer, o.layer_count[g] - 1)
        ring = torch.floor(torch.abs(elevation) / o.equatorial_cell_angle[g]
                           + 0.5).to(torch.int32)
        ring = torch.clamp(ring, 0, o.ring_count[g] - 1)
        rr = (o.ring_offset[g] + ring).long()
        cell_angle = ca[rr]
        az = torch.where((layer & 1) != 0, azimuth - cell_angle * 0.5,
                         azimuth)
        az = torch.where(az < 0, az + 2.0 * math.pi, az)
        cell = torch.minimum((az / cell_angle).to(torch.int32), cc[rr] - 1)
        ring_cell_offset = co[rr] + torch.where(
            (elevation < 0) & (ring > 0), cc[rr], 0)
        cand = (cell + ring_cell_offset + layer * o.cells_per_layer[g]
                + o.layer_cell_offset[g])
        in_group = r <= inner * scale ** o.layer_count[g]
        idx = torch.where(in_group, cand, idx)
    return torch.where(r <= o.inner_radius[0], 0, idx).to(torch.int32)


def _sph(rr, a, e):
    """RTXDI_SphericalToCartesian (RtxdiMath.hlsli:90-101)."""
    return torch.stack([rr * torch.cos(a) * torch.cos(e), rr * torch.sin(e),
                        rr * torch.sin(a) * torch.cos(e)], dim=-1)


def _onion_cell_index_to_world_pos(params: ReGIRGridParameters,
                                   cell_index: torch.Tensor):
    """(ReGIRSampling.hlsli:129-215), vectorized; the ring walk is a
    searchsorted over each group's ring-end table."""
    o = params.onion
    dev = cell_index.device
    shape = tuple(cell_index.shape)
    pos = torch.zeros(shape + (3,), device=dev)
    radius = torch.zeros(shape, device=dev)
    ca = _f32(o.ring_cell_angle, dev)
    cc = _i32(o.ring_cell_count, dev)
    co = _i32(o.ring_cell_offset, dev)

    for g in range(len(o.layer_count)):
        r0, r1 = o.ring_offset[g], o.ring_offset[g] + o.ring_count[g]
        cnt = np.asarray(o.ring_cell_count[r0:r1])
        offs = np.asarray(o.ring_cell_offset[r0:r1])
        ends = offs + cnt * np.where(np.arange(len(cnt)) > 0, 2, 1)
        ci = cell_index - o.layer_cell_offset[g]
        layer = torch.div(ci, o.cells_per_layer[g], rounding_mode="floor")
        rem = ci - layer * o.cells_per_layer[g]
        ring = torch.searchsorted(
            torch.as_tensor(ends, dtype=torch.int64, device=dev),
            rem.long().contiguous(), right=True)
        ring = torch.clamp(ring, 0, o.ring_count[g] - 1)
        cell_angle = ca[r0 + ring]
        cell_cnt = cc[r0 + ring]
        cell = rem - co[r0 + ring]
        eq = o.equatorial_cell_angle[g]
        elevation = ring.to(torch.float32) * eq
        elevation = torch.where(cell >= cell_cnt, -elevation, elevation)
        az = (cell.to(torch.float32) + 0.5) * cell_angle
        az = torch.where((layer & 1) != 0, az + cell_angle * 0.5, az)
        az = az - math.pi
        layer_inner = o.inner_radius[g] * torch.pow(
            _f32(o.layer_scale[g], dev), layer.to(torch.float32))
        layer_outer = layer_inner * o.layer_scale[g]
        rmid = (layer_inner + layer_outer) * 0.5

        cell_center = _sph(rmid, az, elevation)
        az_c = az + cell_angle * 0.5
        elev_c = torch.where(elevation == 0, eq * 0.5,
                             (torch.abs(elevation) - eq * 0.5)
                             * torch.sign(elevation))
        corner = _sph(layer_outer, az_c, elev_c)
        rad = torch.linalg.vector_norm(corner - cell_center, dim=-1)

        sel = ((cell_index >= o.layer_cell_offset[g])
               & (ci < o.cells_per_layer[g] * o.layer_count[g]))
        pos = torch.where(sel[..., None], cell_center, pos)
        radius = torch.where(sel, rad, radius)

    radius = torch.where(cell_index == 0, o.inner_radius[0], radius)
    valid = (cell_index >= 0) & (cell_index < o.num_cells)
    center = _f32(params.center, dev)
    return (valid, torch.where(valid[..., None], pos + center, 0.0),
            torch.where(valid, radius, 0.0))


# ---------------------------------------------------------------------------
# Light weight for a volume (PolymorphicLight.glsl:473-490)
# ---------------------------------------------------------------------------

def _average_distance_to_volume(distance, radius):
    """(PolymorphicLight.glsl:129-139)."""
    nonlinear = 1.1547
    return distance + radius * radius ** 2 / torch.clamp_min(
        (distance + radius * nonlinear) ** 2, 1e-20)


def get_light_weight_for_volume(info: LightInfo, volume_center: torch.Tensor,
                                volume_radius) -> torch.Tensor:
    """RAB_GetLightTargetPdfForVolume (bridge:504-507 ->
    PolymorphicLight.glsl:473-490), with the shaped-light sphere-cone cull
    (PolymorphicLight.glsl:175-178)."""
    ltype = get_light_type(info.color_type_and_flags)

    # point lights (:175-184)
    flux = unpack_light_color(info)
    d_point = torch.linalg.vector_norm(volume_center - info.center, dim=-1)
    d_point = _average_distance_to_volume(d_point, volume_radius)
    w_point = brdf.luminance(flux) / torch.clamp_min(d_point ** 2, 1e-20)
    cone_ok = sphere_intersects_shaped_light(
        info.center, 0.0, get_shaping(info), volume_center, volume_radius)
    w_point = torch.where(cone_ok, w_point, 0.0)

    # triangle lights (:302-316)
    base, edge1, edge2, radiance, normal, area = _create_triangle(info)
    dist_to_plane = brdf.dot3(volume_center - base, normal)
    barycenter = base + (edge1 + edge2) / 3.0
    d_tri = torch.linalg.vector_norm(barycenter - volume_center, dim=-1)
    d_tri = _average_distance_to_volume(d_tri, volume_radius)
    solid_angle = torch.clamp_max(
        area / torch.clamp_min(d_tri ** 2, 1e-20), 2.0 * brdf.PI)
    w_tri = torch.where(dist_to_plane < -volume_radius, 0.0,
                        solid_angle * brdf.luminance(radiance))

    w = torch.where(ltype == K_POINT, w_point, 0.0)
    return torch.where(ltype == K_TRIANGLE, w_tri, w)


# ---------------------------------------------------------------------------
# Grid build (PresamplingFunctions.hlsli:168-249)
# ---------------------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its uint32 bits, in int64."""
    return x.view(torch.int32).to(torch.int64) & M32


def presample_regir_grid(rng_seed: int, lights: LightInfo,
                         local_region: LightBufferRegion,
                         params: ReGIRGridParameters) -> torch.Tensor:
    """The ReGIR RIS buffer: [num_cells * lights_per_cell, 2] uint32 words
    (light index, RIS weight bits) as int64, on the lights' device. One
    RIS stream per slot, each drawing `num_build_samples` uniform
    candidates weighted by the light's contribution to the slot's cell."""
    dev = lights.center.device
    n_slots = params.num_cells * params.lights_per_cell
    slot = torch.arange(n_slots, dtype=torch.int64, device=dev)
    cell_index = (slot // params.lights_per_cell).to(torch.int32)
    valid_cell, cell_center, cell_radius = cell_index_to_world_pos(
        params, cell_index)
    cell_radius = cell_radius * (params.sampling_jitter + 1.0)  # (:196)

    state = rtrng.RngState(
        seed=(rtrng.jenkins_hash(slot) + int(rng_seed)) & M32,
        index=torch.ones_like(slot))
    num_lights = max(local_region.num_lights, 1)
    inv_source_pdf = float(num_lights) * (
        1.0 / max(params.num_build_samples, 1))

    selected = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    selected_pdf = torch.zeros(n_slots, device=dev)
    weight_sum = torch.zeros(n_slots, device=dev)
    for _ in range(params.num_build_samples):
        r, state = rtrng.sample_uniform(state)
        light_index = local_region.first_light_index + torch.clamp_max(
            (r * num_lights).to(torch.int64), num_lights - 1)
        info = gather_light(lights, light_index)
        target = get_light_weight_for_volume(info, cell_center, cell_radius)
        ris_w = target * inv_source_pdf
        weight_sum = weight_sum + ris_w
        rr, state = rtrng.sample_uniform(state)
        take = rr * weight_sum < ris_w
        selected = torch.where(take, light_index, selected)
        selected_pdf = torch.where(take, target, selected_pdf)

    weight = torch.where(selected_pdf > 0.0,
                         weight_sum / torch.clamp_min(selected_pdf, 1e-30),
                         0.0)
    weight = torch.where(valid_cell & (local_region.num_lights > 0), weight,
                         0.0)
    return torch.stack([torch.where(weight > 0, selected, 0), _bits(weight)],
                       dim=-1)


def select_light_from_regir_cell(rng: rtrng.RngState,
                                 ris_buffer: torch.Tensor,
                                 cell_index: torch.Tensor,
                                 params: ReGIRGridParameters):
    """RTXDI_SelectLocalLightReGIRRISTile and the tile draw: (light_index,
    inv_source_pdf, valid, rng). cell_index -1 (no cell) is invalid."""
    r, rng = rtrng.sample_uniform(rng)
    in_cell = torch.clamp_max((r * params.lights_per_cell).to(torch.int32),
                              params.lights_per_cell - 1)
    ptr = torch.clamp_min(cell_index, 0) * params.lights_per_cell + in_cell
    # XLA's gather clamps an index past the buffer to its last slot
    entry = ris_buffer[torch.clamp(ptr.long(), 0, ris_buffer.shape[0] - 1)]
    b = entry[..., 1] & M32
    inv_pdf = torch.where(b >= 1 << 31, b - (1 << 32), b).to(
        torch.int32).view(torch.float32)
    valid = (cell_index >= 0) & (inv_pdf > 0.0)
    return entry[..., 0], inv_pdf, valid, rng

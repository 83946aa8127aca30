"""Polymorphic light records and sampling, port of
raytracer2_tpu/lights/polymorphic.py (src/shaders/PolymorphicLight.glsl).

The 48-byte RAB_LightInfo record (PolymorphicLight.glsl:19-36) is kept
field for field as parallel arrays with the reference's encodings (RGB8 +
log-radiance color :62-93, oct-encoded edge directions + f16 lengths for
triangles :345-357). uint32 words are int64 tensors holding [0, 2**32).
calcSample's switch (:429-452) evaluates every type and selects per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.lights import shaping
from raytracer2_tpu_torch.utils import brdf
from raytracer2_tpu_torch.utils import packing as pk

# Light-type codes (PolymorphicLight.glsl:6-13)
K_TRIANGLE = 4
K_DIRECTIONAL = 5
K_ENVIRONMENT = 6
K_POINT = 7

# Packing constants (ShaderParameters.glsl:14-19)
K_TYPE_SHIFT = 24
K_TYPE_MASK = 0xF
K_MIN_LOG2_RADIANCE = -8.0
K_MAX_LOG2_RADIANCE = 40.0

DISTANT_LIGHT_DISTANCE = 1000.0  # (PolymorphicLight.glsl:43)


class LightInfo(NamedTuple):
    """SoA RAB_LightInfo (PolymorphicLight.glsl:19-36) with the shaping
    words (LightShaping.glsl:16-25); all-zero shaping words = unshaped."""

    center: torch.Tensor  # [L, 3] f32
    color_type_and_flags: torch.Tensor  # [L] u32
    direction1: torch.Tensor  # [L] u32 oct
    direction2: torch.Tensor  # [L] u32 oct
    scalars: torch.Tensor  # [L] u32 2xf16
    log_radiance: torch.Tensor  # [L] u32 (u16 used)
    shaping_axis: torch.Tensor  # [L] u32 oct primary axis
    shaping_cone: torch.Tensor  # [L] u32 f16 cosConeAngle | f16 softness << 16
    shaping_ies: torch.Tensor  # [L] u32 IES profile index


def empty_light_info(n: int, *, device) -> LightInfo:
    def u32():
        return torch.zeros(n, dtype=torch.int64, device=device)

    return LightInfo(torch.zeros((n, 3), device=device), u32(), u32(), u32(),
                     u32(), u32(), u32(), u32(), u32())


def gather_light(lights: LightInfo, index: torch.Tensor) -> LightInfo:
    """RAB_LoadLightInfo (bridge:556-559): the records at `index`, read as
    the JAX package reads them: the index wrapped to int32 (a uint32 word
    of 2**31 or more is negative), negative indices read record 0 and
    indices past the table read its last record (XLA's gather clamps), so
    RTXDI_INVALID_LIGHT_INDEX reads the last light."""
    i = (index.long() + (1 << 31)) % (1 << 32) - (1 << 31)
    i = torch.clamp(i, 0, lights.center.shape[0] - 1)
    return LightInfo(*(leaf[i] for leaf in lights))


class LightSample(NamedTuple):
    """PolymorphicLightSample (PolymorphicLight.glsl:49-55)."""

    position: torch.Tensor  # [..., 3]
    normal: torch.Tensor  # [..., 3]
    radiance: torch.Tensor  # [..., 3]
    solid_angle_pdf: torch.Tensor  # [...]
    light_type: torch.Tensor  # [...] int64


def get_light_type(color_type_and_flags: torch.Tensor) -> torch.Tensor:
    """(PolymorphicLight.glsl:57-63)."""
    return (pk.as_u32(color_type_and_flags) >> K_TYPE_SHIFT) & K_TYPE_MASK


def unpack_light_radiance(log_radiance: torch.Tensor) -> torch.Tensor:
    """(PolymorphicLight.glsl:65-68)."""
    lr = (log_radiance & 0xFFFF).to(torch.float32)
    val = torch.exp2((lr - 1.0) / 65534.0
                     * (K_MAX_LOG2_RADIANCE - K_MIN_LOG2_RADIANCE)
                     + K_MIN_LOG2_RADIANCE)
    return torch.where(log_radiance == 0, 0.0, val)


def unpack_light_color(info: LightInfo) -> torch.Tensor:
    """(PolymorphicLight.glsl:70-75)."""
    color = pk.unpack_rgb8_ufloat(info.color_type_and_flags)
    return color * unpack_light_radiance(info.log_radiance & 0xFFFF)[..., None]


def pack_light_color(radiance: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(PolymorphicLight.glsl:77-93): (color bits, log radiance) to OR into
    the record."""
    intensity = radiance.amax(dim=-1)
    log_r = brdf.saturate(
        (torch.log2(torch.clamp_min(intensity, 1e-30)) - K_MIN_LOG2_RADIANCE)
        / (K_MAX_LOG2_RADIANCE - K_MIN_LOG2_RADIANCE))
    packed_radiance = torch.clamp_max(
        torch.ceil(log_r * 65534.0).to(torch.int64) + 1, 0xFFFF)
    unpacked = unpack_light_radiance(packed_radiance)
    normalized = brdf.saturate(
        radiance / torch.clamp_min(unpacked, 1e-30)[..., None])
    color_bits = pk.pack_rgb8_ufloat(normalized)
    zero = intensity <= 0.0
    return (torch.where(zero, 0, color_bits),
            torch.where(zero, 0, packed_radiance))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Triangle lights
# ---------------------------------------------------------------------------

def store_triangle_lights(base: torch.Tensor, edge1: torch.Tensor,
                          edge2: torch.Tensor, radiance: torch.Tensor
                          ) -> LightInfo:
    """StoreTriangleLight (PolymorphicLight.glsl:345-357): center =
    barycenter, edges as oct directions + f16 lengths."""
    color_bits, log_radiance = pack_light_color(radiance)
    len1 = _norm(edge1)
    len2 = _norm(edge2)
    d1 = pk.ndir_to_oct_unorm32(edge1 / torch.clamp_min(len1, 1e-20)[..., None])
    d2 = pk.ndir_to_oct_unorm32(edge2 / torch.clamp_min(len2, 1e-20)[..., None])
    scalars = pk.f32_to_f16_bits(len1) | (pk.f32_to_f16_bits(len2) << 16)
    zero = torch.zeros_like(scalars)
    return LightInfo(
        center=base + (edge1 + edge2) / 3.0,
        color_type_and_flags=color_bits | (K_TRIANGLE << K_TYPE_SHIFT),
        direction1=d1, direction2=d2, scalars=scalars,
        log_radiance=log_radiance, shaping_axis=zero, shaping_cone=zero,
        shaping_ies=zero)


def _create_triangle(info: LightInfo):
    """(PolymorphicLight.glsl:320-343): (base, edge1, edge2, radiance,
    normal, area)."""
    len1 = pk.f16_bits_to_f32(info.scalars)
    len2 = pk.f16_bits_to_f32(info.scalars >> 16)
    edge1 = pk.oct_unorm32_to_ndir(info.direction1) * len1[..., None]
    edge2 = pk.oct_unorm32_to_ndir(info.direction2) * len2[..., None]
    base = info.center - (edge1 + edge2) / 3.0
    radiance = unpack_light_color(info)
    n = brdf.cross(edge1, edge2)
    nlen = _norm(n)
    ok = nlen > 0.0
    normal = torch.where(ok[..., None],
                         n / torch.clamp_min(nlen, 1e-30)[..., None], 0.0)
    area = torch.where(ok, 0.5 * nlen, 0.0)
    return base, edge1, edge2, radiance, normal, area


def triangle_solid_angle_pdf(viewer_pos, sample_pos, sample_normal, area):
    """(PolymorphicLight.glsl:266-279)."""
    l = sample_pos - viewer_pos
    dist = _norm(l)
    l = l / torch.clamp_min(dist, 1e-20)[..., None]
    area_pdf = 1.0 / torch.clamp_min(area, 1e-20)
    cos_theta = torch.clamp(-brdf.dot3(l, sample_normal), 0.0, 1.0)
    return brdf.pdf_area_to_solid_angle(area_pdf, dist,
                                        torch.clamp_min(cos_theta, 1e-20))


def _calc_triangle_sample(info: LightInfo, random, viewer_pos) -> LightSample:
    """(PolymorphicLight.glsl:281-294)."""
    base, edge1, edge2, radiance, normal, area = _create_triangle(info)
    bary = brdf.sample_triangle(random)
    pos = base + edge1 * bary[..., 1:2] + edge2 * bary[..., 2:3]
    pdf = triangle_solid_angle_pdf(viewer_pos, pos, normal, area)
    return LightSample(pos, normal, radiance, pdf,
                       _full(pdf.shape, K_TRIANGLE, pdf.device))


def triangle_light_power(info: LightInfo) -> torch.Tensor:
    """(PolymorphicLight.glsl:297-300)."""
    *_, radiance, _, area = _create_triangle(info)
    return area * brdf.PI * brdf.luminance(radiance)


# ---------------------------------------------------------------------------
# Point, directional and environment lights (the prepare pass creates only
# the environment record; calcSample evaluates every type)
# ---------------------------------------------------------------------------

def store_point_lights(position: torch.Tensor, flux: torch.Tensor,
                       cone_axis: torch.Tensor | None = None,
                       cos_cone_angle: torch.Tensor | None = None,
                       cone_softness: torch.Tensor | None = None
                       ) -> LightInfo:
    """Point-light records (CreatePointLight inverse, PolymorphicLight.glsl:
    186-195: center + packed flux). A cone packs spot shaping into the
    shaping words and sets the enable bit (LightShaping.glsl:16-25); the
    reference never creates shaped lights, and without a cone the words
    stay zero."""
    color_bits, log_radiance = pack_light_color(flux)
    n = position.shape[0]
    zero = _full((n,), 0, position.device)
    type_bits = K_POINT << K_TYPE_SHIFT
    axis = cone = zero
    if cone_axis is not None:
        type_bits |= shaping.K_SHAPING_ENABLE_BIT
        soft = (cone_softness if cone_softness is not None
                else torch.zeros(n, device=position.device))
        axis = pk.ndir_to_oct_unorm32(cone_axis)
        cone = (pk.f32_to_f16_bits(cos_cone_angle)
                | (pk.f32_to_f16_bits(soft) << 16))
    return LightInfo(
        center=position, color_type_and_flags=color_bits | type_bits,
        direction1=zero, direction2=zero, scalars=zero,
        log_radiance=log_radiance, shaping_axis=axis, shaping_cone=cone,
        shaping_ies=zero)


def store_directional_lights(direction: torch.Tensor, radiance: torch.Tensor,
                             half_angle: torch.Tensor) -> LightInfo:
    """Directional records (CreateDirectionalLight inverse,
    PolymorphicLight.glsl:240-252): the oct direction, f16 half angle and
    solid angle."""
    color_bits, log_radiance = pack_light_color(radiance)
    solid_angle = 2.0 * brdf.PI * (1.0 - torch.cos(half_angle))
    n = direction.shape[0]
    zero = _full((n,), 0, direction.device)
    return LightInfo(
        center=torch.zeros((n, 3), device=direction.device),
        color_type_and_flags=color_bits | (K_DIRECTIONAL << K_TYPE_SHIFT),
        direction1=pk.ndir_to_oct_unorm32(direction), direction2=zero,
        scalars=(pk.f32_to_f16_bits(half_angle)
                 | (pk.f32_to_f16_bits(solid_angle) << 16)),
        log_radiance=log_radiance, shaping_axis=zero, shaping_cone=zero,
        shaping_ies=zero)


def _calc_point_sample(info: LightInfo, viewer_pos) -> LightSample:
    """(PolymorphicLight.glsl:154-168)."""
    flux = unpack_light_color(info)
    lv = info.center - viewer_pos
    d2 = torch.clamp_min(brdf.dot3(lv, lv), 1e-20)
    return LightSample(info.center.expand_as(lv), brdf.normalize(-lv),
                       flux / d2[..., None], torch.ones_like(d2),
                       _full(d2.shape, K_POINT, d2.device))


def point_light_power(info: LightInfo) -> torch.Tensor:
    """(PolymorphicLight.glsl:170-172) incl. the shaping flux factor."""
    return (4.0 * brdf.PI * brdf.luminance(unpack_light_color(info))
            * shaping.get_shaping_flux_factor(get_shaping(info)))


def _calc_directional_sample(info: LightInfo, random, viewer_pos
                             ) -> LightSample:
    """(PolymorphicLight.glsl:208-236)."""
    direction = pk.oct_unorm32_to_ndir(info.direction1)
    half_angle = pk.f16_bits_to_f32(info.scalars)
    solid_angle = pk.f16_bits_to_f32(info.scalars >> 16)
    sin_half = torch.sin(half_angle)
    radiance = unpack_light_color(info)
    disk = brdf.sample_disk(random)
    tangent, bitangent = brdf.construct_onb(direction)
    sample_dir = (direction + tangent * (disk[..., 0] * sin_half)[..., None]
                  + bitangent * (disk[..., 1] * sin_half)[..., None])
    pos = viewer_pos - sample_dir * DISTANT_LIGHT_DISTANCE
    pdf = 1.0 / torch.clamp_min(solid_angle, 1e-20)
    return LightSample(pos, direction, radiance, pdf,
                       _full(pdf.shape, K_DIRECTIONAL, pdf.device))


def store_environment_light(texture_size: tuple[int, int], *, device,
                            importance_sampled: bool = True,
                            radiance_scale=(1.0, 1.0, 1.0),
                            rotation: float = 0.0) -> LightInfo:
    """The environment record (CreateEnvironmentLight inverse,
    PolymorphicLight.glsl:414-426); direction2 holds the texture size."""
    color_bits, log_radiance = pack_light_color(
        torch.tensor([radiance_scale], dtype=torch.float32, device=device))
    scalars = (pk.f32_to_f16_bits(torch.tensor([rotation], device=device))
               | ((1 if importance_sampled else 0) << 16))
    zero = _full((1,), 0, device)
    return LightInfo(
        center=torch.zeros((1, 3), device=device),
        color_type_and_flags=color_bits | (K_ENVIRONMENT << K_TYPE_SHIFT),
        direction1=zero,
        direction2=_full((1,), texture_size[0] | (texture_size[1] << 16),
                         device),
        scalars=scalars, log_radiance=log_radiance, shaping_axis=zero,
        shaping_cone=zero, shaping_ies=zero)


def _calc_environment_sample(info: LightInfo, random, viewer_pos, skybox
                             ) -> LightSample:
    """(PolymorphicLight.glsl:368-410)."""
    rotation = pk.f16_bits_to_f32(info.scalars)
    importance = (pk.as_u32(info.scalars) >> 16) != 0
    radiance_scale = unpack_light_color(info)
    tw = (info.direction2 & 0xFFFF).to(torch.float32)
    th = (pk.as_u32(info.direction2) >> 16).to(torch.float32)

    # importance-sampled branch: uv is the pdf-texture coordinate
    uv_is = torch.stack([random[..., 0] + rotation, random[..., 1]], dim=-1)
    dir_is, cos_el = brdf.equirect_uv_to_direction(uv_is)
    pdf_is = (tw * th) / (2.0 * brdf.PI * brdf.PI
                          * torch.clamp_min(cos_el, 1e-6))
    # uniform-sphere branch
    dir_us, pdf_us = brdf.sample_sphere(random)
    tex_uv_us = brdf.direction_to_equirect_uv(dir_us)
    tex_uv_us = torch.stack([tex_uv_us[..., 0] - rotation,
                             tex_uv_us[..., 1]], dim=-1)

    sample_dir = torch.where(importance[..., None], dir_is, dir_us)
    pdf = torch.where(importance, pdf_is, pdf_us)
    tex_uv = torch.where(importance[..., None], random, tex_uv_us)
    if skybox is not None:
        from raytracer2_tpu_torch.scene.scene import sample_equirect

        radiance = radiance_scale * sample_equirect(skybox, tex_uv)
    else:
        # no environment map bound: the light samples black, as the JAX
        # package's get_environment_radiance does
        radiance = torch.zeros_like(radiance_scale.expand_as(sample_dir))
    bad = ~torch.isfinite(radiance.sum(dim=-1))
    radiance = torch.where(bad[..., None], 0.0, radiance)
    return LightSample(viewer_pos + sample_dir * DISTANT_LIGHT_DISTANCE,
                       -sample_dir, radiance, pdf,
                       _full(pdf.shape, K_ENVIRONMENT, pdf.device))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def get_shaping(info: LightInfo) -> shaping.LightShaping:
    """unpackLightShaping (LightShaping.glsl:16-25)."""
    return shaping.unpack_light_shaping(
        info.color_type_and_flags, info.shaping_axis, info.shaping_cone,
        info.shaping_ies)


def calc_sample(info: LightInfo, random: torch.Tensor,
                viewer_pos: torch.Tensor, skybox=None) -> LightSample:
    """Polymorphic dispatch (PolymorphicLight.glsl:429-452): every type is
    evaluated and selected per lane; unknown types give an empty sample.
    Shaping scales the selected radiance where pdf > 0 (:444-448)."""
    ltype = get_light_type(info.color_type_and_flags)
    samples = {
        K_POINT: _calc_point_sample(info, viewer_pos),
        K_TRIANGLE: _calc_triangle_sample(info, random, viewer_pos),
        K_DIRECTIONAL: _calc_directional_sample(info, random, viewer_pos),
        K_ENVIRONMENT: _calc_environment_sample(info, random, viewer_pos,
                                                skybox),
    }

    def sel(field: str) -> torch.Tensor:
        a = getattr(samples[K_POINT], field)
        t = ltype[..., None] if a.dim() > ltype.dim() else ltype
        out = a
        for kind in (K_TRIANGLE, K_DIRECTIONAL, K_ENVIRONMENT):
            out = torch.where(t == kind, getattr(samples[kind], field), out)
        known = ((t == K_POINT) | (t == K_TRIANGLE) | (t == K_DIRECTIONAL)
                 | (t == K_ENVIRONMENT))
        return torch.where(known, out, torch.zeros_like(out))

    pdf = sel("solid_angle_pdf")
    pos = sel("position")
    factor = shaping.evaluate_light_shaping(get_shaping(info), viewer_pos,
                                            pos)
    radiance = sel("radiance") * torch.where(pdf > 0, factor, 1.0)[..., None]
    return LightSample(pos, sel("normal"), radiance, pdf, ltype)


def get_power(info: LightInfo) -> torch.Tensor:
    """(PolymorphicLight.glsl:454-471): only point and triangle lights
    enter the local-light pdf map."""
    ltype = get_light_type(info.color_type_and_flags)
    p = torch.where(ltype == K_POINT, point_light_power(info), 0.0)
    return torch.where(ltype == K_TRIANGLE, triangle_light_power(info), p)

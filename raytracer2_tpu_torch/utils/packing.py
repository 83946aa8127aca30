"""Bit-packing of the G-buffer and light-record formats, port of
raytracer2_tpu/utils/packing.py (src/shaders/packing.glsl, Helpers.glsl,
rtxdi/RtxdiMath.hlsli): unorm fields, R11G11B10 UFLOAT, RGBA8 with gamma
2.2, RGB8, f16 bits and pairs (R16G16, R16G16B16A16), octahedral unorm32
and snorm2x16 normals, LogLuv HDR colour and the Z-curve index math.

torch's uint32 has only partial operator support, so uint32 values are
carried in int64 tensors holding [0, 2**32); every left shift is masked
back to 32 bits.
"""

from __future__ import annotations

import torch

from raytracer2_tpu_torch.utils.readback import constant

M32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its value mod 2**32; a float
    tensor in range truncates toward zero first (astype(uint32))."""
    return x.to(torch.int64) & M32


# ---------------------------------------------------------------------------
# UFLOAT templates (unsigned normalized fixed point stored in N bits)
# ---------------------------------------------------------------------------

def pack_unorm(r: torch.Tensor, bits: int, d: float = 0.5) -> torch.Tensor:
    """Pack [0,1] float into `bits`-bit unorm (ref: packing.glsl:3-17)."""
    mask = (1 << bits) - 1
    v = torch.floor(r * float(mask) + d)
    v = torch.clamp(v, 0.0, float(2**32 - 1))
    return as_u32(v) & mask


def unpack_unorm(r: torch.Tensor, bits: int) -> torch.Tensor:
    """Unpack `bits`-bit unorm to [0,1] float (ref: packing.glsl:12-17)."""
    mask = (1 << bits) - 1
    return (as_u32(r) & mask).to(torch.float32) / float(mask)


def pack_r11g11b10_ufloat(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] floats in [0,1] -> u32 (ref: packing.glsl:46-53)."""
    r = pack_unorm(rgb[..., 0], 11)
    g = pack_unorm(rgb[..., 1], 11) << 11
    b = pack_unorm(rgb[..., 2], 10) << 22
    return (r | g | b) & M32


def unpack_r11g11b10_ufloat(v: torch.Tensor) -> torch.Tensor:
    """u32 -> [..., 3] floats (ref: packing.glsl:38-44)."""
    v = as_u32(v)
    return torch.stack([unpack_unorm(v, 11), unpack_unorm(v >> 11, 11),
                        unpack_unorm(v >> 22, 10)], dim=-1)


def pack_rgba8_gamma_ufloat(rgba: torch.Tensor, gamma: float = 2.2
                            ) -> torch.Tensor:
    """[..., 4] linear floats -> u32, gamma-encoded (ref: packing.glsl:56-66)."""
    e = torch.pow(torch.clamp(rgba, 0.0, 1.0),
                  torch.tensor(1.0 / gamma, dtype=torch.float32))
    r = pack_unorm(e[..., 0], 8)
    g = pack_unorm(e[..., 1], 8) << 8
    b = pack_unorm(e[..., 2], 8) << 16
    a = pack_unorm(e[..., 3], 8) << 24
    return (r | g | b | a) & M32


def unpack_rgba8_gamma_ufloat(v: torch.Tensor, gamma: float = 2.2
                              ) -> torch.Tensor:
    """u32 -> [..., 4] linear floats (ref: packing.glsl:69-79)."""
    v = as_u32(v)
    e = torch.stack([unpack_unorm(v, 8), unpack_unorm(v >> 8, 8),
                     unpack_unorm(v >> 16, 8), unpack_unorm(v >> 24, 8)],
                    dim=-1)
    return torch.pow(torch.clamp(e, 0.0, 1.0),
                     torch.tensor(gamma, dtype=torch.float32))


def pack_rgb8_ufloat(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] floats -> u32 low 24 bits (ref: Helpers.glsl:325-332)."""
    r = pack_unorm(rgb[..., 0], 8)
    g = pack_unorm(rgb[..., 1], 8) << 8
    b = pack_unorm(rgb[..., 2], 8) << 16
    return r | g | b


def unpack_rgb8_ufloat(v: torch.Tensor) -> torch.Tensor:
    """u32 -> [..., 3] floats (ref: Helpers.glsl:317-323)."""
    v = as_u32(v)
    return torch.stack([unpack_unorm(v, 8), unpack_unorm(v >> 8, 8),
                        unpack_unorm(v >> 16, 8)], dim=-1)


# ---------------------------------------------------------------------------
# IEEE f16 bits
# ---------------------------------------------------------------------------

def f32_to_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 holding the 16-bit half representation (f32tof16)."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def f16_bits_to_f32(v: torch.Tensor) -> torch.Tensor:
    """Low 16 bits interpreted as half -> float32 (unpackHalf2x16 lane)."""
    h = as_u32(v) & 0xFFFF
    h = torch.where(h >= 0x8000, h - 0x10000, h).to(torch.int16)
    return h.view(torch.float16).to(torch.float32)


def pack_r16g16_float(rg: torch.Tensor) -> torch.Tensor:
    """[..., 2] floats -> u32 of two halves (ref: packing.glsl:92-97)."""
    return f32_to_f16_bits(rg[..., 0]) | (f32_to_f16_bits(rg[..., 1]) << 16)


def unpack_r16g16_float(v: torch.Tensor) -> torch.Tensor:
    """u32 -> [..., 2] floats (ref: packing.glsl:104-108)."""
    v = as_u32(v)
    return torch.stack([f16_bits_to_f32(v), f16_bits_to_f32(v >> 16)], dim=-1)


def pack_r16g16b16a16_float(rgba: torch.Tensor) -> torch.Tensor:
    """[..., 4] floats -> [..., 2] u32 (ref: packing.glsl:99-102)."""
    return torch.stack([pack_r16g16_float(rgba[..., 0:2]),
                        pack_r16g16_float(rgba[..., 2:4])], dim=-1)


def unpack_r16g16b16a16_float(v: torch.Tensor) -> torch.Tensor:
    """[..., 2] u32 -> [..., 4] floats (ref: packing.glsl:110-113)."""
    return torch.cat([unpack_r16g16_float(v[..., 0]),
                      unpack_r16g16_float(v[..., 1])], dim=-1)


# ---------------------------------------------------------------------------
# Octahedral unit-vector encodings
# ---------------------------------------------------------------------------

def oct_wrap(v: torch.Tensor) -> torch.Tensor:
    """Fold lower-hemisphere oct coords with per-component signs
    (ref: RtxdiMath.hlsli:155-159; the JAX package's note on the app
    shader's scalar-sign variant applies)."""
    vx, vy = v[..., 0], v[..., 1]
    sx = torch.where(vx >= 0.0, 1.0, -1.0)
    sy = torch.where(vy >= 0.0, 1.0, -1.0)
    return torch.stack([(1.0 - torch.abs(vy)) * sx,
                        (1.0 - torch.abs(vx)) * sy], dim=-1)


def ndir_to_oct_signed(n: torch.Tensor) -> torch.Tensor:
    """Unit vector [...,3] -> signed oct coords [...,2]
    (ref: RtxdiMath.hlsli:149-163)."""
    denom = torch.abs(n[..., 0]) + torch.abs(n[..., 1]) + torch.abs(n[..., 2])
    p = n[..., 0:2] / denom[..., None]
    return torch.where(n[..., 2:3] < 0.0, oct_wrap(p), p)


def oct_to_ndir_signed(p: torch.Tensor) -> torch.Tensor:
    """Signed oct coords [...,2] -> unit vector [...,3]
    (ref: RtxdiMath.hlsli:168-181)."""
    px, py = p[..., 0], p[..., 1]
    nz = 1.0 - torch.abs(px) - torch.abs(py)
    t = torch.clamp_min(-nz, 0.0)
    nx = px + torch.where(px >= 0.0, -t, t)
    ny = py + torch.where(py >= 0.0, -t, t)
    n = torch.stack([nx, ny, nz], dim=-1)
    return n / torch.sqrt((n * n).sum(dim=-1, keepdim=True))


def ndir_to_oct_unorm32(n: torch.Tensor) -> torch.Tensor:
    """Unit vector -> u32 (2x16 unorm oct) (ref: Helpers.glsl:263-268)."""
    p = torch.clamp(ndir_to_oct_signed(n) * 0.5 + 0.5, 0.0, 1.0)
    x = as_u32(p[..., 0] * float(0xFFFE))
    y = as_u32(p[..., 1] * float(0xFFFE))
    return (x | (y << 16)) & M32


def oct_unorm32_to_ndir(v: torch.Tensor) -> torch.Tensor:
    """u32 -> unit vector (ref: packing.glsl:126-133)."""
    v = as_u32(v)
    px = torch.clamp((v & 0xFFFF).to(torch.float32) / float(0xFFFE), 0.0, 1.0)
    py = torch.clamp((v >> 16).to(torch.float32) / float(0xFFFE), 0.0, 1.0)
    return oct_to_ndir_signed(torch.stack([px, py], dim=-1) * 2.0 - 1.0)


# ---------------------------------------------------------------------------
# snorm2x16 octahedral variant used by reservoirs (rtxdi/RtxdiMath.hlsli)
# ---------------------------------------------------------------------------

def pack_snorm2x16(v: torch.Tensor) -> torch.Tensor:
    """[..., 2] floats in [-1,1] -> u32 (ref: RtxdiMath.hlsli:135-144);
    a NaN component zeroes both."""
    nan = torch.isnan(v).any(dim=-1, keepdim=True)
    v = torch.where(nan, 0.0, torch.clamp(v, -1.0, 1.0))
    iv = torch.round(v * 32767.0).to(torch.int64)  # half to even, as jnp
    return ((iv[..., 0] & 0xFFFF) | (iv[..., 1] << 16)) & M32


def unpack_snorm2x16(packed: torch.Tensor) -> torch.Tensor:
    """u32 -> [..., 2] floats in [-1,1] (ref: RtxdiMath.hlsli:126-133)."""
    p = as_u32(packed)
    x = p & 0xFFFF
    y = p >> 16
    xy = torch.stack([x, y], dim=-1)
    xy = torch.where(xy >= 0x8000, xy - 0x10000, xy)  # sign-extend 16 bits
    return torch.clamp_min(xy.to(torch.float32) / 32767.0, -1.0)


def encode_normal_snorm2x16(n: torch.Tensor) -> torch.Tensor:
    """Unit vector -> u32 via oct + snorm2x16 (ref: RtxdiMath.hlsli:184-188)."""
    return pack_snorm2x16(ndir_to_oct_signed(n))


def decode_normal_snorm2x16(packed: torch.Tensor) -> torch.Tensor:
    """u32 -> unit vector (ref: RtxdiMath.hlsli:190-195)."""
    return oct_to_ndir_signed(unpack_snorm2x16(packed))


# ---------------------------------------------------------------------------
# Z-curve (Morton order) index math
# ---------------------------------------------------------------------------

def integer_explode(x: torch.Tensor) -> torch.Tensor:
    """Insert 0 between each of the low 16 bits (ref: RtxdiMath.hlsli:33-40)."""
    x = as_u32(x)
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def integer_compact(x: torch.Tensor) -> torch.Tensor:
    """Inverse of integer_explode (ref: RtxdiMath.hlsli:45-52)."""
    x = as_u32(x)
    x = (x & 0x11111111) | ((x & 0x44444444) >> 1)
    x = (x & 0x03030303) | ((x & 0x30303030) >> 2)
    x = (x & 0x000F000F) | ((x & 0x0F000F00) >> 4)
    x = (x & 0x000000FF) | ((x & 0x00FF0000) >> 8)
    return x


def zcurve_to_linear(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x, y) -> Z-curve linear index (ref: RtxdiMath.hlsli:55-58)."""
    return (integer_explode(x) | (integer_explode(y) << 1)) & M32


def linear_to_zcurve(index: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Z-curve linear index -> (x, y) (ref: RtxdiMath.hlsli:61-66)."""
    i = as_u32(index)
    return integer_compact(i), integer_compact(i >> 1)


# ---------------------------------------------------------------------------
# LogLuv HDR colour (the GI reservoirs' packed radiance)
# ---------------------------------------------------------------------------

_RGB_TO_XYZ = (
    (0.4123907992659595, 0.3575843393838780, 0.1804807884018343),
    (0.2126390058715104, 0.7151686787677559, 0.0721923153607337),
    (0.0193308187155918, 0.1191947797946259, 0.9505321522496608))

_XYZ_TO_RGB = (
    (3.240969941904522, -1.537383177570094, -0.4986107602930032),
    (-0.9692436362808803, 1.875967501507721, 0.04155505740717569),
    (0.05563007969699373, -0.2039769588889765, 1.056971514242878))


def _mat3(m, v: torch.Tensor) -> torch.Tensor:
    """[3, 3] float32 matrix m times [..., 3] vectors, as a matrix product."""
    return v @ constant(m, v.device, torch.float32).T


def encode_rgb_to_logluv(color: torch.Tensor) -> torch.Tensor:
    """[..., 3] HDR RGB -> u32 LogLuv (ref: RtxdiMath.hlsli:233-265)."""
    xyz = _mat3(_RGB_TO_XYZ, color)
    y = xyz[..., 1]
    log_y = 409.6 * (torch.log2(torch.clamp_min(y, 1e-30)) + 20.0)
    le = as_u32(torch.clamp(log_y, 0.0, 16383.0))
    inv_denom = 1.0 / (-2.0 * xyz[..., 0] + 12.0 * xyz[..., 1]
                       + 3.0 * (xyz[..., 0] + xyz[..., 1] + xyz[..., 2]))
    u = 4.0 * xyz[..., 0] * inv_denom
    v = 9.0 * xyz[..., 1] * inv_denom
    ue = as_u32(torch.clamp(820.0 * u, 0.0, 511.0))
    ve = as_u32(torch.clamp(820.0 * v, 0.0, 511.0))
    packed = (le << 18) | (ue << 9) | ve
    return torch.where((le == 0) | (y <= 0.0), 0, packed)


def decode_logluv_to_rgb(packed: torch.Tensor) -> torch.Tensor:
    """u32 LogLuv -> [..., 3] HDR RGB (ref: RtxdiMath.hlsli:269-298)."""
    packed = as_u32(packed)
    le = packed >> 18
    log_y = (le.to(torch.float32) + 0.5) / 409.6 - 20.0
    y = torch.exp2(log_y)
    u = (((packed >> 9) & 0x1FF).to(torch.float32) + 0.5) / 820.0
    v = ((packed & 0x1FF).to(torch.float32) + 0.5) / 820.0
    inv_denom = 1.0 / (6.0 * u - 16.0 * v + 12.0)
    x = 9.0 * u * inv_denom
    yy = 4.0 * v * inv_denom
    s = y / torch.clamp_min(yy, 1e-30)
    xyz = torch.stack([s * x, y, s * (1.0 - x - yy)], dim=-1)
    rgb = torch.clamp_min(_mat3(_XYZ_TO_RGB, xyz), 0.0)
    return torch.where((le == 0)[..., None], 0.0, rgb)

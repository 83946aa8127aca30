"""PDF textures, mip pyramids and hierarchical importance sampling, port
of raytracer2_tpu/lights/pdf_texture.py.

- texture sizing (compute_pdf_texture_size, light_passes.rs:700-716);
- the mip chain as 2x2 average pools (mips.glsl);
- the local-light pdf base: flux at each light index's Z-curve texel
  (prepare_lights.comp:121-125);
- the mip-descent sampler RTXDI_SamplePdfMipmap
  (rtxdi/PresamplingFunctions.hlsli:30-94), vectorized over a batch;
- the environment pdf base (luminance x cos(elevation), mips.glsl:44-62);
- the spatial-resampling neighbour offsets (light_passes.rs:671-698).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytracer2_tpu_torch.utils import brdf
from raytracer2_tpu_torch.utils import rng as rtrng
from raytracer2_tpu_torch.utils.packing import linear_to_zcurve

F16_MAX = 65504.0


def compute_pdf_texture_size(max_items: int) -> tuple[int, int, int]:
    """Power-of-2 rectangle fitting max_items (light_passes.rs:700-716).
    Returns (width, height, mips)."""
    w = max(1.0, math.ceil(math.sqrt(max(max_items, 1))))
    w = 2.0 ** math.ceil(math.log2(w))
    h = max(1.0, math.ceil(max(max_items, 1) / w))
    h = 2.0 ** math.ceil(math.log2(h))
    mips = max(1.0, math.log2(max(w, h)) + 1.0)
    return int(w), int(h), int(mips)


def build_mip_chain(base: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """2x2-average mip chain down to 1x1 (mips.glsl). base: [H, W], both
    powers of two."""
    mips = [base]
    cur = base
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        if h > 1 and w > 1:
            cur = cur.reshape(nh, 2, nw, 2).mean(dim=(1, 3))
        elif w > 1:
            cur = cur.reshape(1, nw, 2).mean(dim=2)
        else:
            cur = cur.reshape(nh, 2, 1).mean(dim=1)
        mips.append(cur)
    return tuple(mips)


def environment_pdf_base(skybox: torch.Tensor, out_size: tuple[int, int]
                         ) -> torch.Tensor:
    """Environment pdf mip 0: luminance x cos(elevation), clamped to the
    f16 range (mips.glsl:44-62), the skybox point-sampled into the
    (w, h) = out_size texture."""
    w, h = out_size
    dev = skybox.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    sy = torch.clamp((ys * skybox.shape[0]).long(), 0, skybox.shape[0] - 1)
    sx = torch.clamp((xs * skybox.shape[1]).long(), 0, skybox.shape[1] - 1)
    lum = brdf.luminance(skybox[sy[:, None], sx[None, :]])
    weight = lum * torch.cos((0.5 - ys) * math.pi)[:, None]
    return torch.clamp(weight, 0.0, F16_MAX)


def local_light_pdf_base(flux: torch.Tensor, tex_w: int, tex_h: int
                         ) -> torch.Tensor:
    """Local-light pdf mip 0: flux at the Z-curve texel of each light
    index (prepare_lights.comp:121-125)."""
    x, y = linear_to_zcurve(torch.arange(flux.shape[0], device=flux.device))
    tex = torch.zeros((tex_h, tex_w), device=flux.device)
    tex[y, x] = flux
    return tex


def sample_pdf_mipmap(rng_state: rtrng.RngState, mips: tuple, batch_shape
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 rtrng.RngState]:
    """Vectorized RTXDI_SamplePdfMipmap (PresamplingFunctions.hlsli:30-94):
    descend the quadtree from lastMip-1 to mip 0, choosing one of 4 texels
    per level in proportion to weight. Returns (x, y, pdf, rng); pdf is the
    discrete probability of the chosen texel. Lanes that meet an all-zero
    quad go dead (pdf 0) and stop drawing, as the GLSL returns early."""
    dev = mips[0].device
    h0, w0 = mips[0].shape
    last_mip = max(0, int(math.floor(math.log2(max(w0, h0)))) - 1)
    x = torch.zeros(batch_shape, dtype=torch.int64, device=dev)
    y = torch.zeros(batch_shape, dtype=torch.int64, device=dev)
    pdf = torch.ones(batch_shape, device=dev)
    dead = torch.zeros(batch_shape, dtype=torch.bool, device=dev)

    for level in range(last_mip, -1, -1):
        tex = mips[level]
        th, tw = tex.shape
        x = x * 2
        y = y * 2

        def texel(dx, dy):
            v = tex[torch.clamp(y + dy, 0, th - 1), torch.clamp(x + dx, 0, tw - 1)]
            # out-of-range loads read 0 in the GLSL (robustness2)
            v = torch.where((x + dx < tw) & (y + dy < th), v, 0.0)
            return torch.clamp_min(v, 0.0)

        s00, s01, s10, s11 = texel(0, 0), texel(0, 1), texel(1, 0), texel(1, 1)
        wsum = s00 + s01 + s10 + s11
        newly_dead = wsum <= 0.0
        wsafe = torch.where(newly_dead, 1.0, wsum)
        p00, p01, p10, p11 = s00 / wsafe, s01 / wsafe, s10 / wsafe, s11 / wsafe

        rnd, advanced = rtrng.sample_uniform(rng_state)
        take = ~dead & ~newly_dead
        rng_state = rtrng.RngState(
            rng_state.seed, torch.where(take, advanced.index, rng_state.index))

        in0 = rnd < p00
        r1 = rnd - p00
        in1 = ~in0 & (r1 < p01)
        r2 = r1 - p01
        in2 = ~in0 & ~in1 & (r2 < p10)
        in3 = ~in0 & ~in1 & ~in2
        psel = torch.where(in0, p00,
                           torch.where(in1, p01, torch.where(in2, p10, p11)))
        x = torch.where(take, x + (in2 | in3).long(), x)
        y = torch.where(take, y + (in1 | in3).long(), y)
        pdf = torch.where(take, pdf * psel, pdf)
        dead = dead | newly_dead
        pdf = torch.where(dead, 0.0, pdf)
    return x, y, pdf, rng_state


def evaluate_pdf_texture(mips: tuple, x: torch.Tensor, y: torch.Tensor
                         ) -> torch.Tensor:
    """Normalized pdf of texel (x, y): texel / (average * padded count)
    (RtxdiApplicationBridge.glsl:397-434)."""
    h, w = mips[0].shape
    last_mip = max(0, int(math.floor(math.log2(max(w, h)))))
    avg = mips[min(last_mip, len(mips) - 1)][0, 0]
    total = avg * float((1 << last_mip) ** 2)
    xx = torch.clamp(x, 0, w - 1).long()
    yy = torch.clamp(y, 0, h - 1).long()
    return mips[0][yy, xx] / torch.clamp_min(total, 1e-30)


def fill_neighbor_offsets(count: int = 8192, *, device) -> torch.Tensor:
    """Low-discrepancy disk offsets (light_passes.rs:671-698): plastic
    sequence points inside a disk, stored as i8 of (u - 0.5) * 250 and read
    as snorm, so each float is that byte / 127."""
    offsets = np.zeros((count, 2), np.float32)
    phi2 = 1.0 / 1.3247179572447
    u, v = 0.5, 0.5
    n = 0
    while n < count:
        u += phi2
        v += phi2 * phi2
        if u >= 1.0:
            u -= 1.0
        if v >= 1.0:
            v -= 1.0
        if (u - 0.5) ** 2 + (v - 0.5) ** 2 > 0.25:
            continue
        offsets[n] = (np.float32(int((u - 0.5) * 250.0)) / 127.0,
                      np.float32(int((v - 0.5) * 250.0)) / 127.0)
        n += 1
    return torch.from_numpy(offsets).to(device)

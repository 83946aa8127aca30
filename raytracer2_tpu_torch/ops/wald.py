"""The Wald unit-triangle test as torch ops, rounded as the kernels and XLA
round it.

Each triangle's affine map W = [A | b] carries world space into its unit
space; for a ray (o, d), o' = A @ o + b, d' = A @ d, t = -o'_z / d'_z,
u = o'_x + t d'_x, v = o'_y + t d'_y, and the ray hits where |d'_z| >
1e-12, u >= 0, v >= 0, u + v <= 1 and t lies past t_min. XLA's CPU backend
contracts the JAX package's affines into fused multiply-adds, and the
CUDA walks (csrc/walk_common.cuh) write the same pattern with __fmaf_rn;
fma rounds each of them once, so the plain walks, the XLA engines as torch
ops and the winner decode, which round through this module, equal both
bit for bit.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as __fmaf_rn and XLA's contracted
    multiply-adds round it. The float64 product of two float32 values is
    exact; its sum with c rounds to float64 with an error that a two-sum
    recovers. Rounding that sum to odd (a non-zero error on an even
    mantissa steps one ulp toward the error) keeps the information a
    second rounding needs: round-to-odd in a format at least 2 bits wider
    than the target, then rounding to the target, is one correct
    rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    pv = s - c
    err = (p - pv) + (c - (s - pv))
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    toward = torch.full_like(s, torch.inf).copysign(err)
    return torch.where(step, torch.nextafter(s, toward), s).float()


def fused_tuv(r, w):
    """The Wald test's values of rays r [n, 8] against coefficient rows w
    [n, 12], one pair a row, rounded as XLA's CPU backend rounds the JAX
    package's _intersect_block: each affine x wx + y wy + z wz is fma(z,
    wz, fma(x, wx, y * wy)), u and v are fma(t, dp, op), the bias adds and
    the divide round on their own. (t, u, v, d'_z) [n]."""
    def affine(x, y, z):  # [n, 3]: u, v, z
        return fma(z[:, None], w[:, 6:9],
                   fma(x[:, None], w[:, 0:3], y[:, None] * w[:, 3:6]))

    op = affine(r[:, 0], r[:, 1], r[:, 2]) + w[:, 9:12]
    dp = affine(r[:, 3], r[:, 4], r[:, 5])
    t = -op[:, 2] / dp[:, 2]
    uv = fma(t[:, None], dp[:, :2], op[:, :2])
    return t, uv[:, 0], uv[:, 1], dp[:, 2]


def fused_hit(r, w):
    """The Wald test of rays r [n, 8] against coefficient rows w [n, 12]
    (fused_tuv): (t, hit) [n]."""
    t, uu, vv, dz = fused_tuv(r, w)
    hit = ((torch.abs(dz) > 1e-12) & (uu >= 0.0) & (vv >= 0.0)
           & (uu + vv <= 1.0) & (t > r[:, 6]))
    return t, hit


# float32's unit roundoff, and an absolute term for products that
# underflow into subnormals
_U = 2.0 ** -24
_TINY = 1e-37


def ieee_fp32_matmul(dev) -> bool:
    """True where float32 matmuls on device type dev.type round as IEEE
    float32 (no TF32 or bfloat16 inputs): torch's default."""
    backend = (torch.backends.cuda.matmul if dev.type == "cuda"
               else torch.backends.mkldnn.matmul)
    prec = getattr(backend, "fp32_precision", None)
    if prec is None:  # a torch without the fp32_precision settings
        return torch.get_float32_matmul_precision() == "highest"
    if prec == "none":
        prec = torch.backends.fp32_precision
    return prec in ("ieee", "none")


def hit_test(r, wr):
    """The Wald unit-triangle test of rays r [nb, P, 8] against rows wr
    [nb, 12, 1, W]: (t, hit) [nb, P, W] with hit = |d'_z| > 1e-12, u >= 0,
    v >= 0, u + v <= 1, t > t_min, rounded as fused_hit rounds it (the
    pattern the kernels' csrc/walk_common.cuh writes with __fmaf_rn), so
    the three agree bit for bit on hit, and on t wherever hit is true.

    The fused roundings cost float64 work, so a float32 pass in any order
    comes first and picks the lanes that need them. Any float32 order of a
    3-term affine plus a bias, with or without contractions, lies within
    4.01 u S of the exact value (u = 2^-24, S the sum of the terms'
    magnitudes, here bounded by |o|_1 max|w| + max|bias| for the origin's
    affines and |d|_1 max|w| for the direction's), so any two orders
    differ by at most 16 u S. The bounds carry that through the divide
    and the two multiply-adds (with a quarter more for second-order terms
    and their own roundings), and a lane leaves the fused pass only if
    even its farthest fused values miss. Elsewhere t is a float32 estimate
    and hit is false.

    The pass computes the six affines as two batched matrix products,
    which hold to that bound only in IEEE float32: it raises where
    float32 matmuls on the rays' device may round their inputs to TF32 or
    bfloat16."""
    if not ieee_fp32_matmul(r.device):
        raise RuntimeError(
            "the plain Wald test needs IEEE float32 matmuls on "
            f"{r.device.type}; set torch.backends.cuda.matmul.fp32_precision "
            "or torch.backends.mkldnn.matmul.fp32_precision to 'ieee'")
    nb, wd = wr.shape[0], wr.shape[-1]
    coef = wr.reshape(nb, 12, wd)
    # [nb, P, 3W]: the u, v and z affines side by side (row k*3 + c of wr
    # is input k of output c, so [k, c*W + lane] is a plain reshape)
    o1 = torch.cat([r[..., 0:3], torch.ones_like(r[..., 0:1])], dim=-1)
    op_u, op_v, op_z = torch.bmm(o1, coef.reshape(nb, 4, 3 * wd)).split(
        wd, dim=-1)
    dp_u, dp_v, dp_z = torch.bmm(
        r[..., 3:6], coef[:, :9].reshape(nb, 3, 3 * wd)).split(wd, dim=-1)
    ox, oy, oz, dx, dy, dz, tn = (r[..., i:i + 1] for i in range(7))
    t = torch.div(op_z, dp_z).neg_()
    uu = op_u.addcmul_(t, dp_u)
    vv = op_v.addcmul_(t, dp_v)

    # x = 20 u (S_o + |t| S_d) and e_dp = 16 u S_d, for all three affines
    w_max = wr[:, :9].abs().amax(dim=1)
    b20 = wr[:, 9:12].abs().amax(dim=1) * (20 * _U) + _TINY
    ro20 = (ox.abs() + oy.abs() + oz.abs()) * (20 * _U)
    rd = dx.abs() + dy.abs() + dz.abs()
    ta = t.abs()
    e_dp = (rd * (16 * _U)) * w_max
    x = ta * (rd * (20 * _U))
    x += ro20
    x *= w_max
    x += b20
    dz_a = dp_z.abs_()
    # |t_fused - t| <= 1.25 (16 u S_o + |t| 16 u S_d) / (|d'_z| - e_dp)
    # + 10 u |t|, unbounded (inf) unless |d'_z| clears its own error
    e_t = torch.sub(dz_a, e_dp).clamp_min_(0.0)
    torch.div(x, e_t, out=e_t).add_(ta, alpha=10 * _U)
    # |u_fused - u| and |v_fused - v|, with |op| and |dp| at most S_o and
    # S_d (1 + 64 u)
    e_b = e_dp * (4 + 1 / (16 * _U))
    e_b.mul_(e_t).add_(x, alpha=1.28)
    # a test that a rounding could tip is strict, and each is false on a
    # NaN, so such a lane keeps to the fused pass
    miss = dz_a.add_(e_dp) < 1e-12
    miss |= ta.copy_(t).add_(e_t) < tn
    miss |= torch.minimum(uu, vv, out=e_dp) < e_t.copy_(e_b).neg_()
    miss |= torch.add(uu, vv, out=x) > e_b.mul_(3).add_(1.0 + 2.0 ** -19)
    lanes = (~miss).nonzero(as_tuple=True)
    hit = torch.zeros(miss.shape, dtype=torch.bool, device=miss.device)
    if lanes[0].numel():
        rows = r.expand(*miss.shape[:2], 8)[lanes[0], lanes[1]]
        coeffs = wr[lanes[0], :, 0, lanes[2]]
        t_f, hit_f = fused_hit(rows, coeffs)
        t.index_put_(lanes, t_f)
        hit.index_put_(lanes, hit_f)
    return t, hit


def hit_test_mm(r, wr):
    """The Wald test as JAX's _intersect_block_mm writes it (mm=True): the
    six affines of rays r [nb, P, 8] against rows wr [nb, 12, 1, W] as
    float32 matrix products [o | 1 ; d | 0] @ W_c, t = -o'_z / d'_z, u =
    o'_u + t d'_u and v alike rounded twice (unfused). (t, hit) [nb, P, W]
    with hit = |d'_z| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > t_min.

    The plain version of the walks' tensor-core form: the products' sums
    round in the matmul's own order, so the kernel (3xTF32) agrees with it
    only up to rounding ties. Raises unless float32 matmuls on the rays'
    device are IEEE float32, as hit_test does."""
    if not ieee_fp32_matmul(r.device):
        raise RuntimeError(
            "the mm Wald test needs IEEE float32 matmuls on "
            f"{r.device.type}; set torch.backends.cuda.matmul.fp32_precision "
            "or torch.backends.mkldnn.matmul.fp32_precision to 'ieee'")
    nb, p, wd = r.shape[0], r.shape[1], wr.shape[-1]
    # [nb, 4, 3W]: input k of the u, v and z outputs side by side
    coef = wr.reshape(nb, 4, 3 * wd)
    ray_mat = torch.cat([
        torch.cat([r[..., 0:3], torch.ones_like(r[..., 0:1])], dim=-1),
        torch.cat([r[..., 3:6], torch.zeros_like(r[..., 0:1])], dim=-1)],
        dim=1)  # [nb, 2P, 4]
    out = torch.bmm(ray_mat, coef)
    op_u, op_v, op_z = out[:, :p].split(wd, dim=-1)
    dp_u, dp_v, dp_z = out[:, p:].split(wd, dim=-1)
    t = -op_z / dp_z
    uu = op_u + t * dp_u
    vv = op_v + t * dp_v
    hit = ((torch.abs(dp_z) > 1e-12) & (uu >= 0.0) & (vv >= 0.0)
           & (uu + vv <= 1.0) & (t > r[..., 6:7]))
    return t, hit

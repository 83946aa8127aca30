"""The exact cull's dense passes (raytracer2_tpu_torch/ops/cull.py: B3
nearest_box, B4 bundle_union) against the JAX package's Pallas kernels
(raytracer2_tpu/ops/pallas_cull.py) in interpret mode, and the candidate
prep that runs through them.

The rays and boxes are seeded numpy arrays with the edge cases of the slab
arithmetic: axis-parallel and near-zero directions, rays that start inside
a box or on its face, flat boxes, duplicate boxes that force ties, dead
rays (t_max < 0), empty segments and NaN rays. Indices must be equal and
the union table equal bit for bit (signed zeros included).

The `cuda`-marked tests hold each kernel to its plain version on the card
and skip here; this file imports JAX only inside the tests that compare
with it, so on a machine with a card and no JAX

    python -m pytest --noconftest tests/test_torch_cull.py -q -m cuda

runs them.
"""

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch.ops import cull

CPU = torch.device("cpu")
P = 32  # rays per bundle
N = 4096  # a whole grid step of the Pallas key kernel


def _boxes(rng, c):
    """[C, 3] corners: random boxes, some flat on one axis, and boxes 3,
    10 and 11 the same box (ties)."""
    lo = rng.uniform(-5, 5, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.05, 2.0, (c, 3)).astype(np.float32)
    flat = rng.integers(0, 3, c)
    sel = rng.uniform(size=c) < 0.15
    hi[sel, flat[sel]] = lo[sel, flat[sel]]
    for dup in (10, 11):
        lo[dup], hi[dup] = lo[3], hi[3]
    return lo, hi


def _rays(rng, lo, hi, n=N):
    """[N, 8] rays with the slab test's edge cases; returns (rays8, number
    of NaN rays)."""
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(n, 1e-3, np.float32)
    tx = np.where(rng.uniform(size=n) < 0.5, 1e5,
                  rng.uniform(0.5, 8, n)).astype(np.float32)
    i = np.arange(n)
    ax = i % 3
    d[i % 17 == 1, ax[i % 17 == 1]] = 0.0  # axis-parallel
    d[i % 17 == 2, ax[i % 17 == 2]] = -0.0
    d[i % 17 == 3, ax[i % 17 == 3]] = 1e-13  # below the 1e-12 guard
    d[i % 17 == 4, ax[i % 17 == 4]] = -3e-13
    d[i % 23 == 5] = [0.0, 0.0, 1.0]  # along an axis
    inside = i % 13 == 6  # start inside box 3 (and its duplicates)
    o[inside] = 0.5 * (lo[3] + hi[3])
    face = np.nonzero(i % 19 == 7)[0]  # start on a box face
    o[face, ax[face]] = lo[face % len(lo), ax[face]]
    tx[i % 29 == 8] = -1.0  # dead, as padding
    tx[i % 31 == 9] = 0.0005  # empty segment: t_max < t_min
    tn[i % 37 == 10] = 3.0  # segments starting late
    nan = (i % 41 == 11) | (i % 43 == 12) | (i % 47 == 13)
    o[i % 41 == 11, 0] = np.nan
    d[i % 43 == 12, 1] = np.nan
    tx[i % 47 == 13] = np.nan
    rays8 = np.concatenate([o, d, tn[:, None], tx[:, None]], axis=1)
    return np.ascontiguousarray(rays8, np.float32), int(nan.sum())


def _case(seed, c):
    rng = np.random.default_rng(seed)
    lo, hi = _boxes(rng, c)
    rays8, n_nan = _rays(rng, lo, hi)
    assert n_nan > 0
    return rays8, lo, hi


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# C = 256 fills whole 128-lane rows of the Pallas box table; C = 200 pads it
# with far-away boxes, whose index the JAX callers clamp to C
@pytest.mark.parametrize("c", [256, 200])
def test_nearest_box_matches_pallas_key_kernel(c):
    from raytracer2_tpu.ops import pallas_cull as pc
    import jax.numpy as jnp

    rays8, lo, hi = _case(60 + c, c)
    want = np.minimum(np.asarray(pc.nearest_box_pallas(
        jnp.asarray(rays8), pc.box_rows(jnp.asarray(lo), jnp.asarray(hi)),
        interpret=True)), c)
    got = cull.nearest_box_reference(*_t(rays8, lo, hi)).numpy()
    np.testing.assert_array_equal(got, want)
    # the cases bite: misses, ties to the first of the duplicate boxes
    assert (got == c).sum() > 0 and (got < c).sum() > N // 4
    inside = np.arange(N) % 13 == 6
    assert (got[inside] == 3).mean() > 0.5
    assert not np.isin(got, (10, 11)).any()


@pytest.mark.parametrize("c", [256, 200])
def test_bundle_union_matches_pallas_union_kernel(c):
    from raytracer2_tpu.ops import pallas_cull as pc
    import jax.numpy as jnp

    rays8, lo, hi = _case(70 + c, c)
    want = np.asarray(pc.bundle_union_pallas(
        jnp.asarray(rays8), pc.box_rows(jnp.asarray(lo), jnp.asarray(hi)),
        p=P, interpret=True))[:, :c]
    got = cull.bundle_union_reference(*_t(rays8, lo, hi), P).numpy()
    assert got.shape == (N // P, c)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isinf(got).any() and (got == 0.0).any() and np.isfinite(
        got).mean() > 0.05
    assert not np.signbit(got).any()  # no -0, no negative entry


def test_plain_passes_ignore_their_chunking(monkeypatch):
    """The plain versions chunk rays and bundles; the chunk size changes
    no value."""
    rays8, lo, hi = _t(*_case(80, 256))
    key = cull.nearest_box_reference(rays8, lo, hi)
    union = cull.bundle_union_reference(rays8, lo, hi, P)
    monkeypatch.setattr(cull, "CULL_CHUNK_BYTES", 4 * 256 * 3 * P)
    np.testing.assert_array_equal(
        cull.nearest_box_reference(rays8, lo, hi).numpy(), key.numpy())
    np.testing.assert_array_equal(
        cull.bundle_union_reference(rays8, lo, hi, P).numpy().view(np.uint32),
        union.numpy().view(np.uint32))


def _fast_path(rays8, lo, hi):
    """csrc/cull.cu's finite fast path of B3 in plain torch: NaN-dropping
    fmin/fmax (as CUDA's fminf/fmaxf), the clamp as fmax(near, 0), and
    the t_max compare folded into lim = nextafter(t_max, +inf); a box is
    taken on an entry below lim, the first index on ties. Returns (entry
    [n, C] where taken, else +inf; index [n], C where none)."""
    o, d, tn, tx = rays8[:, 0:3], rays8[:, 3:6], rays8[:, 6], rays8[:, 7]
    eps = 1e-12
    ds = torch.where(torch.abs(d) < eps, torch.where(d >= 0, eps, -eps), d)
    inv = 1.0 / ds
    near = far = None
    for ax in range(3):
        t0 = (lo[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t1 = (hi[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        lo_t, hi_t = torch.fmin(t0, t1), torch.fmax(t0, t1)
        near = lo_t if near is None else torch.fmax(near, lo_t)
        far = hi_t if far is None else torch.fmin(far, hi_t)
    e = torch.fmax(near, torch.zeros(()))
    lim = torch.where(tx >= 0, torch.nextafter(tx, torch.tensor(torch.inf)),
                      -torch.inf)
    take = (near <= far) & (far >= tn[:, None]) & (e < lim[:, None])
    e = torch.where(take, e, torch.inf)
    best, arg = e.min(dim=-1)
    return e, torch.where(torch.isfinite(best), arg, lo.shape[0])


def _finite_rays(rng, lo, hi, n=N):
    """_rays' edge cases without NaN, plus origins far out (slab distances
    that overflow to infinities), t_max of +inf, +0 and -0, and origins on
    box faces (entries of -0 and +0)."""
    rays8, _ = _rays(rng, lo, hi, n)
    rays8 = rays8[np.isfinite(rays8).all(axis=1)].copy()
    m = rays8.shape[0]
    i = np.arange(m)
    rays8[i % 53 == 14, 0] = 3e38  # (b - o) * inv overflows
    rays8[i % 59 == 15, 1] = -3.3e38
    rays8[i % 61 == 16, 7] = np.inf
    rays8[i % 67 == 17, 7] = 0.0
    rays8[i % 71 == 18, 7] = -0.0
    face = i % 7 == 5
    rays8[face, 0] = hi[i[face] % len(hi), 0]
    rays8[face, 3] = -1.0  # leaving through the face: entry -0 or +0
    return np.ascontiguousarray(rays8), m


@pytest.mark.parametrize("c", [256, 300])
def test_fast_path_min_max_matches_entry_exact(c):
    """On finite rays and boxes, B3's fast path (plain fmin/fmax, the
    folded t_max compare) gives _entry_exact's entries as numbers (a zero
    may change sign, which no compare sees) and nearest_box_reference's
    index bit for bit. On NaN rays the same arithmetic would not: that is
    why the kernel keeps the NaN-propagating loop for them."""
    rng = np.random.default_rng(120 + c)
    lo, hi = _boxes(rng, c)
    lo[7], hi[7] = 1e30, -1e30  # an empty cluster's box
    rays8, m = _finite_rays(rng, lo, hi)
    r, tlo, thi = _t(rays8, lo, hi)
    want_e = cull._entry_exact(r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7],
                               tlo, thi)
    got_e, got_i = _fast_path(r, tlo, thi)
    np.testing.assert_array_equal(got_e.numpy() == want_e.numpy(), True)
    np.testing.assert_array_equal(
        got_i.numpy(), cull.nearest_box_reference(r, tlo, thi).numpy())
    # the cases bite: overflowed slabs, hits, misses, zero entries, ties
    assert np.isinf(got_e.numpy()).any() and (got_i.numpy() < c).mean() > 0.2
    assert (got_i.numpy() == c).any() and (want_e.numpy() == 0.0).any()
    assert not np.isin(got_i.numpy(), (10, 11)).any()
    nan_rays, _ = _rays(np.random.default_rng(5), lo, hi)
    nan_rays = nan_rays[np.isnan(nan_rays[:, :6]).any(axis=1)
                        & (nan_rays[:, 7] >= 0)]
    nr = torch.from_numpy(np.ascontiguousarray(nan_rays))
    assert (_fast_path(nr, tlo, thi)[1]
            != cull.nearest_box_reference(nr, tlo, thi)).any()


def _union_fast_path(rays8, lo, hi, p):
    """csrc/cull.cu's fast loop of B4 in plain torch, for finite rays and
    boxes: each box's corners sorted per axis, on each axis the near corner
    chosen by the sign of the ray's inv (lo where inv > 0, hi where inv <
    0) in place of the slab's min and max, NaN-dropping fmax/fmin across the
    axes, per bundle and box the least raw near over the hits, and the
    clamp to +0 once, at the store. Returns (table [B, C], the raw least
    near [B, C])."""
    o, d, tn, tx = rays8[:, 0:3], rays8[:, 3:6], rays8[:, 6], rays8[:, 7]
    eps = 1e-12
    ds = torch.where(torch.abs(d) < eps, torch.where(d >= 0, eps, -eps), d)
    inv = 1.0 / ds
    s_lo, s_hi = torch.fmin(lo, hi), torch.fmax(lo, hi)
    neg = (inv < 0)[:, None, :]  # [n, 1, 3]
    t_near = (torch.where(neg, s_hi, s_lo) - o[:, None]) * inv[:, None]
    t_far = (torch.where(neg, s_lo, s_hi) - o[:, None]) * inv[:, None]
    near = torch.fmax(torch.fmax(t_near[..., 0], t_near[..., 1]),
                      t_near[..., 2])
    far = torch.fmin(torch.fmin(t_far[..., 0], t_far[..., 1]), t_far[..., 2])
    hit = ((near <= far) & (far >= tn[:, None]) & (near <= tx[:, None])
           & (tx >= 0.0)[:, None])
    best = torch.where(hit, near, torch.inf).reshape(-1, p, lo.shape[0])
    best = best.amin(dim=1)
    return torch.where(best > 0.0, best, 0.0), best


@pytest.mark.parametrize("c", [256, 300])
def test_union_fast_path_matches_entry_exact(c):
    """On finite rays and boxes, B4's fast loop (corners chosen per octant,
    plain fmin/fmax, the clamp moved to the store) gives
    bundle_union_reference's table bit for bit, +0 included, though its
    raw minima hold negative entries and -0; on an empty cluster's
    inverted box too. On NaN rays the same arithmetic would not: that is
    why the kernel keeps entry() for them."""
    rng = np.random.default_rng(140 + c)
    lo, hi = _boxes(rng, c)
    lo[7], hi[7] = 1e30, -1e30  # an empty cluster's box
    rays8, m = _finite_rays(rng, lo, hi)
    r, tlo, thi = _t(rays8[:m // P * P], lo, hi)
    want = cull.bundle_union_reference(r, tlo, thi, P).numpy()
    got, raw = _union_fast_path(r, tlo, thi, P)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # the cases bite: zeros that the clamp makes +0 from a negative or -0
    # least near, misses, and the inverted box's hits
    raw = raw.numpy()
    assert (want == 0.0).any() and np.isinf(want).any()
    assert (raw < 0).any() and (np.signbit(raw) & (raw == 0.0)).any()
    assert np.isfinite(want[:, 7]).any()
    nan_rays, _ = _rays(np.random.default_rng(6), lo, hi)
    nr = torch.from_numpy(np.ascontiguousarray(nan_rays))
    assert (_union_fast_path(nr, tlo, thi, P)[0].numpy().view(np.uint32)
            != cull.bundle_union_reference(nr, tlo, thi, P).numpy()
            .view(np.uint32)).any()


def test_wrappers_dispatch_on_device():
    """A CPU tensor runs the plain version (no launch counted); any other
    device launches the kernel or raises, and never falls back."""
    rays8, lo, hi = _t(*_case(81, 256))
    counts = cull.nearest_box.launches, cull.bundle_union.launches
    np.testing.assert_array_equal(
        cull.nearest_box(rays8, lo, hi).numpy(),
        cull.nearest_box_reference(rays8, lo, hi).numpy())
    np.testing.assert_array_equal(
        cull.bundle_union(rays8, lo, hi, P).numpy(),
        cull.bundle_union_reference(rays8, lo, hi, P).numpy())
    assert (cull.nearest_box.launches, cull.bundle_union.launches) == counts
    meta = tuple(x.to("meta") for x in (rays8, lo, hi))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cull.nearest_box(*meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cull.bundle_union(*meta, P)
    with pytest.raises(TypeError):
        cull.nearest_box(rays8.double(), lo, hi)
    with pytest.raises(ValueError, match="whole bundles"):
        cull.bundle_union(rays8[:-1], lo, hi, P)


@pytest.mark.parametrize("cull_kernel", [False, True])
def test_prepare_bundles_exact_matches_jax_prep(tmp_path, cull_kernel):
    """The exact prep through nearest_box and bundle_union gives JAX's
    Prep, with its XLA dense passes and with its Pallas kernels
    (cull_kernel=True, interpret mode): the same permutation, rays,
    candidate lists and overflow flags."""
    import jax.numpy as jnp
    from raytracer2_tpu.models import procedural as proc
    from raytracer2_tpu.ops import cluster as jcluster
    from raytracer2_tpu.ops import pallas_traverse as ptm
    from raytracer2_tpu.scene import gltf
    from raytracer2_tpu.scene.scene import build_scene
    from raytracer2_tpu_torch import convert
    from raytracer2_tpu_torch.ops import cuda_traverse as ct

    p = tmp_path / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=2, lat=6, lon=8))
    j_scene = build_scene(gltf.load_file(p))
    jc = jcluster.build_clusters(j_scene.tri_v0, j_scene.tri_edge1,
                                 j_scene.tri_edge2, cluster_size=4)
    tc = convert.clusters_from_numpy(convert.to_numpy_tree(jc), device=CPU)
    rng = np.random.default_rng(82)
    n = 256
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = (rng.normal(scale=0.5, size=(n, 3)) - o / 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(n, 1e-3, np.float32)
    tx = np.full(n, 1e5, np.float32)
    tx[::7] = -1.0
    smin = np.array(jnp.min(jc.aabb_min, 0))
    smax = np.array(jnp.max(jc.aabb_max, 0))
    for presorted in (False, True):
        want = ptm._prepare_bundles_exact(
            jc, *map(jnp.asarray, (o, d, tn, tx)), smin, smax, P, presorted,
            16, cull_kernel=cull_kernel, interpret=True)
        got = ct.prepare_bundles_exact(tc, *_t(o, d, tn, tx),
                                       *_t(smin, smax), P, presorted, 16)
        (perm, wo, wd, wtn, wtx, idx_flat, _, cand_t, count, _, _, kp, _,
         ovf) = want
        b = n // P
        if presorted:
            assert got.perm is None
        else:
            np.testing.assert_array_equal(got.perm.numpy(), np.asarray(perm))
        for g, w in ((got.o, wo), (got.d, wd), (got.tn, wtn), (got.tx, wtx)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:n])
        np.testing.assert_array_equal(got.cand_idx.numpy(),
                                      np.asarray(idx_flat)[:b, :16])
        np.testing.assert_array_equal(
            got.cand_t.numpy(), np.asarray(cand_t).reshape(-1, kp)[:b, :16])
        np.testing.assert_array_equal(got.cand_count.numpy(),
                                      np.asarray(count)[:b])
        np.testing.assert_array_equal(got.overflowed.numpy(),
                                      np.asarray(ovf)[:b])
        assert got.overflowed.any() and (got.cand_count > 0).sum() >= b // 2


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cull kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 200, 3072])
def test_nearest_box_kernel_matches_plain_version_on_card(dev, c):
    rays8, lo, hi = (x.to(dev) for x in _t(*_case(90 + c, c)))
    launches = cull.nearest_box.launches
    got = cull.nearest_box(rays8, lo, hi)
    torch.cuda.synchronize()
    assert cull.nearest_box.launches == launches + 1
    want = cull.nearest_box_reference(rays8, lo, hi)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _mixed_warp_case(seed, c):
    """Finite rays (_finite_rays) with NaN and infinite ones mixed into
    every warp of the kernel's layout (thread t holds rays t, t + 128, t +
    256, t + 384 of each 512), origins on box planes, duplicate boxes
    across a 256-box tile boundary (255 and 256, 3 and 300), and an empty
    cluster's box (lo 1e30 > hi -1e30)."""
    rng = np.random.default_rng(seed)
    lo, hi = _boxes(rng, c)
    lo[256], hi[256] = lo[255], hi[255]
    lo[300], hi[300] = lo[3], hi[3]
    lo[7], hi[7] = 1e30, -1e30
    rays8, m = _finite_rays(rng, lo, hi, n=2 * N)
    i = np.arange(m)
    rays8[i % 32 == 5, 0] = np.nan  # one NaN ray in every warp
    rays8[i % 96 == 6, 4] = np.inf  # infinite direction
    rays8[i % 96 == 38, 2] = -np.inf  # infinite origin
    rays8[i % 512 == 9, 3] = np.nan  # a thread with one NaN ray of four
    on = i % 11 == 1  # start on a box plane
    rays8[on, 1] = lo[i[on] % c, 1]
    return rays8, lo, hi


@pytest.mark.cuda
@pytest.mark.parametrize("c", [301, 3079])
def test_nearest_box_kernel_adversarial_on_card(dev, c):
    """B3's fast and NaN-propagating paths in one warp, against the plain
    version: NaN and infinite rays among finite ones, origins on box
    planes, ties across tile boundaries, C no multiple of the tile, a ray
    count no multiple of a block's 512; then a tile holding an infinite
    box (that tile runs the NaN-propagating loop for every ray)."""
    rays8, lo, hi = _mixed_warp_case(130 + c, c)
    rays8, lo, hi = (x.to(dev) for x in _t(rays8[:-37], lo, hi))
    got = cull.nearest_box(rays8, lo, hi)
    want = cull.nearest_box_reference(rays8, lo, hi)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    w = want.cpu().numpy()
    assert (w < c).mean() > 0.2 and (w == c).any()
    assert not np.isin(w, (10, 11, 256, 300)).any()  # first index on ties
    lo[c // 2, 0] = -torch.inf
    hi[c - 1, 2] = torch.inf
    got = cull.nearest_box(rays8, lo, hi)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        cull.nearest_box_reference(rays8, lo, hi).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("c,p", [(256, 32), (200, 128), (3072, 256)])
def test_bundle_union_kernel_matches_plain_version_on_card(dev, c, p):
    rays8, lo, hi = (x.to(dev) for x in _t(*_case(95 + c, c)))
    launches = cull.bundle_union.launches
    got = cull.bundle_union(rays8, lo, hi, p)
    torch.cuda.synchronize()
    assert cull.bundle_union.launches == launches + 1
    want = cull.bundle_union_reference(rays8, lo, hi, p)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.cpu().numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("c,p", [(3079, 32), (3079, 128), (301, 256)])
def test_bundle_union_kernel_adversarial_on_card(dev, c, p):
    """B4's octant lists, its list of non-finite rays and its tiles with a
    non-finite box against the plain version, bit for bit: NaN and
    infinite rays among finite ones in one bundle, dead and padded rays, an
    all-dead bundle, origins inside boxes and on box planes (entries of -0
    and +0, which must leave as +0), an empty cluster's inverted box, C no
    multiple of the 512-box tile; then tiles holding an infinite box."""
    rays8, lo, hi = _mixed_warp_case(150 + p, c)
    rays8 = rays8[:rays8.shape[0] // p * p].copy()
    i = np.arange(rays8.shape[0])
    inside = (i % 13 == 6) & (i % 32 != 5)  # keep each bundle's NaN ray
    rays8[inside, 0:3] = 0.5 * (lo[3] + hi[3])  # inside box 3
    rays8[p:2 * p, 7] = -1.0  # an all-dead bundle
    rays8, lo, hi = (x.to(dev) for x in _t(rays8, lo, hi))
    # every bundle mixes finite rays with NaN or infinite ones
    bad = ~torch.isfinite(rays8[:, :6]).all(dim=1)
    assert bad.reshape(-1, p).any(dim=1).all()
    got = cull.bundle_union(rays8, lo, hi, p)
    want = cull.bundle_union_reference(rays8, lo, hi, p)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.cpu().numpy().view(np.uint32))
    w = want.cpu().numpy()
    assert np.isinf(w[1]).all()  # the all-dead bundle
    assert (w == 0.0).any() and np.isinf(w).any()
    assert np.isfinite(w).mean() > 0.05
    lo[c // 2, 0] = -torch.inf
    hi[c - 1, 2] = torch.inf
    got = cull.bundle_union(rays8, lo, hi, p)
    np.testing.assert_array_equal(
        got.cpu().numpy().view(np.uint32),
        cull.bundle_union_reference(rays8, lo, hi, p).cpu().numpy()
        .view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("presorted", [False, True])
def test_union_max_bundle_through_kernels_matches_plain_on_card(dev,
                                                                presorted):
    """cuda_traverse.union_max_bundle (the k_cand probe's count) through
    B3 (the cand0 sort key, unless presorted) and B4 on the card equals its
    value through the plain versions on the same rays and boxes (the CPU
    copies run them)."""
    import types

    from raytracer2_tpu_torch.ops import cuda_traverse as ct

    rays8, lo, hi = _case(170 + int(presorted), 3072)
    rays8 = rays8[np.isfinite(rays8).all(axis=1)]

    def probe(device):
        r, amin, amax = (x.to(device) for x in _t(rays8, lo, hi))
        clusters = types.SimpleNamespace(aabb_min=amin, aabb_max=amax,
                                         num_clusters=amin.shape[0])
        return ct.union_max_bundle(
            clusters, r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7],
            amin.amin(dim=0), amax.amax(dim=0), bundle_size=128,
            cull="exact", presorted=presorted)

    launches = cull.nearest_box.launches, cull.bundle_union.launches
    got = probe(dev)
    torch.cuda.synchronize()
    assert (cull.nearest_box.launches - launches[0],
            cull.bundle_union.launches - launches[1]) == (int(not presorted),
                                                          1)
    want = probe(CPU)
    assert got.device.type == "cuda" and int(got) == int(want) > 1

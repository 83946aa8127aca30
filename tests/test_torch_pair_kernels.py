"""The pair engine's CUDA kernels (B5, the pair sweep, csrc/pair_sweep.cu;
B6, the stable counting sort, csrc/binning.cu) against their plain torch
versions, on the card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false (a CUDA kernel has no CPU mode). The file imports no JAX, so on a
machine with an NVIDIA card and no JAX

    python -m pytest --noconftest tests/test_torch_pair_kernels.py -q -m cuda

runs it (tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch.models import procedural as proc
from raytracer2_tpu_torch.ops import binning
from raytracer2_tpu_torch.ops import cuda_pairs as cp
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops.cluster import build_clusters
from raytracer2_tpu_torch.ops.intersect import (
    intersect_brute_force, occluded_brute_force)
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.scene import build_scene

pytestmark = pytest.mark.cuda

N = 4096


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny(dev, tmp_path_factory):
    """A 3x3 grid of spheres in 4-triangle clusters, and N seeded rays
    toward it (every 11th dead)."""
    p = tmp_path_factory.mktemp("pair_kernels") / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=3, lat=8, lon=12))
    scene = build_scene(gltf.load_file(p), device=dev)
    clusters = build_clusters(scene.host_tri_v0, scene.host_tri_edge1,
                              scene.host_tri_edge2, cluster_size=4,
                              device=dev)
    rng = np.random.default_rng(7)
    o = rng.uniform(-6, 6, (N, 3)).astype(np.float32)
    d = (rng.normal(scale=0.5, size=(N, 3)) - o / 6).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tx = np.full(N, 1e5, np.float32)
    tx[::11] = -1.0
    rays = [torch.from_numpy(x).to(dev)
            for x in (o, d, np.full(N, 1e-3, np.float32), tx)]
    return dict(scene=scene, clusters=clusters, rays=rays,
                tables=ct.build_tables(clusters, scene.tri_geometry,
                                       scene.tri_primitive))


def _pair_scene(tiny, group):
    s = tiny["scene"]
    return cp.build_pair_scene(tiny["clusters"], s.tri_geometry,
                               s.tri_primitive, group=group)


def _sweep_args(dev, tiny, ps, k_cand):
    """The pair sweep's inputs as _trace_pairs_batch makes them on the card
    (bin_pairs, B6 included)."""
    o, d, tn, tx = tiny["rays"]
    pair_ray, block_sc, block_live, _ = cp.bin_pairs(ps, o, d, tn, tx,
                                                     k_cand)
    live = pair_ray >= 0
    rays8 = ct._pack8(o, d, tn, tx)
    rays8_pairs = torch.where(live[:, None], rays8[pair_ray.clamp_min(0)],
                              torch.tensor(cp.DEAD_PAIR_ROW, device=dev))
    return (rays8_pairs.contiguous(), block_sc, block_live, ps.wald_sc)


# the scene's 540 clusters (native SAH) fill groups of 4 and 5 and leave
# groups of 7 and 16 with padding clusters (not walked)
@pytest.mark.parametrize("group,k_cand", [(4, 24), (16, 24), (4, 2), (5, 24),
                                          (7, 24)])
def test_pair_sweep_kernel_matches_plain_version_on_card(dev, tiny, group,
                                                         k_cand):
    """B5 against its plain version, key for key, on the layout bin_pairs
    makes on the card (B6 included), W = 512 to 2048 lanes."""
    ps = _pair_scene(tiny, group)
    args = _sweep_args(dev, tiny, ps, k_cand)
    launches = cp.pair_sweep.launches
    got = cp.pair_sweep(*args, lanes=tiny["tables"].lanes)
    torch.cuda.synchronize()
    assert cp.pair_sweep.launches == launches + 1
    want = cp.pair_sweep_reference(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (want < cp.MISS_KEY).sum() > 100 and (args[2] == 0).any()


def test_pair_sweep_kernel_edge_cases_on_card(dev, tiny):
    """B5 against its plain version where the layout is odd: a live block
    marked dead, block_sc below 0 and at C2 in live blocks, empty segments
    (t_max == t_min, t_max < t_min) and NaN segment ends and origins in
    live blocks. Dead and out-of-range blocks give MISS_KEY, the others the
    plain version's keys."""
    ps = _pair_scene(tiny, 16)
    rays8, block_sc, block_live, wald_sc = _sweep_args(dev, tiny, ps, 24)
    rays8, block_sc, block_live = (x.clone() for x in (rays8, block_sc,
                                                       block_live))
    live = torch.nonzero(block_live).reshape(-1)
    assert live.numel() >= 8
    block_live[live[0]] = 0
    block_sc[live[1]] = -1
    block_sc[live[2]] = ps.num_superclusters
    rows = rays8.view(-1, cp.PAIR_P, 8)
    for i, (col, value) in enumerate(((7, None), (7, -1.0), (7, np.nan),
                                      (6, np.nan), (0, np.nan))):
        r = rows[live[3 + i]]
        r[::3, col] = r[::3, 6] if value is None else value
    args = (rays8, block_sc, block_live, wald_sc)
    got = cp.pair_sweep(*args, lanes=tiny["tables"].lanes).view(
        -1, cp.PAIR_P)
    torch.cuda.synchronize()
    want = cp.pair_sweep_reference(*args).view(-1, cp.PAIR_P)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (want[live[:3]] == cp.MISS_KEY).all()
    for i in range(5):  # the changed rays miss, the others of the block hit
        w = want[live[3 + i]]
        assert (w[::3] == cp.MISS_KEY).all()
    assert (want[live[8:]] < cp.MISS_KEY).any()


def test_pair_traces_match_brute_force_on_card(dev, tiny, monkeypatch):
    """closest_hit_pairs and occluded_pairs on the card (both kernels, in
    batches of 1,024 rays) against the brute-force oracles, keeping every
    overlapped supercluster and with k_cand = 1, which takes the
    fallback."""
    monkeypatch.setattr(cp, "PAIR_RAY_BATCH", 1024)
    s = tiny["scene"]
    c = tiny["clusters"]
    ps = _pair_scene(tiny, 16)
    o, d, tn, tx = tiny["rays"]
    smin, smax = c.aabb_min.amin(dim=0), c.aabb_max.amax(dim=0)
    ref = intersect_brute_force(o, d, s.tri_v0, s.tri_edge1, s.tri_edge2,
                                s.tri_geometry, s.tri_primitive, tn, tx)
    seg = torch.where(tx > 0, torch.linspace(0.5, 9.0, N, device=dev), tx)
    blocked_ref = occluded_brute_force(o, d, s.tri_v0, s.tri_edge1,
                                       s.tri_edge2, tn, seg)
    for k_cand in (ps.num_superclusters, 1):
        hit, overflowed = cp.closest_hit_pairs(ps, c, tiny["tables"], o, d,
                                               tn, tx, smin, smax,
                                               k_cand=k_cand)
        assert overflowed == (k_cand == 1)
        np.testing.assert_array_equal(hit.missed.cpu().numpy(),
                                      ref.missed.cpu().numpy())
        m = ~ref.missed
        # the Wald decode and Moller-Trumbore round t differently: far
        # hits differ by a few float32 ulps
        np.testing.assert_allclose(hit.t[m].cpu().numpy(),
                                   ref.t[m].cpu().numpy(), rtol=1e-4)
        blocked, _ = cp.occluded_pairs(ps, c, tiny["tables"], o, d, tn, seg,
                                       smin, smax, k_cand=k_cand)
        np.testing.assert_array_equal(blocked.cpu().numpy(),
                                      blocked_ref.cpu().numpy())
    assert int(m.sum()) > N // 8


def _ids(dev, seed, n, n_bins, outside=False, one_bin=False):
    rng = np.random.default_rng(seed)
    used = rng.choice(n_bins, size=max(1, n_bins // 2), replace=False)
    ids = used[rng.integers(0, used.size, n)].astype(np.int32)
    if one_bin:
        ids[:] = used[0]
    if outside:
        ids[::17] = n_bins
        ids[::29] = -1
    return torch.from_numpy(ids).to(dev)


# (n, n_bins, pad, n_write, div, ids outside the bins, every id in one bin,
# slots past the padded runs): one tile and a ragged last tile; one bin;
# the pair engine's layout at ladder scale (193 bins with a dead last one,
# padding to 128, payload j // 24); the most bins; all ids in one bin of
# the pair layout; n one short of and one past whole tiles; no ids; fewer
# slots than the padded runs take (the last ones are dropped)
@pytest.mark.parametrize("n,n_bins,pad,n_write,div,outside,one_bin,extra", [
    (4096, 16, 1, 16, 1, False, False, 7),
    (10_000, 1, 1, 1, 1, False, False, 7),
    (262_144 * 2 + 77, 193, 128, 192, 24, False, False, 7),
    (100_000, binning.MAX_BINS, 8, binning.MAX_BINS, 3, True, False, 7),
    (50_000, 193, 128, 192, 24, False, True, 7),
    (4 * binning.TILE - 1, 193, 128, 192, 24, True, False, 7),
    (4 * binning.TILE + 1, 64, 4, 60, 1, True, False, 7),
    (0, 193, 128, 192, 24, False, False, 300),
    (30_000, 40, 16, 40, 1, False, False, -5000)])
def test_bin_scatter_kernel_matches_plain_version_on_card(
        dev, n, n_bins, pad, n_write, div, outside, one_bin, extra):
    ids = _ids(dev, n + n_bins, n, n_bins, outside, one_bin)
    counts = torch.bincount(ids[(ids >= 0) & (ids < n_bins)].long(),
                            minlength=n_bins)
    out_size = max(0, int(((counts + pad - 1) // pad * pad).sum()) + extra)
    for ranks in (True, False):
        kw = dict(pad=pad, n_write=n_write, div=div, out_size=out_size,
                  ranks=ranks)
        launches = binning.bin_scatter.launches
        got = binning.bin_scatter(ids, n_bins, **kw)
        torch.cuda.synchronize()
        assert binning.bin_scatter.launches == launches + 1
        want = binning.bin_scatter_reference(ids, n_bins, **kw)
        for name, g, w in zip(("slots", "counts", "ranks"), got, want):
            if w is None:
                assert g is None
                continue
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                          err_msg=name)


def test_scatter_rate_probe_on_card(dev):
    """The probe at scripts/binning_ab.py's size: 2^22 ids in 256 bins."""
    ids = _ids(dev, 3, 1 << 22, 256)
    got = binning.scatter_rate_probe(ids)
    torch.cuda.synchronize()
    want = binning.scatter_rate_probe(ids.cpu())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert got.shape == ((1 << 22) // 8192, 1)

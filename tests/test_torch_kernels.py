"""The port's CUDA kernels (the closest-hit and any-hit bundle walks)
against their plain torch versions, on the card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false (a CUDA kernel has no CPU mode). The file imports no JAX, so it
also runs on a machine with an NVIDIA card and no JAX; tests/conftest.py
imports JAX, hence:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda

The tiny scene is the one tests/test_torch_traverse.py holds to JAX
(sphere_grid_glb(n=1, lat=6, lon=8), 4-triangle clusters, 32-ray bundles).
"""

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch.models import procedural as proc
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops.cluster import build_clusters
from raytracer2_tpu_torch.ops.intersect import (
    intersect_brute_force, occluded_brute_force)
from raytracer2_tpu_torch.render.rays import zorder_permutation
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.scene import build_scene

pytestmark = pytest.mark.cuda

P = 32  # rays per bundle
N = 96
CLASSES = {
    "pixel_tiles": dict(presorted=True, cull="interval", group=4),
    "bounces": dict(presorted=False, cull="exact", group=8),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk kernels have no CPU mode")
    return torch.device("cuda")


def _rays(cls):
    """Camera rays through a 12x8 grid in Z-order (pixel tiles), or
    scattered rays roughly toward the spheres (bounces)."""
    if cls == "pixel_tiles":
        zidx, _ = zorder_permutation(12, 8)
        lin = zidx.astype(np.int64)
        x = (lin % 12 + 0.5) / 12 * 3.2 - 1.6
        y = (lin // 12 + 0.5) / 8 * 2.4 - 1.2
        d = np.stack([x, y, np.full_like(x, 5.0)], -1).astype(np.float32)
        o = np.broadcast_to(np.float32([0.11, 0.07, -5.0]), d.shape).copy()
    else:
        rng = np.random.default_rng(77)
        o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
        d = (rng.normal(scale=0.5, size=(N, 3)) - o / 3).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def tiny(dev, tmp_path_factory):
    p = tmp_path_factory.mktemp("kernels") / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=1, lat=6, lon=8))
    scene = build_scene(gltf.load_file(p), device=dev)
    clusters = build_clusters(scene.host_tri_v0, scene.host_tri_edge1,
                              scene.host_tri_edge2, cluster_size=4,
                              device=dev)
    t_max = torch.full((N,), 1e5, device=dev)
    t_max[::11] = -1.0  # dead lanes, as bounce batches carry them
    return dict(scene=scene, clusters=clusters,
                tables=ct.build_tables(clusters, scene.tri_geometry,
                                       scene.tri_primitive),
                t_min=torch.full((N,), 1e-3, device=dev), t_max=t_max)


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_kernel_matches_plain_version_on_card(dev, tiny, cls):
    """The CUDA walk against its plain version, bit for bit (chip_smoke.py
    does the same at full size)."""
    cfg = CLASSES[cls]
    c = tiny["clusters"]
    o, d = (torch.from_numpy(x).to(dev) for x in _rays(cls))
    tn, tx = tiny["t_min"], tiny["t_max"]
    if cfg["cull"] == "interval":
        prep = ct.prepare_bundles_interval(c, o, d, tn, tx, P, 256)
    else:
        prep = ct.prepare_bundles_exact(c, o, d, tn, tx,
                                        c.aabb_min.amin(dim=0),
                                        c.aabb_max.amax(dim=0), P, False, 256)
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    args = (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tiny["tables"].wald_rows)
    launches = ct.walk_closest.launches
    got = ct.walk_closest(*args, group=cfg["group"])
    torch.cuda.synchronize()
    assert ct.walk_closest.launches == launches + 1
    want = ct.walk_closest_reference(*args, group=cfg["group"])
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (want != ct.MISS_CODE).sum() > N // 4  # the rays hit the spheres


def test_kernel_tie_rule_on_card(dev, tiny):
    """One bundle whose two candidates are the same cluster's Wald rows
    under two ids, so every hit ties exactly in key: the first candidate in
    walk order wins (lower slot inside a step, strict < across steps), as
    on the TPU."""
    s, tables = tiny["scene"], tiny["tables"]
    o, d = (torch.from_numpy(x).to(dev) for x in _rays("pixel_tiles"))
    hit = intersect_brute_force(o, d, s.tri_v0, s.tri_edge1, s.tri_edge2,
                                s.tri_geometry, s.tri_primitive,
                                tiny["t_min"], torch.full_like(tiny["t_max"],
                                                               1e5))
    i = int(torch.nonzero(~hit.missed)[0])
    sp = tables.wald_rows.shape[-1]
    code = int(torch.nonzero(tables.meta_rows[:, 12]
                             == hit.triangle_index[i])[0])
    rows = tables.wald_rows[code // sp]
    wald = torch.stack([rows, rows]).contiguous()
    ray = torch.cat([o[i], d[i], torch.tensor([1e-3, 1e5], device=dev)])
    rays8 = ray.expand(P, 8).contiguous()
    for group in (1, 2):
        for order in ((0, 1), (1, 0)):
            args = (rays8, torch.tensor([order], dtype=torch.int32,
                                        device=dev),
                    torch.zeros((1, 2), device=dev),
                    torch.tensor([2], dtype=torch.int32, device=dev), wald)
            got = ct.walk_closest(*args, group=group)
            want = order[0] * sp + code % sp
            assert (got == want).all(), (group, order)
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                ct.walk_closest_reference(*args, group=group).cpu().numpy())


@pytest.mark.parametrize("presorted", [True, False])
def test_occluded_kernel_matches_plain_version_on_card(dev, tiny, presorted):
    """The CUDA any-hit walk against its plain version, flag for flag, on
    segments of mixed length (some blocked, some clear, dead lanes), and
    the blocked flags against brute force."""
    c, s = tiny["clusters"], tiny["scene"]
    o, d = (torch.from_numpy(x).to(dev) for x in _rays("bounces"))
    rng = np.random.default_rng(5)
    tx = torch.from_numpy(rng.uniform(0.5, 7.0, N).astype(np.float32)).to(dev)
    tx[::13] = -1.0
    tn = tiny["t_min"]
    prep = ct.prepare_bundles_exact(c, o, d, tn, tx, c.aabb_min.amin(dim=0),
                                    c.aabb_max.amax(dim=0), P, presorted, 256)
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    args = (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tiny["tables"].wald_rows)
    for group in (1, 4, 8):
        launches = ct.walk_occluded.launches
        got = ct.walk_occluded(*args, group=group)
        torch.cuda.synchronize()
        assert ct.walk_occluded.launches == launches + 1
        want = ct.walk_occluded_reference(*args, group=group)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    blocked = ct.occluded_bundle(c, tiny["tables"], o, d, tn, tx,
                                 c.aabb_min.amin(dim=0),
                                 c.aabb_max.amax(dim=0), bundle_size=P,
                                 presorted=presorted)[0]
    ref = occluded_brute_force(o, d, s.tri_v0, s.tri_edge1, s.tri_edge2, tn,
                               tx)
    np.testing.assert_array_equal(blocked.cpu().numpy(), ref.cpu().numpy())
    live = (tx > 0).cpu().numpy()
    assert 0 < ref.cpu().numpy()[live].sum() < live.sum()

"""The multi-device slice of the PyTorch port (raytracer2_tpu_torch/parallel)
against the JAX package's (raytracer2_tpu/parallel).

The port's ranks are gloo processes on the CPU, started by
parallel/dryrun.spawn, each joined against a deadline of its own so that a
hang fails the test instead of the suite's time limit. JAX's side runs in
shard_map on two devices of the conftest's virtual CPU mesh. The halo
exchange and the stencil gather are bit-equal to JAX's on the cases of
tests/test_parallel.py. The port's 2-rank Cornell frames meet the JAX dry
run's bar against the port's unsharded frames, and agree with JAX's
explicit-halo frame within the goldens' rtol=atol=2e-3 (the flagship
configuration; the checkerboard twin with DI temporal resampling is held
to the port's unsharded frame). The camera sits off the box's axis, so
that no primary ray runs along a quad's diagonal. JAX's frame traces
through its Pallas walks in interpret mode over the port's clusters.

The rank functions live at module level so that the spawned processes can
import them; JAX is imported inside the tests only.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch.parallel import dryrun, halo
from raytracer2_tpu_torch.parallel import mesh as pm

RANKS = 2
RADII = (1, 3)
OFFSETS = ((-3, 0), (3, 2), (0, -5), (2, 1))  # (dy, dx), radius 3
W = H = 32
CAMERA = ((0.13, 0.07, -12), (0, 0, -1))
RANK_TIMEOUT_S = 300.0


def _image():
    return np.random.default_rng(1).normal(size=(8 * RANKS, 16)).astype(
        np.float32)


def _halo_rank(rank, img):
    """One rank of the halo tests: its tile padded at each radius, the
    radius-3 stencil reads, the image's sum by psum_image_metric."""
    mesh = pm.make_mesh("gloo")
    row0, h = pm.row_tile(mesh, img.shape[0])
    tile = torch.from_numpy(img[row0:row0 + h].copy())
    out = {("pad", r): halo.exchange_row_halos(tile, r, mesh).numpy()
           for r in RADII}
    padded = halo.exchange_row_halos(tile, 3, mesh)
    for dy, dx in OFFSETS:
        out[("gather", dy, dx)] = halo.gather_rows(padded, 3, dy, dx).numpy()
    out["sum"] = float(pm.psum_image_metric(tile, mesh))
    out["frame"] = pm.gather_frame(tile, mesh).numpy()
    return out


def _fail_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def _hang_rank(rank):
    import time

    time.sleep(600)


@pytest.fixture(scope="module")
def halo_ranks():
    return dryrun.spawn(_halo_rank, RANKS, "gloo", (_image(),),
                        timeout=RANK_TIMEOUT_S)


def _jax_sharded(fn, img):
    """fn(tile) over the rows of img in shard_map on RANKS devices; the
    per-device outputs concatenated along rows."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from raytracer2_tpu.parallel.mesh import ROW_AXIS

    if len(jax.devices()) < RANKS:
        pytest.skip("needs the virtual multi-device CPU mesh")
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), (ROW_AXIS,))
    run = partial(shard_map, mesh=mesh, in_specs=P(ROW_AXIS),
                  out_specs=P(ROW_AXIS))(fn)
    return np.asarray(run(jnp.asarray(img)))


@pytest.mark.parametrize("radius", RADII)
def test_exchange_row_halos_matches_jax(halo_ranks, radius):
    """Each rank's padded tile equals JAX's exchange_row_halos in
    shard_map, bit for bit: the neighbour's rows inside the image, the
    reflection at its outer edges."""
    from raytracer2_tpu.parallel.halo import exchange_row_halos

    want = _jax_sharded(lambda t: exchange_row_halos(t, radius), _image())
    got = np.concatenate([r[("pad", radius)] for r in halo_ranks])
    np.testing.assert_array_equal(got, want)
    h = _image().shape[0] // RANKS
    np.testing.assert_array_equal(  # rank 1's top halo is rank 0's rows
        halo_ranks[1][("pad", radius)][:radius], _image()[h - radius:h])


@pytest.mark.parametrize("dy,dx", OFFSETS)
def test_gather_rows_matches_jax(halo_ranks, dy, dx):
    from raytracer2_tpu.parallel.halo import exchange_row_halos, gather_rows

    import jax.numpy as jnp

    want = _jax_sharded(
        lambda t: gather_rows(exchange_row_halos(t, 3), 3, jnp.int32(dy),
                              jnp.int32(dx)), _image())
    got = np.concatenate([r[("gather", dy, dx)] for r in halo_ranks])
    np.testing.assert_array_equal(got, want)


def test_psum_and_gather_frame(halo_ranks):
    img = _image()
    for r in halo_ranks:
        np.testing.assert_array_equal(r["frame"], img)
        np.testing.assert_allclose(r["sum"], float(img.sum()), rtol=1e-5)


def test_single_rank_reflects():
    """One rank exchanges nothing: both halos reflect its own rows, as
    JAX's exchange_row_halos on a one-device mesh."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from raytracer2_tpu.parallel.halo import exchange_row_halos as j_exch
    from raytracer2_tpu.parallel.mesh import ROW_AXIS

    img = np.arange(24, dtype=np.float32).reshape(6, 4)
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), (ROW_AXIS,))
    want = partial(shard_map, mesh=mesh1, in_specs=P(ROW_AXIS),
                   out_specs=P(ROW_AXIS))(lambda t: j_exch(t, 2))(
        jnp.asarray(img))
    one = pm.RowMesh(group=None, rank=0, size=1, backend="gloo", ranks=(0,))
    got = halo.exchange_row_halos(torch.from_numpy(img), 2, one)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        halo.local_pad_rows(torch.from_numpy(img), 2).numpy(),
        np.asarray(want))
    with pytest.raises(AssertionError, match="exceeds the tile height"):
        halo.exchange_row_halos(torch.from_numpy(img), 7, one)


def test_mesh_takes_a_named_backend_only():
    with pytest.raises(ValueError, match="backend must be one of"):
        pm.make_mesh("mpi")
    with pytest.raises(RuntimeError, match="init_process_group"):
        pm.make_mesh("gloo")
    one = pm.RowMesh(group=None, rank=0, size=1, backend="gloo", ranks=(0,))
    with pytest.raises(NotImplementedError, match="GSPMD"):
        pm.make_sharded_render_fn(None, one, explicit_halo=False)


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*on purpose"):
        dryrun.spawn(_fail_rank, RANKS, "gloo", timeout=RANK_TIMEOUT_S)


def test_a_hanging_rank_times_out():
    with pytest.raises(TimeoutError, match="did not finish within"):
        dryrun.spawn(_hang_rank, RANKS, "gloo", timeout=8.0)


def _jax_flagship(j_renderer):
    """The JAX package's GConst of the dry run's flagship configuration,
    as dryrun.frame_plan and __graft_entry__.dryrun_multichip make it."""
    from raytracer2_tpu.params import default_gconst
    from raytracer2_tpu.scene.camera import default_camera

    cam = default_camera(window_size=(W, H), position=CAMERA[0],
                         direction=CAMERA[1])
    return default_gconst(cam.planar_view_constants(),
                          j_renderer.scene_lights.num_local_lights,
                          enable_restir_gi=1, enable_restir_di=1,
                          enable_temporal_resampling=1,
                          enable_spatial_resampling=1)


def _j_pallas_tracers(port_tracers, j_scene):
    """JAX's Pallas walks (interpret mode) over the port's clusters with
    the port's per-class shapes, every cluster a candidate (k_cand = C)
    so that no bundle overflows and no overflow fallback is compiled."""
    import jax.numpy as jnp

    from raytracer2_tpu.ops import cluster as jcluster
    from raytracer2_tpu.ops import pallas_traverse as ptm
    from raytracer2_tpu.render.app_bridge import Tracers as JTracers

    c = port_tracers.clusters
    jc = jcluster.Clusters(*(jnp.asarray(x.numpy()) for x in c))
    smin = jnp.asarray(port_tracers.scene_min.numpy())
    smax = jnp.asarray(port_tracers.scene_max.numpy())

    def shapes(cls):
        return dict(port_tracers.shapes_by_class[cls], k_cand=c.num_clusters)

    def closest(o, d, tmin, tmax, presorted=False):
        return ptm.closest_hit_bundle_pallas(
            jc, j_scene.tri_geometry, j_scene.tri_primitive, o, d, tmin,
            tmax, smin, smax, interpret=True, mb=1, overflow_fallback=False,
            presorted=bool(presorted), **shapes(bool(presorted)))

    def occluded(o, d, tmin, tmax, presorted=False):
        cls = presorted if presorted == "shadow" else bool(presorted)
        return ptm.occluded_bundle_pallas(
            jc, o, d, tmin, tmax, smin, smax, interpret=True, mb=1,
            overflow_fallback=False, presorted=bool(presorted),
            **shapes(cls))

    return JTracers(closest_hit=closest, occluded=occluded)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The dry run's two configurations at 32x32, off the box's axis, one
    frame each: the port's frames unsharded and on 2 gloo ranks, and JAX's
    flagship frame on 2 devices through
    make_sharded_render_fn(explicit_halo=True)."""
    import jax

    from raytracer2_tpu.parallel.mesh import (
        ROW_AXIS, make_sharded_render_fn, shard_frame_state)
    from raytracer2_tpu.render import frame as jframe
    from raytracer2_tpu.scene import gltf
    from raytracer2_tpu.scene.scene import build_scene

    if len(jax.devices()) < RANKS:
        pytest.skip("needs the virtual multi-device CPU mesh")
    glb = dryrun.write_cornell(tmp_path_factory.mktemp("par") / "c.glb")
    job = dryrun.Job(glb=glb, width=W, height=H, device="cpu",
                     backend="gloo", position=CAMERA[0], direction=CAMERA[1])
    ranks = dryrun.run_ranks(job, RANKS, timeout=RANK_TIMEOUT_S)
    unsharded = dryrun.render_unsharded(job)

    t_renderer = dryrun._renderer(job, torch.device("cpu"))
    j_scene = build_scene(gltf.load_file(Path(glb)))
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="brute")
    j_renderer = j_renderer._replace(
        tracers=_j_pallas_tracers(t_renderer.tracers, j_scene))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:RANKS]), (ROW_AXIS,))
    step = make_sharded_render_fn(j_renderer, mesh, explicit_halo=True)
    _, img = step(_jax_flagship(j_renderer),
                  shard_frame_state(jframe.init_frame_state(W, H), mesh))
    return dict(unsharded=unsharded, ranks=ranks, jax=np.asarray(img),
                jax_telemetry=dict(step.halo_telemetry))


NAMES = ("flagship", "checkerboard")


@pytest.mark.parametrize("name", NAMES)
def test_sharded_frame_meets_the_dryrun_bar(frames, name):
    """2 ranks against the port's unsharded frame: more than 95% of the
    pixels bit-exact and a mean |diff| below 1e-3."""
    got = frames["ranks"][0]["configs"][name]["images"][0]
    want = frames["unsharded"][name][0]
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert got.max() > 0.05  # lit
    dryrun.check(dryrun.parity(got, want), name)


def test_sharded_frame_matches_jax(frames):
    """2 ranks against JAX's explicit-halo flagship frame on 2 devices,
    within the goldens' rtol=atol=2e-3; each rank exchanged as many halo
    leaves with as many rows as JAX's tiles."""
    got = frames["ranks"][0]["configs"]["flagship"]["images"][0]
    np.testing.assert_allclose(got, frames["jax"], rtol=2e-3, atol=2e-3)
    want = frames["jax_telemetry"]
    for r in frames["ranks"]:
        tel = r["configs"]["flagship"]["telemetry"]
        assert tel["halo_rows"] == want["halo_rows"]
        assert tel["halo_exchanges"] == want["halo_exchanges"] > 0
        assert tel["halo_bytes_per_device_frame"] > 0


def test_di_resampling_on_a_tile_needs_the_halo(tmp_path):
    """A row tile's reservoirs hold only its rows: DI resampling on a tile
    without halo_fn raises, as JAX's guard does under shard_map."""
    from raytracer2_tpu_torch.render.frame import (
        init_frame_state, render_frame)

    job = dryrun.Job(glb=dryrun.write_cornell(tmp_path / "c.glb"), width=16,
                     height=16, device="cpu", backend="gloo")
    renderer = dryrun._renderer(job, torch.device("cpu"))
    (_, (g,)), (_, (g_cb,)) = dryrun.frame_plan(renderer, job).values()
    one = pm.RowMesh(group=None, rank=0, size=2, backend="gloo",
                     ranks=(0, 1))
    tile = pm.shard_frame_state(
        init_frame_state(16, 16, True, device=torch.device("cpu")), one)
    with pytest.raises(ValueError, match="needs halo_fn"):
        render_frame(renderer, g_cb, tile, row0=0)
    _, img = render_frame(renderer, g, pm.shard_frame_state(
        init_frame_state(16, 16, device=torch.device("cpu")), one))
    assert img.shape == (8, 16, 3)  # a tile renders without DI resampling


@pytest.mark.parametrize("halo_impl", ["exchange", "local"])
def test_one_rank_frames_equal_the_unsharded_frames(tmp_path, halo_impl):
    """On one rank both halo implementations reflect the image's edges,
    which no read reaches (rows clamp into the image first): two frames of
    the flagship configuration equal render_frame's bit for bit."""
    from raytracer2_tpu_torch.render.frame import (
        init_frame_state, render_frame)

    cpu = torch.device("cpu")
    job = dryrun.Job(glb=dryrun.write_cornell(tmp_path / "c.glb"), width=16,
                     height=16, device="cpu", backend="gloo",
                     position=CAMERA[0], direction=CAMERA[1])
    renderer = dryrun._renderer(job, cpu)
    _, gs = dryrun.frame_plan(renderer, job)["flagship"]
    one = pm.RowMesh(group=None, rank=0, size=1, backend="gloo", ranks=(0,))
    step = pm.make_sharded_render_fn(renderer, one, halo_impl=halo_impl)
    state = want_state = pm.shard_frame_state(
        init_frame_state(16, 16, device=cpu), one)
    for f in range(2):
        g = gs[0].replace(frame=f)
        state, img = step(g, state)
        want_state, want = render_frame(renderer, g, want_state)
        np.testing.assert_array_equal(img.numpy(), want.numpy())
    assert step.halo_telemetry["halo_exchanges"] > 0


@pytest.mark.slow
def test_dryrun_four_ranks():
    """The dry run as `python -m raytracer2_tpu_torch.parallel.dryrun
    --ranks 4` runs it: 64x64 on the box's axis, 16 rows a rank."""
    report = dryrun.dryrun(n_ranks=4, width=64, height=64, backend="gloo",
                           device="cpu")
    assert set(report) == set(NAMES)


def test_dryrun_defaults_to_the_card(monkeypatch):
    """The dry run renders on cuda over nccl unless asked for the CPU, and
    raises at once, before any rank starts, where no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "spawn", _no_spawn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun()


def _no_spawn(*args, **kwargs):
    raise AssertionError("the dry run started ranks without a card")

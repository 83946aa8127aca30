"""The closest-hit walk's winner decode (ops/cuda_traverse.py::hit_decode,
csrc/hit_decode.cu): the codes in the walk's order to a HitRecord in the
caller's order.

On the CPU hit_decode runs its plain version, hit_decode_reference (the
scatter _unsort, then _decode); these tests hold the wrapper's argument
checks, its dispatch and counters, and closest_hit_bundle's results to
that chain. The `cuda`-marked tests hold the kernel to the plain version
bit for bit on the card, on made-up rows (misses, padding lanes, d'_z = 0,
subnormal and negative-zero weights, ragged sizes) and on the ladder
scene's traces at the benchmark's batch sizes; they skip without CUDA.
The file imports no JAX, so on a machine with a card:

    python -m pytest --noconftest tests/test_torch_hit_decode.py -q -m cuda
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch.models import procedural as proc
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops.cluster import build_clusters
from raytracer2_tpu_torch.render import app_bridge
from raytracer2_tpu_torch.render.rays import zorder_permutation
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.scene import build_scene
from raytracer2_tpu_torch.utils import profiler

CPU = torch.device("cpu")
FIELDS = ("t", "u", "v", "geometry_index", "primitive_id", "triangle_index")
# the small corridor the CPU tests trace (chip_smoke.py's CPU rehearsal)
SMALL_LADDER = dict(segments=4, pillars_per_side=4, lat=12, lon=16)
# the benchmark's ladder configuration: the corridor's arguments, the
# camera's position and the image the card tests trace
LADDER_CONFIG = (Path(__file__).resolve().parent.parent / "portbench"
                 / "configs" / "ladder-1080p.json")


def _assert_same(got, want):
    """Every field equal, bit for bit (dtype included)."""
    for name, g, w in zip(FIELDS, got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                           else g,
                           w.view(torch.int32) if w.is_floating_point()
                           else w), name


def _rows(n_rows: int, seed: int, dev) -> torch.Tensor:
    """[n_rows, 16] i32 meta rows: random Wald coefficients with subnormal
    and negative-zero entries, every 7th row with d'_z's coefficients zero
    (d'_z == 0 for any direction), every 5th a padding lane (triangle -1,
    geometry -1, primitive 0)."""
    g = np.random.default_rng(seed)
    w = g.normal(size=(n_rows, 12)).astype(np.float32)
    w[g.random(w.shape) < 0.05] = np.float32(3e-39)  # subnormal
    w[g.random(w.shape) < 0.05] = np.float32(-0.0)
    w[::7, [2, 5, 8]] = 0.0
    ids = np.stack([g.integers(0, 1 << 20, n_rows),
                    g.integers(0, 64, n_rows),
                    g.integers(0, 1 << 12, n_rows),
                    np.zeros(n_rows, np.int64)], axis=1).astype(np.int32)
    ids[::5] = (-1, -1, 0, 0)
    rows = np.concatenate([w.view(np.int32), ids], axis=1)
    return torch.from_numpy(rows).to(dev).contiguous()


def _case(n: int, n_rows: int, seed: int, dev, permuted: bool):
    """hit_decode's arguments for n rays: codes into n_rows meta rows,
    about a tenth MISS_CODE; rays with a subnormal and a -0 component."""
    g = np.random.default_rng(seed + 1)
    code = g.integers(0, n_rows, n).astype(np.int32)
    code[g.random(n) < 0.1] = ct.MISS_CODE
    o = g.normal(scale=4.0, size=(n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    o[::13, 0] = np.float32(-0.0)
    d[::17, 1] = np.float32(1e-41)
    t_max = g.uniform(0.5, 1e4, n).astype(np.float32)
    perm = (torch.from_numpy(g.permutation(n)).to(dev) if permuted else None)
    return (torch.from_numpy(code).to(dev), perm, _rows(n_rows, seed, dev),
            torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(t_max).to(dev))


# ---------------------------------------------------------------------------
# CPU: the wrapper, the plain version, closest_hit_bundle
# ---------------------------------------------------------------------------

def _bad(case, field, value):
    args = dict(zip(("code", "perm", "meta_rows", "origins", "directions",
                     "t_max_orig"), case))
    args[field] = value(args[field])
    return args


BAD_ARGS = {
    "code_int64": ("code", lambda x: x.long(), TypeError),
    "code_2d": ("code", lambda x: x[:, None], ValueError),
    "perm_int32": ("perm", lambda x: x.int(), TypeError),
    "perm_short": ("perm", lambda x: x[1:], ValueError),
    "meta_width": ("meta_rows", lambda x: x[:, :12].contiguous(),
                   ValueError),
    "meta_strided": ("meta_rows", lambda x: x[::2], ValueError),
    "origins_width": ("origins", lambda x: x[:, :2], ValueError),
    "directions_f64": ("directions", lambda x: x.double(), TypeError),
    "t_max_short": ("t_max_orig", lambda x: x[:-1], ValueError),
    "t_max_device": ("t_max_orig", lambda x: x.to("meta"), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_hit_decode_checks_its_arguments(case):
    field, change, error = BAD_ARGS[case]
    args = _bad(_case(64, 32, 0, CPU, permuted=True), field, change)
    with pytest.raises(error):
        ct.hit_decode(**args)


@pytest.mark.parametrize("permuted", [False, True])
def test_cpu_call_runs_the_plain_version(permuted):
    """A CPU call is the plain chain, counted in trace.decode.plain and
    not as a kernel launch."""
    args = _case(300, 40, 1, CPU, permuted)
    plain = profiler.counters().get("trace.decode.plain", 0)
    kernel = profiler.counters().get("trace.decode.kernel", 0)
    got = ct.hit_decode(*args)
    assert profiler.counters()["trace.decode.plain"] == plain + 1
    assert profiler.counters().get("trace.decode.kernel", 0) == kernel
    code, perm, meta, o, d, tx = args
    _assert_same(got, ct._decode(ct._unsort(code, perm), meta, o, d, tx))


@pytest.mark.parametrize("permuted", [False, True])
def test_empty_batch_counts_nothing(permuted):
    """No rays: an empty record of HitRecord's dtypes, and neither counter
    moves (nothing was decoded, nothing launched)."""
    args = _case(0, 8, 4, CPU, permuted)
    before = profiler.counters()
    rec = ct.hit_decode(*args)
    assert [x.shape for x in rec] == [(0,)] * 6
    assert [x.dtype for x in rec] == [torch.float32] * 3 + [
        torch.int64] * 2 + [torch.int32]
    after = profiler.counters()
    for name in ("trace.decode.plain", "trace.decode.kernel"):
        assert after.get(name, 0) == before.get(name, 0)


def test_perm_none_is_the_identity():
    code, _, meta, o, d, tx = _case(257, 50, 2, CPU, permuted=False)
    ident = torch.arange(code.shape[0])
    _assert_same(ct.hit_decode(code, None, meta, o, d, tx),
                 ct.hit_decode(code, ident, meta, o, d, tx))


def test_plain_version_miss_rule():
    """A MISS_CODE or a padding lane's row decodes to the caller's t_max,
    u = v = +0, geometry INVALID_INDEX in int64, primitive 0, triangle
    -1; the other rows to their meta row's ids. Each field lands at its
    caller row perm[i]."""
    code, perm, meta, o, d, tx = _case(400, 60, 3, CPU, permuted=True)
    rec = ct.hit_decode_reference(code, perm, meta, o, d, tx)
    assert [x.dtype for x in rec] == [torch.float32] * 3 + [
        torch.int64] * 2 + [torch.int32]
    row = torch.where(code == ct.MISS_CODE, 0, code).long()
    tri = torch.where(code == ct.MISS_CODE, -1, meta[row, 12])
    caller = torch.empty_like(tri).index_put_((perm,), tri)
    miss = caller < 0
    assert miss.any() and (~miss).any()
    assert torch.equal(rec.triangle_index, caller)
    assert torch.equal(rec.t[miss], tx[miss])
    assert torch.equal(rec.u[miss].view(torch.int32),
                       torch.zeros_like(rec.u[miss]).view(torch.int32))
    assert (rec.geometry_index[miss] == 0xFFFFFFFF).all()
    assert (rec.primitive_id[miss] == 0).all()
    geom = torch.empty_like(tri).index_put_((perm,), meta[row, 13])
    assert torch.equal(rec.geometry_index[~miss], geom[~miss].long())


def _small_ladder(dev, tmp_path, cluster_size):
    p = tmp_path / "ladder.glb"
    proc.write_glb(p, proc.corridor_glb(**SMALL_LADDER))
    scene = build_scene(gltf.load_file(p), device=dev)
    clusters = build_clusters(scene.host_tri_v0, scene.host_tri_edge1,
                              scene.host_tri_edge2,
                              cluster_size=cluster_size, device=dev)
    tables = ct.build_tables(clusters, scene.tri_geometry,
                             scene.tri_primitive)
    return clusters, tables


def _camera_rays(width, height, pos, dev):
    """Pinhole rays from pos through a width x height grid in Z-order
    (pixel tiles, as the G-buffer casts them), 60 degrees high, looking
    down -z."""
    zidx, _ = zorder_permutation(width, height)
    lin = zidx.astype(np.int64)
    half = np.tan(np.radians(30.0))
    x = ((lin % width + 0.5) / width * 2 - 1) * half * width / height
    y = (1 - (lin // width + 0.5) / height * 2) * half
    d = np.stack([x, y, -np.ones_like(x)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.float32(pos), d.shape).copy()
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _bounce_rays(rec, o, d, n, seed):
    """n incoherent rays from the primary hits (origins on the surfaces,
    uniform directions); a primary miss gives a dead lane (t_max -1)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    dev = o.device
    hit = ~rec.missed
    pts = (o + rec.t[:, None] * d)
    pts = torch.where(hit[:, None], pts, o)
    idx = torch.randint(0, o.shape[0], (n,), generator=g).to(dev)
    dirs = torch.randn((n, 3), generator=g).to(dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    t_max = torch.where(hit[idx], 1e30, -1.0).to(torch.float32)
    return pts[idx].contiguous(), dirs.contiguous(), t_max


def _old_chain(clusters, tables, o, d, tn, tx, smin, smax, cfg, lean):
    """What closest_hit_bundle returned before hit_decode, with no
    overflow: prep, walk, then _decode(_unsort(...))."""
    k = dict(cfg)
    p, group = k.pop("bundle_size"), k.pop("group")
    prep = ct._prepare(clusters, o, d, tn, tx, smin, smax, p,
                       k.pop("presorted"), k.pop("cull"), k.pop("k_cand"))
    rows = ct.walk_closest(ct._rays8(prep), prep.cand_idx, prep.cand_t,
                           prep.cand_count, tables.wald_rows, group,
                           lanes=tables.lanes, lean=lean)
    code = (ct._lean_code(rows[0], rows[1], prep, group,
                          tables.wald_rows.shape[-1], p) if lean else rows)
    assert not prep.overflowed.any()
    return ct._decode(ct._unsort(code[:o.shape[0]], prep.perm),
                      tables.meta_rows, o, d, tx)


SMALL_CLASSES = {
    "pixel_tiles": dict(presorted=True, cull="interval", group=4,
                        bundle_size=64, k_cand=256),
    "bounces": dict(presorted=False, cull="exact", group=4, bundle_size=32,
                    k_cand=256),
}


@pytest.fixture(scope="module")
def small_ladder(tmp_path_factory):
    clusters, tables = _small_ladder(CPU, tmp_path_factory.mktemp("hd"), 64)
    smin = clusters.aabb_min.amin(dim=0)
    smax = clusters.aabb_max.amax(dim=0)
    o, d = _camera_rays(16, 12, (0.0, 4.0, 15.0), CPU)
    tn = torch.full((o.shape[0],), 1e-3)
    tx = torch.full((o.shape[0],), 1e30)
    rec, _ = ct.closest_hit_bundle(clusters, tables, o, d, tn, tx, smin,
                                   smax, **SMALL_CLASSES["pixel_tiles"])
    bo, bd, btx = _bounce_rays(rec, o, d, 192, 5)
    return dict(clusters=clusters, tables=tables, smin=smin, smax=smax,
                rays={"pixel_tiles": (o, d, tn, tx),
                      "bounces": (bo, bd, torch.full_like(btx, 1e-3), btx)},
                primary_hits=int((~rec.missed).sum()))


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("cls", sorted(SMALL_CLASSES))
def test_closest_hit_bundle_is_unchanged(small_ladder, cls, lean):
    """closest_hit_bundle on the CPU returns what the prep, the walk and
    the plain decode chain give, bit for bit, and decodes through
    hit_decode's plain version once a trace."""
    s = small_ladder
    assert s["primary_hits"] > 100  # the camera sees the corridor
    o, d, tn, tx = s["rays"][cls]
    cfg = SMALL_CLASSES[cls]
    plain = profiler.counters().get("trace.decode.plain", 0)
    got, n_ovf = ct.closest_hit_bundle(
        s["clusters"], s["tables"], o, d, tn, tx, s["smin"], s["smax"],
        lean=lean, **cfg)
    assert n_ovf == 0
    assert profiler.counters()["trace.decode.plain"] == plain + 1
    _assert_same(got, _old_chain(s["clusters"], s["tables"], o, d, tn, tx,
                                 s["smin"], s["smax"], cfg, lean))
    assert (~got.missed).sum() > o.shape[0] // 4


def test_overflow_count_is_read_before_the_walk(small_ladder, monkeypatch):
    """closest_hit_bundle reads its overflow count once, after the prep and
    before the walk is queued, so the walk and the decode need no host
    wait; the count it returns is that read's."""
    s = small_ladder
    order = []
    item, walk = ct.readback.item, ct.walk_closest

    def read(x, site):
        order.append(site)
        return item(x, site)

    def walked(*args, **kw):
        order.append("walk")
        return walk(*args, **kw)

    monkeypatch.setattr(ct.readback, "item", read)
    monkeypatch.setattr(ct, "walk_closest", walked)
    o, d, tn, tx = s["rays"]["bounces"]
    _, n_ovf = ct.closest_hit_bundle(
        s["clusters"], s["tables"], o, d, tn, tx, s["smin"], s["smax"],
        **SMALL_CLASSES["bounces"])
    assert order == ["overflow_count", "walk"] and n_ovf == 0


# ---------------------------------------------------------------------------
# The card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
@pytest.mark.parametrize("permuted", [False, True])
def test_kernel_matches_plain_version(dev, n, permuted):
    """Made-up rows: misses, padding lanes, d'_z == 0, subnormal and -0
    weights and ray components, sizes off the 256-thread block."""
    args = _case(n, 997, n, dev, permuted)
    launches = profiler.counters().get("trace.decode.kernel", 0)
    got = ct.hit_decode(*args)
    torch.cuda.synchronize()
    assert profiler.counters()["trace.decode.kernel"] == launches + 1
    _assert_same(got, ct.hit_decode_reference(*args))


@pytest.fixture(scope="module")
def ladder(dev, tmp_path_factory):
    """The benchmark's corridor on the card through make_tracers, its
    1920x1080 camera rays in Z-order from the configuration's camera
    position and 2,073,600 bounce rays from their hits."""
    cfg = json.loads(LADDER_CONFIG.read_text())
    assert cfg["generator"] == "corridor_glb"
    p = tmp_path_factory.mktemp("hd_ladder") / "ladder.glb"
    proc.write_glb(p, proc.corridor_glb(**cfg["args"]))
    scene = build_scene(gltf.load_file(p), device=dev)
    tracers = app_bridge.make_tracers(scene)
    o, d = _camera_rays(cfg["width"], cfg["height"],
                        tuple(cfg["camera"]["position"]), dev)
    n = o.shape[0]
    tn = torch.full((n,), 1e-3, device=dev)
    tx = torch.full((n,), 1e30, device=dev)
    rec, _ = ct.closest_hit_bundle(
        tracers.clusters, tracers.tables, o, d, tn, tx, tracers.scene_min,
        tracers.scene_max, presorted=True, **tracers.shapes_by_class[True])
    bo, bd, btx = _bounce_rays(rec, o, d, n, 11)
    return dict(tracers=tracers, primary=(o, d, tn, tx, True),
                bounce=(bo, bd, tn, btx, False))


# batch: (rays of the ladder fixture, rays traced); restir traces its
# G-buffer tiles and bounces at 1920x1080, refmode 262,144 bounce rays
LADDER_BATCHES = {
    "restir_tiles": ("primary", 2_073_600),
    "restir_bounces": ("bounce", 2_073_600),
    "refmode_bounces": ("bounce", 262_144),
}


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("batch", sorted(LADDER_BATCHES))
def test_kernel_on_ladder_traces(dev, ladder, batch, lean, monkeypatch):
    """Every hit_decode of a ladder trace through closest_hit_bundle
    (its fallback re-traces included) launches the kernel once, and the
    kernel's record equals the plain version's on the same arguments."""
    rays, n = LADDER_BATCHES[batch]
    o, d, tn, tx, presorted = (x[:n] if torch.is_tensor(x) else x
                               for x in ladder[rays])
    tr = ladder["tracers"]
    calls = []
    kernel = ct.hit_decode

    def kept(*args):
        rec = kernel(*args)
        calls.append((args, rec))
        return rec

    monkeypatch.setattr(ct, "hit_decode", kept)
    before = profiler.counters()
    rec, _ = ct.closest_hit_bundle(
        tr.clusters, tr.tables, o, d, tn, tx, tr.scene_min, tr.scene_max,
        presorted=presorted, lean=lean, **tr.shapes_by_class[presorted])
    torch.cuda.synchronize()
    after = profiler.counters()
    assert len(calls) >= 1
    assert after["trace.decode.kernel"] == before.get(
        "trace.decode.kernel", 0) + len(calls)
    assert after.get("trace.decode.plain", 0) == before.get(
        "trace.decode.plain", 0)
    for args, got in calls:
        _assert_same(got, ct.hit_decode_reference(*args))
    assert (~rec.missed).sum() > n // 4

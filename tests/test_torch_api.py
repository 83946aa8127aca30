"""The port does all the JAX package does: every public top-level function
and method of raytracer2_tpu, with every parameter, has a counterpart in
the same-named module of raytracer2_tpu_torch, but for the declared
exceptions below, each with its reason.

Both packages are read as source with ast; neither is imported. The TPU
kernel modules map to their port modules (pallas_traverse -> cuda_traverse,
pallas_cull -> cull, pallas_pairs -> cuda_pairs, pallas_binning ->
binning), and their entry points to the port's names.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE, PORT = "raytracer2_tpu", "raytracer2_tpu_torch"

MODULES = {"pallas_traverse": "cuda_traverse", "pallas_cull": "cull",
           "pallas_pairs": "cuda_pairs", "pallas_binning": "binning"}
FUNCTIONS = {"closest_hit_bundle_pallas": "closest_hit_bundle",
             "occluded_bundle_pallas": "occluded_bundle",
             "nearest_box_pallas": "nearest_box",
             "bundle_union_pallas": "bundle_union"}

_TPU = "a Pallas option of the TPU: the port's kernels have no interpret mode"
_TABLES = ("the port's WalkTables carries the per-scene tables (built once "
           "by make_tracers)")
_OVERFLOW = "the port always returns the overflow count or flag"
_CULL_KERNEL = ("cull_kernel: B3 and B4 are the card's only form of the "
                "exact cull's dense passes, so there is nothing to switch "
                "(PR 12)")
_CONSTANT = "a module constant of the port since PR 1's review"
_SHARDING = ("a jax.sharding helper: the port shards over "
             "torch.distributed (parallel/)")
_UNUSED = "no caller or test in the repository passes it"

# (JAX module, function or Class.method) -> {parameter or "*": reason}
DECLARED = {
    ("ops.pallas_traverse", "closest_hit_bundle_pallas"): {
        "interpret": _TPU, "with_overflow": _OVERFLOW,
        "tri_geometry": _TABLES, "tri_primitive": _TABLES,
        "wald_rows": _TABLES, "meta_rows": _TABLES,
        "cull_kernel": _CULL_KERNEL, "fallback_bundles": _CONSTANT},
    ("ops.pallas_traverse", "occluded_bundle_pallas"): {
        "interpret": _TPU, "with_overflow": _OVERFLOW, "wald_rows": _TABLES,
        "cull_kernel": _CULL_KERNEL, "fallback_bundles": _CONSTANT},
    ("ops.pallas_cull", "box_rows"): {"*": _CULL_KERNEL + "; the wrapper "
                                      "stages the [6, C] box rows itself"},
    ("ops.pallas_cull", "cull_kernel_fits"): {"*": _CULL_KERNEL},
    ("ops.pallas_cull", "nearest_box_pallas"): {
        "boxes": "the port takes the boxes' corners (amin, amax)",
        "interpret": _TPU},
    ("ops.pallas_cull", "bundle_union_pallas"): {
        "boxes": "the port takes the boxes' corners (amin, amax)",
        "mb": "a TPU grid shape: the port's kernel tiles the boxes",
        "interpret": _TPU},
    ("ops.pallas_pairs", "closest_hit_pairs"): {
        "tri_geometry": _TABLES, "tri_primitive": _TABLES,
        "ray_batch": _CONSTANT, "interpret": _TPU,
        "with_overflow": _OVERFLOW},
    ("ops.pallas_pairs", "occluded_pairs"): {"ray_batch": _CONSTANT,
                                             "interpret": _TPU},
    ("ops.pallas_binning", "scatter_rate_probe"): {"interpret": _TPU},
    ("ops.traverse_bundle", "closest_hit_bundle"): {
        "max_candidates": "unread in JAX's _trace_bundles too; removed in "
                          "PR 12's review"},
    ("ops.traverse_bundle", "occluded_bundle"): {
        "max_candidates": "unread in JAX's _trace_bundles too; removed in "
                          "PR 12's review"},
    ("parallel.mesh", "row_sharding"): {"*": _SHARDING},
    ("parallel.mesh", "replicated"): {"*": _SHARDING},
    ("parallel.mesh", "make_mesh"): {"devices": _SHARDING},
    ("parallel.halo", "exchange_row_halos"): {"axis_name": _SHARDING},
    ("lights.prepare", "prepare_lights"): {"emission_scale": _UNUSED,
                                           "build_env_pdf": _UNUSED},
    ("scene.scene", "get_geometry_from_hit"): {
        "roughness_override": _UNUSED, "emission_scale": _UNUSED},
    ("restir.di_reservoir", "finalize_resampling"): {"active": _UNUSED},
    ("render.frame", "Renderer.light_ctx"): {"ris_buffer": _UNUSED},
    ("utils.profiler", "PassTimer.block"): {
        "*": "cut in PR 7's review: the port's timer syncs the device"},
    ("utils.profiler", "PassTimer.time"): {
        "result": "cut in PR 7's review: the port's timer syncs the device"},
    ("lights.shaping", "test_sphere_intersection_for_shaped_light"): {
        "*": "ported as sphere_intersects_shaped_light: a test_ name is "
             "not wanted in the package"},
}


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def public_api(package: str) -> dict:
    """{(module, name): parameters} of a package's public top-level
    functions and public methods of its public classes (module relative
    to the package, dotted; name "Class.method" for a method)."""
    root = ROOT / package
    out = {}
    for path in sorted(root.rglob("*.py")):
        module = ".".join(path.relative_to(root).with_suffix("").parts)
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not node.name.startswith("_")):
                out[(module, node.name)] = _params(node)
            elif (isinstance(node, ast.ClassDef)
                  and not node.name.startswith("_")):
                for sub in node.body:
                    if (isinstance(sub, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                            and not sub.name.startswith("_")):
                        out[(module, f"{node.name}.{sub.name}")] = \
                            _params(sub)
    return out


def counterpart(module: str, name: str) -> tuple[str, str]:
    """The port module and name of a JAX package function."""
    parts = module.split(".")
    parts[-1] = MODULES.get(parts[-1], parts[-1])
    return ".".join(parts), FUNCTIONS.get(name, name)


@pytest.fixture(scope="module")
def apis():
    return public_api(JAX_PACKAGE), public_api(PORT)


def _gaps(jax_api, port_api):
    """What the JAX package has and the port lacks: {(module, name):
    ["*"] or the missing parameters}."""
    gaps = {}
    for (module, name), params in sorted(jax_api.items()):
        key = counterpart(module, name)
        if key not in port_api:
            gaps[(module, name)] = ["*"]
            continue
        missing = [p for p in params if p not in port_api[key]]
        if missing:
            gaps[(module, name)] = missing
    return gaps


def test_the_port_has_every_public_function_and_parameter(apis):
    """Every public function, method and parameter of the JAX package
    exists in the port, but the declared exceptions."""
    undeclared = {
        key: [p for p in missing if p not in DECLARED.get(key, {})]
        for key, missing in _gaps(*apis).items()}
    undeclared = {k: v for k, v in undeclared.items() if v}
    assert not undeclared, (
        "public functions or parameters of the JAX package missing from "
        f"the port: {undeclared}")


def test_every_declared_exception_is_still_a_gap(apis):
    """Each declared exception names a function of the JAX package that
    the port still lacks, whole or by the parameters listed: a stale
    entry goes."""
    jax_api, _ = apis
    gaps = _gaps(*apis)
    for key, params in DECLARED.items():
        assert key in jax_api, f"{key} is no function of the JAX package"
        assert all(reason for reason in params.values())
        assert sorted(params) == sorted(gaps.get(key, [])), key


def test_the_scan_sees_both_packages(apis):
    """The scan finds the entry points both packages share, the knobs of
    the bundle walk among them."""
    jax_api, port_api = apis
    assert len(jax_api) > 300 and len(port_api) > 300
    walk = port_api[("ops.cuda_traverse", "closest_hit_bundle")]
    for knob in ("debug_steps", "t_cap", "lean", "depth", "mb", "mm"):
        assert knob in walk
    assert ("compile_cache", "enable_compile_cache") in port_api

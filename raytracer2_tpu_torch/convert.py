"""Carry the JAX package's state across to the port.

Each function takes that state as numpy arrays (the fields of the JAX
NamedTuple or dataclass, nested ones as mappings) and returns the port's
counterpart on `device`, so a test can feed both packages identical
inputs. Nothing here imports JAX: callers convert with np.asarray.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from raytracer2_tpu_torch.lights.polymorphic import LightInfo
from raytracer2_tpu_torch.lights.prepare import SceneLights
from raytracer2_tpu_torch.ops.bvh import BVH
from raytracer2_tpu_torch.ops.cluster import Clusters, clusters_from_arrays
from raytracer2_tpu_torch.ops.cuda_pairs import PairScene
from raytracer2_tpu_torch.ops.intersect import HitRecord
from raytracer2_tpu_torch.params import GConst, PlanarViewConstants
from raytracer2_tpu_torch.render.gbuffer import GBuffer
from raytracer2_tpu_torch.render.gi_passes import SecondaryGBuffer
from raytracer2_tpu_torch.restir.di_reservoir import (
    DIReservoir, PackedDIReservoir)
from raytracer2_tpu_torch.restir.gi_reservoir import GIReservoir
from raytracer2_tpu_torch.restir.regir import OnionLayout, ReGIRGridParameters
from raytracer2_tpu_torch.scene.scene import Scene, scene_from_arrays


def to_numpy_tree(obj):
    """NamedTuples and dataclasses -> dicts of their fields, arrays of any
    framework (anything with __array__) -> numpy; other leaves as they
    are. Turns the JAX package's state into this module's inputs."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {f: to_numpy_tree(getattr(obj, f)) for f in obj._fields}
    if hasattr(obj, "__array__") and not isinstance(obj, np.ndarray):
        return np.asarray(obj)
    return obj


def scene_from_numpy(arrays: Mapping, *, device) -> Scene:
    """Scene from the JAX Scene's fields (`geometry` a mapping of its
    GeometryTable fields; metadata and host copies as they are)."""
    return scene_from_arrays(arrays, device=device)


def clusters_from_numpy(arrays: Mapping, *, device) -> Clusters:
    """Clusters from the JAX Clusters' fields (aabb_min, aabb_max, wald,
    tri_index)."""
    return clusters_from_arrays(arrays, device=device)


def bvh_from_numpy(arrays: Mapping, *, device) -> BVH:
    """BVH from the JAX BVH's fields (left, right, aabb_min, aabb_max,
    tri_order; num_leaves as a number)."""
    return BVH(
        *(torch.from_numpy(np.array(arrays[f])).to(device)
          for f in ("left", "right", "aabb_min", "aabb_max", "tri_order")),
        num_leaves=int(arrays["num_leaves"]))


def pair_scene_from_numpy(arrays: Mapping, *, device) -> PairScene:
    """PairScene from the JAX PairScene's fields (sc_min, sc_max, wald_sc,
    meta_rows; group and s_pad as numbers)."""
    return PairScene(
        *(torch.from_numpy(np.array(arrays[f])).to(device)
          for f in ("sc_min", "sc_max", "wald_sc", "meta_rows")),
        group=int(arrays["group"]), s_pad=int(arrays["s_pad"]))


def hit_record_from_numpy(arrays: Mapping, *, device) -> HitRecord:
    """HitRecord from the JAX HitRecord's fields; uint32 ids become int64."""
    def dev(name, dtype):
        a = np.asarray(arrays[name]).astype(dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return HitRecord(
        t=dev("t", np.float32), u=dev("u", np.float32), v=dev("v", np.float32),
        geometry_index=dev("geometry_index", np.int64),
        primitive_id=dev("primitive_id", np.int64),
        triangle_index=dev("triangle_index", np.int32))


def tensor_from_numpy(a, *, device) -> torch.Tensor:
    """One array as a tensor: uint32 becomes int64 holding the same values
    (the port's uint32 convention), other types keep theirs."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def _tuple_from(cls, arrays: Mapping, device):
    return cls(*(tensor_from_numpy(arrays[f], device=device)
                 for f in cls._fields))


def gbuffer_from_numpy(arrays: Mapping, *, device) -> GBuffer:
    """GBuffer from the JAX GBuffer's fields."""
    return _tuple_from(GBuffer, arrays, device)


def di_reservoir_from_numpy(arrays: Mapping, *, device) -> DIReservoir:
    """DIReservoir from the JAX DIReservoir's fields."""
    return _tuple_from(DIReservoir, arrays, device)


def packed_di_reservoir_from_numpy(arrays: Mapping, *, device
                                   ) -> PackedDIReservoir:
    """PackedDIReservoir from the JAX PackedDIReservoir's fields."""
    return _tuple_from(PackedDIReservoir, arrays, device)


def di_slots_from_numpy(slots, *, device) -> tuple[DIReservoir, ...]:
    """A FrameState's DI reservoir slots from the JAX FrameState's
    di_reservoirs, each slot a mapping of DIReservoir fields."""
    return tuple(di_reservoir_from_numpy(s, device=device) for s in slots)


def regir_params_from_numpy(values: Mapping) -> ReGIRGridParameters:
    """ReGIRGridParameters from the JAX ReGIRGridParameters' fields, the
    onion layout (when set) a mapping of OnionLayout fields."""
    kw = {f.name: values[f.name]
          for f in dataclasses.fields(ReGIRGridParameters)}
    if kw["onion"] is not None:
        kw["onion"] = OnionLayout(**kw["onion"])
    return ReGIRGridParameters(**kw)


def gi_reservoir_from_numpy(arrays: Mapping, *, device) -> GIReservoir:
    """GIReservoir from the JAX GIReservoir's fields."""
    return _tuple_from(GIReservoir, arrays, device)


def secondary_gbuffer_from_numpy(arrays: Mapping, *, device
                                 ) -> SecondaryGBuffer:
    """SecondaryGBuffer from the JAX SecondaryGBuffer's fields."""
    return _tuple_from(SecondaryGBuffer, arrays, device)


def scene_lights_from_numpy(arrays: Mapping, *, device) -> SceneLights:
    """SceneLights from the JAX SceneLights' fields: `lights` a mapping of
    LightInfo fields, the pdf mips as sequences of arrays (env None when
    the scene has no environment pdf)."""
    def mips(m):
        return None if m is None else tuple(
            tensor_from_numpy(a, device=device) for a in m)

    return SceneLights(
        lights=_tuple_from(LightInfo, arrays["lights"], device),
        geometry_to_light=tensor_from_numpy(arrays["geometry_to_light"],
                                            device=device),
        num_local_lights=int(arrays["num_local_lights"]),
        local_pdf_mips=mips(arrays["local_pdf_mips"]),
        env_pdf_mips=mips(arrays["env_pdf_mips"]))


def ris_buffer_from_numpy(a, *, device) -> torch.Tensor:
    """The RIS tile buffer, [S, 2] uint32 words, as int64."""
    return tensor_from_numpy(a, device=device)


def _view(arrays: Mapping | None) -> PlanarViewConstants | None:
    if arrays is None:
        return None
    return PlanarViewConstants(**{
        f: np.asarray(arrays[f], np.float32)
        for f in PlanarViewConstants._fields})


def _dataclass_from(cls, values: Mapping):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        if f.name in ("view", "prev_view"):
            v = _view(v)
        elif isinstance(v, Mapping):
            default = (f.default_factory()
                       if f.default_factory is not dataclasses.MISSING
                       else f.default)
            v = _dataclass_from(type(default), v)
        elif isinstance(v, np.generic) or (
                isinstance(v, np.ndarray) and v.ndim == 0):
            v = v.item()
        elif isinstance(v, (list, np.ndarray)):
            v = tuple(np.asarray(v).tolist())
        kw[f.name] = v
    return cls(**kw)


def gconst_from_numpy(values: Mapping) -> GConst:
    """GConst from the JAX GConst's fields: nested parameter dataclasses as
    mappings, view/prev_view as mappings of PlanarViewConstants arrays,
    scalar arrays (frame, blend_factor, uniform_random_number) as 0-d
    numpy arrays or Python numbers."""
    return _dataclass_from(GConst, values)

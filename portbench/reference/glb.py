"""A GLB reader for the scenes the benchmark writes, into a RefScene.

It keeps what the renderer's import keeps (the reference loader,
src/gltf/mod.rs:50-174): every primitive with indices, positions and
normals, one node per (node, primitive) with the node's local matrix,
vertex colour 1 and uv 0 where absent, base colour, base-colour texture,
metallic and emissive factors; images as RGBA8, made linear by the sRGB
curve. World-space triangles are computed in numpy float32 as the import
computes them (model.rs:185-476).
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct

import numpy as np
import torch

_DTYPES = {5121: np.uint8, 5123: np.uint16, 5125: np.uint32,
           5126: np.float32}
_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}
EMISSION_SCALE = 12.0  # Hit.glsl: emission * 12
ROUGHNESS = 1.0  # Hit.glsl: roughness forced to 1


@dataclasses.dataclass
class RefScene:
    """Per-triangle tensors on one device (T triangles, in node order)."""

    v0: torch.Tensor  # [T, 3] world
    e1: torch.Tensor  # [T, 3]
    e2: torch.Tensor  # [T, 3]
    normals: torch.Tensor  # [T, 3, 3] vertex normals (object space)
    uvs: torch.Tensor  # [T, 3, 2]
    colors: torch.Tensor  # [T, 3, 3] vertex colours (rgb)
    base_color: torch.Tensor  # [T, 3]
    texture: torch.Tensor  # [T] int, -1 for none
    metallic: torch.Tensor  # [T]
    emission: torch.Tensor  # [T, 3], already scaled
    xform: torch.Tensor  # [T, 3, 3] the node matrix
    textures: list  # [H, W, 4] linear float32 each

    @property
    def num_triangles(self) -> int:
        return int(self.v0.shape[0])


def _chunks(data: bytes) -> tuple[dict, bytes]:
    magic, version, _ = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67 or version != 2:
        raise ValueError("not a GLB 2.0 file")
    doc, blob, off = None, b"", 12
    while off + 8 <= len(data):
        n, kind = struct.unpack_from("<II", data, off)
        chunk = data[off + 8:off + 8 + n]
        if kind == 0x4E4F534A:
            doc = json.loads(chunk)
        elif kind == 0x004E4942:
            blob = chunk
        off += 8 + n
    if doc is None:
        raise ValueError("GLB without a JSON chunk")
    return doc, blob


def _accessor(doc: dict, blob: bytes, i: int) -> np.ndarray:
    a = doc["accessors"][i]
    view = doc["bufferViews"][a["bufferView"]]
    dt = np.dtype(_DTYPES[a["componentType"]])
    width = _WIDTH[a["type"]]
    start = view.get("byteOffset", 0) + a.get("byteOffset", 0)
    row = dt.itemsize * width
    stride = view.get("byteStride", row)
    raw = np.frombuffer(blob, np.uint8, count=stride * (a["count"] - 1) + row,
                        offset=start)
    rows = np.lib.stride_tricks.as_strided(raw, (a["count"], row), (stride, 1))
    return np.ascontiguousarray(rows).view(dt).reshape(a["count"], width)


def _matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] += np.asarray(node["translation"], np.float32)
    return m


def _image(doc: dict, blob: bytes, i: int) -> np.ndarray:
    from PIL import Image

    view = doc["bufferViews"][doc["images"][i]["bufferView"]]
    off = view.get("byteOffset", 0)
    img = Image.open(io.BytesIO(blob[off:off + view["byteLength"]]))
    rgba = np.asarray(img.convert("RGBA"), np.float32) / 255.0
    rgb = rgba[..., :3]
    rgb = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return np.concatenate([rgb, rgba[..., 3:]], axis=-1).astype(np.float32)


def load_glb(data: bytes, device) -> RefScene:
    doc, blob = _chunks(data)
    parts = {k: [] for k in ("v0", "e1", "e2", "n", "uv", "col", "base",
                             "tex", "met", "em", "xf")}
    materials = doc.get("materials", [])
    for node in doc.get("nodes", []):
        if "mesh" not in node:
            continue
        m4 = _matrix(node)
        for prim in doc["meshes"][node["mesh"]]["primitives"]:
            attrs = prim.get("attributes", {})
            if ("indices" not in prim or "POSITION" not in attrs
                    or "NORMAL" not in attrs):
                continue
            pos = _accessor(doc, blob, attrs["POSITION"]).astype(np.float32)
            nrm = _accessor(doc, blob, attrs["NORMAL"]).astype(np.float32)
            count = pos.shape[0]
            uv = (_accessor(doc, blob, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else np.zeros((count, 2), np.float32))
            col = (_accessor(doc, blob, attrs["COLOR_0"]).astype(np.float32)
                   if "COLOR_0" in attrs else np.ones((count, 4), np.float32))
            idx = _accessor(doc, blob, prim["indices"]).astype(np.int64)
            idx = idx.reshape(-1, 3)
            p = pos[idx]
            pw = p @ m4[:3, :3].T + m4[:3, 3]
            t = idx.shape[0]
            mat = materials[prim["material"]] if "material" in prim else {}
            pbr = mat.get("pbrMetallicRoughness", {})
            tex = pbr.get("baseColorTexture")
            parts["v0"].append(pw[:, 0])
            parts["e1"].append(pw[:, 1] - pw[:, 0])
            parts["e2"].append(pw[:, 2] - pw[:, 0])
            parts["n"].append(nrm[idx])
            parts["uv"].append(uv[idx])
            parts["col"].append(col[idx][..., :3])
            parts["base"].append(np.broadcast_to(np.asarray(
                pbr.get("baseColorFactor", [1, 1, 1, 1])[:3], np.float32),
                (t, 3)))
            parts["tex"].append(np.full(t, -1 if tex is None
                                        else tex["index"], np.int64))
            parts["met"].append(np.full(t, pbr.get("metallicFactor", 1.0),
                                        np.float32))
            parts["em"].append(np.broadcast_to(np.asarray(
                mat.get("emissiveFactor", [0, 0, 0]), np.float32)
                * np.float32(EMISSION_SCALE), (t, 3)))
            parts["xf"].append(np.broadcast_to(m4[:3, :3], (t, 3, 3)))

    def dev(key, dtype=torch.float32):
        arr = np.ascontiguousarray(np.concatenate(parts[key]))
        return torch.as_tensor(arr).to(device=device, dtype=dtype)

    textures = [torch.as_tensor(_image(doc, blob, t["source"])).to(device)
                for t in doc.get("textures", [])]
    return RefScene(v0=dev("v0"), e1=dev("e1"), e2=dev("e2"),
                    normals=dev("n"), uvs=dev("uv"), colors=dev("col"),
                    base_color=dev("base"), texture=dev("tex", torch.int64),
                    metallic=dev("met"), emission=dev("em"), xform=dev("xf"),
                    textures=textures)

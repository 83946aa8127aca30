"""The benchmark's frozen copy of the procedural scene generators.

A copy of GlbBuilder, quad, uv_sphere, checkerboard_png, corridor_glb and
emissive_stress_glb as raytracer2_tpu_torch/models/procedural.py has them,
so that a change to the program's generators cannot change the scenes the
benchmark renders. portbench/tests/test_portbench_scenes.py holds the two
byte for byte while they agree. A configuration names its generator in
GENERATORS and gives its keyword arguments.
"""

from __future__ import annotations

import json
import struct

import numpy as np


# ---------------------------------------------------------------------------
# Minimal GLB writer
# ---------------------------------------------------------------------------

class GlbBuilder:
    """Assembles meshes/materials/nodes into a GLB binary."""

    def __init__(self):
        self._bin = bytearray()
        self.accessors = []
        self.buffer_views = []
        self.meshes = []
        self.nodes = []
        self.materials = []
        self.images = []
        self.textures = []
        self.samplers = []

    def _push_blob(self, data: bytes, target: int | None) -> int:
        # 4-byte alignment
        while len(self._bin) % 4:
            self._bin.append(0)
        view = {"buffer": 0, "byteOffset": len(self._bin),
                "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        self._bin.extend(data)
        self.buffer_views.append(view)
        return len(self.buffer_views) - 1

    def _push_accessor(self, arr: np.ndarray, type_str: str,
                       component: int, target: int) -> int:
        view = self._push_blob(arr.tobytes(), target)
        acc = {
            "bufferView": view, "componentType": component,
            "count": arr.shape[0], "type": type_str,
        }
        if type_str == "VEC3" and component == 5126:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_material(self, base_color=(1, 1, 1, 1), emissive=(0, 0, 0),
                     metallic=0.0, roughness=1.0, texture_index=None) -> int:
        pbr = {"baseColorFactor": list(base_color),
               "metallicFactor": metallic, "roughnessFactor": roughness}
        if texture_index is not None:
            pbr["baseColorTexture"] = {"index": texture_index}
        self.materials.append(
            {"pbrMetallicRoughness": pbr, "emissiveFactor": list(emissive)})
        return len(self.materials) - 1

    def add_texture_png(self, png_bytes: bytes) -> int:
        view = self._push_blob(png_bytes, None)
        self.images.append({"bufferView": view, "mimeType": "image/png"})
        self.samplers.append({"magFilter": 9729, "minFilter": 9729,
                              "wrapS": 10497, "wrapT": 10497})
        self.textures.append({"source": len(self.images) - 1,
                              "sampler": len(self.samplers) - 1})
        return len(self.textures) - 1

    def add_mesh(self, positions: np.ndarray, normals: np.ndarray,
                 indices: np.ndarray, material: int,
                 uvs: np.ndarray | None = None,
                 colors: np.ndarray | None = None) -> int:
        attrs = {
            "POSITION": self._push_accessor(
                np.ascontiguousarray(positions, np.float32), "VEC3", 5126, 34962),
            "NORMAL": self._push_accessor(
                np.ascontiguousarray(normals, np.float32), "VEC3", 5126, 34962),
        }
        if uvs is not None:
            attrs["TEXCOORD_0"] = self._push_accessor(
                np.ascontiguousarray(uvs, np.float32), "VEC2", 5126, 34962)
        if colors is not None:
            attrs["COLOR_0"] = self._push_accessor(
                np.ascontiguousarray(colors, np.float32), "VEC4", 5126, 34962)
        idx = self._push_accessor(
            np.ascontiguousarray(indices.reshape(-1, 1), np.uint32),
            "SCALAR", 5125, 34963)
        self.meshes.append({"primitives": [
            {"attributes": attrs, "indices": idx, "material": material}]})
        return len(self.meshes) - 1

    def add_node(self, mesh: int, matrix: np.ndarray | None = None,
                 translation=None) -> int:
        node: dict = {"mesh": mesh}
        if matrix is not None:
            node["matrix"] = [float(x) for x in np.asarray(matrix).T.reshape(-1)]
        if translation is not None:
            node["translation"] = list(translation)
        self.nodes.append(node)
        return len(self.nodes) - 1

    def build(self) -> bytes:
        doc = {
            "asset": {"version": "2.0", "generator": "raytracer2_tpu"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(self.nodes)))}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "materials": self.materials,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [{"byteLength": len(self._bin)}],
        }
        if self.images:
            doc["images"] = self.images
            doc["textures"] = self.textures
            doc["samplers"] = self.samplers
        js = json.dumps(doc, separators=(",", ":")).encode()
        js += b" " * (-len(js) % 4)
        bin_data = bytes(self._bin) + b"\x00" * (-len(self._bin) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_data)
        out = struct.pack("<III", 0x46546C67, 2, total)
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(bin_data), 0x004E4942) + bin_data
        return out


# ---------------------------------------------------------------------------
# Primitive mesh generators
# ---------------------------------------------------------------------------

def quad(corner: np.ndarray, edge_u: np.ndarray, edge_v: np.ndarray):
    """Two-triangle quad; normal = normalize(cross(edge_u, edge_v))."""
    corner = np.asarray(corner, np.float32)
    eu = np.asarray(edge_u, np.float32)
    ev = np.asarray(edge_v, np.float32)
    pos = np.stack([corner, corner + eu, corner + eu + ev, corner + ev])
    n = np.cross(eu, ev)
    n = n / np.linalg.norm(n)
    normals = np.broadcast_to(n, (4, 3)).copy()
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return pos.astype(np.float32), normals.astype(np.float32), uvs, indices


def uv_sphere(radius: float, n_lat: int, n_lon: int, center=(0, 0, 0)):
    """Latitude/longitude sphere, ~2*n_lat*n_lon triangles."""
    la = np.linspace(0, np.pi, n_lat + 1)
    lo = np.linspace(0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(la, lo, indexing="ij")
    x = np.sin(th) * np.cos(ph)
    y = np.cos(th)
    z = np.sin(th) * np.sin(ph)
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    pos = normals * radius + np.asarray(center, np.float32)
    uvs = np.stack([ph / (2 * np.pi), th / np.pi], -1).reshape(-1, 2)
    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * (n_lon + 1) + j
            b = a + n_lon + 1
            idx += [a, b, a + 1, a + 1, b, b + 1]
    return (pos.astype(np.float32), normals,
            uvs.astype(np.float32), np.asarray(idx, np.uint32))


def checkerboard_png(size: int = 64, cells: int = 8) -> bytes:
    """Generate a checkerboard PNG via PIL (tests the image decode path)."""
    import io

    from PIL import Image

    x = np.arange(size)
    cell = size // cells
    pattern = ((x[:, None] // cell + x[None, :] // cell) % 2).astype(np.uint8)
    img = np.stack([pattern * 255, pattern * 160 + 60, 255 - pattern * 200],
                   axis=-1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, format="PNG")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Benchmark scenes
# ---------------------------------------------------------------------------

def emissive_stress_glb(num_lights: int = 1024) -> bytes:
    """Emissive-heavy scene: a field of small emissive quads over a floor
    (BASELINE config 4: 1k+ area lights)."""
    b = GlbBuilder()
    rng = np.random.default_rng(11)
    floor = b.add_material(base_color=(0.6, 0.6, 0.6, 1.0))
    pos, nrm, uvs, idx = quad([-50, 0, -50], [0, 0, 100], [100, 0, 0])
    b.add_node(b.add_mesh(pos, nrm, idx, floor, uvs=uvs))
    side = int(np.ceil(np.sqrt(num_lights)))
    count = 0
    for i in range(side):
        for j in range(side):
            if count >= num_lights:
                break
            count += 1
            col = rng.uniform(0.5, 8.0, 3)
            mat = b.add_material(base_color=(1, 1, 1, 1), emissive=tuple(col))
            x = (i / side - 0.5) * 90
            z = (j / side - 0.5) * 90
            pos, nrm, uvs, idx = quad([x, 3.0, z], [0.5, 0, 0], [0, 0, 0.5])
            b.add_node(b.add_mesh(pos, nrm, idx, mat, uvs=uvs))
    return b.build()


def corridor_glb(segments: int = 24, pillars_per_side: int = 12,
                 lat: int = 10, lon: int = 14) -> bytes:
    """A Sponza-class corridor: walls/floor/ceiling segments + pillar rows +
    sphere clutter, a few hundred k triangles at default scale
    (BASELINE config 3 stand-in)."""
    b = GlbBuilder()
    tex = b.add_texture_png(checkerboard_png(128, 16))
    wall = b.add_material(base_color=(0.75, 0.7, 0.6, 1.0), texture_index=tex)
    stone = b.add_material(base_color=(0.5, 0.5, 0.55, 1.0))
    lamp = b.add_material(base_color=(1, 1, 1, 1), emissive=(6.0, 5.0, 4.0))
    seg_len = 4.0
    width, height = 12.0, 8.0
    for s in range(segments):
        z0 = s * seg_len
        # interior-facing normals (see cornell_box_glb)
        for (c, eu, ev, mat) in [
            ([-width / 2, 0, z0], [0, 0, seg_len], [width, 0, 0], wall),   # floor +y
            ([-width / 2, height, z0], [width, 0, 0], [0, 0, seg_len], wall),  # ceiling -y
            ([-width / 2, 0, z0], [0, height, 0], [0, 0, seg_len], wall),  # left +x
            ([width / 2, 0, z0], [0, 0, seg_len], [0, height, 0], wall),   # right -x
        ]:
            pos, nrm, uvs, idx = quad(c, eu, ev)
            b.add_node(b.add_mesh(pos, nrm, idx, mat, uvs=uvs))
        if s % 4 == 0:  # ceiling lamp (-y, facing the floor)
            pos, nrm, uvs, idx = quad([-1, height - 0.1, z0 + 1], [2, 0, 0], [0, 0, 2])
            b.add_node(b.add_mesh(pos, nrm, idx, lamp, uvs=uvs))
    # pillar rows: stacks of spheres (dense triangle load)
    for side in (-1, 1):
        for p in range(pillars_per_side):
            z = (p + 0.5) * segments * seg_len / pillars_per_side
            for y in (1.0, 3.0, 5.0):
                pos, nrm, uvs, idx = uv_sphere(
                    0.9, lat, lon, center=(side * width * 0.35, y, z))
                b.add_node(b.add_mesh(pos, nrm, idx, stone, uvs=uvs))
    return b.build()


GENERATORS = {"corridor_glb": corridor_glb,
              "emissive_stress_glb": emissive_stress_glb}

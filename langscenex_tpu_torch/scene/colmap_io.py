"""COLMAP sparse reconstructions, binary and text, port of the JAX
``scene/colmap_io.py`` (field_construction/scene/colmap_loader.py).

The JAX package parses ``images.bin`` and ``points3D.bin`` with a C++
library built at first use (``native/colmap_parse.cpp``); here the
parsers are numpy: one pass over the variable-length records reads only
their lengths and gathers the fixed-width part of each, and every field
is then read at once with ``np.frombuffer`` over a structured dtype (a
points3D.bin without tracks is one table read). The arrays are the
native parser's: ``points3D.bin`` gives xyz [n,3] f64,
rgb [n,3] f64 and error [n,1] f64. Layouts:

  cameras.bin:  num(Q), then per camera: id(i) model(i) width(Q) height(Q)
                params(d * model_params)
  images.bin:   num(Q), then per image: id(i) qvec(4d) tvec(3d)
                camera_id(i) name(zero-terminated) npoints(Q)
                (x d, y d, id q) * npoints
  points3D.bin: num(Q), then per point: id(Q) xyz(3d) rgb(3B) error(d)
                track_len(Q) (image_id i, point2D i) * track_len
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Tuple

import numpy as np

CAMERA_MODEL_PARAMS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODEL_PARAMS.items()}

_CAMERA_HEAD = np.dtype([("id", "<i4"), ("model", "<i4"), ("width", "<u8"),
                         ("height", "<u8")])
_IMAGE_HEAD = np.dtype([("id", "<i4"), ("qvec", "<f8", 4),
                        ("tvec", "<f8", 3), ("camera_id", "<i4")])
_POINT = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                   ("error", "<f8"), ("track_len", "<u8")])


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _read(path: str) -> Tuple[bytes, int]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: truncated COLMAP file")
    return data, struct.unpack_from("<Q", data)[0]


def _truncated(path: str):
    return ValueError(f"{path}: truncated or corrupt COLMAP file")


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    data, n = _read(path)
    out, pos = {}, 8
    for _ in range(n):
        if pos + _CAMERA_HEAD.itemsize > len(data):
            raise _truncated(path)
        head = np.frombuffer(data, _CAMERA_HEAD, 1, pos)[0]
        name, n_params = CAMERA_MODEL_PARAMS[int(head["model"])]
        pos += _CAMERA_HEAD.itemsize
        if pos + 8 * n_params > len(data):
            raise _truncated(path)
        params = np.frombuffer(data, "<f8", n_params, pos).astype(np.float64)
        pos += 8 * n_params
        cid = int(head["id"])
        out[cid] = ColmapCamera(cid, name, int(head["width"]),
                                int(head["height"]), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    data, n = _read(path)
    heads, names = [], []
    pos = 8
    for _ in range(n):          # walk the names and the 2D-point tracks
        end = data.find(b"\0", pos + _IMAGE_HEAD.itemsize)
        if end < 0 or end + 9 > len(data):
            raise _truncated(path)
        heads.append(data[pos:pos + _IMAGE_HEAD.itemsize])
        names.append(data[pos + _IMAGE_HEAD.itemsize:end].decode("utf-8"))
        npts = struct.unpack_from("<Q", data, end + 1)[0]
        pos = end + 9 + 24 * npts
        if pos > len(data):
            raise _truncated(path)
    heads = np.frombuffer(b"".join(heads), _IMAGE_HEAD, n)
    return {int(h["id"]): ColmapImage(int(h["id"]), h["qvec"].copy(),
                                      h["tvec"].copy(), int(h["camera_id"]),
                                      name)
            for h, name in zip(heads, names)}


def read_points3d_binary(path: str
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """points3D.bin -> (xyz [n,3] f64, rgb [n,3] f64, error [n,1] f64)."""
    data, n = _read(path)
    rec = _POINT.itemsize
    if len(data) == 8 + n * rec:        # no tracks: one fixed-width table
        pts = np.frombuffer(data, _POINT, n, 8)
    else:
        parts, pos = [], 8
        for _ in range(n):
            if pos + rec > len(data):
                raise _truncated(path)
            parts.append(data[pos:pos + rec])
            pos += rec + 8 * struct.unpack_from("<Q", data, pos + rec - 8)[0]
        if pos > len(data):
            raise _truncated(path)
        pts = np.frombuffer(b"".join(parts), _POINT, n)
    return (pts["xyz"].astype(np.float64), pts["rgb"].astype(np.float64),
            pts["error"].astype(np.float64).reshape(-1, 1))


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            out[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    # header and 2D-point lines alternate; a points line may be empty, so
    # alternate on raw lines
    out = {}
    expecting_points = False
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            if expecting_points:
                expecting_points = False
                continue
            stripped = line.strip()
            if not stripped:
                continue
            el = stripped.split()
            out[int(el[0])] = ColmapImage(
                int(el[0]), np.array([float(x) for x in el[1:5]]),
                np.array([float(x) for x in el[5:8]]), int(el[8]), el[9])
            expecting_points = True
    return out


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyzs.append([float(x) for x in el[1:4]])
            rgbs.append([int(x) for x in el[4:7]])
            errs.append([float(el[7])])
    return np.array(xyzs), np.array(rgbs), np.array(errs)


# ------------------------------------------------------------- writers
# (utils/sfm_utils.py:205-320 writes these for the MASt3R/CUT3R paths)

def write_cameras_text(cameras: Dict[int, ColmapCamera], path: str):
    with open(path, "w") as f:
        f.write("# Camera list\n")
        for cam in cameras.values():
            params = " ".join(str(p) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: Dict[int, ColmapImage], path: str):
    with open(path, "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            q = " ".join(str(x) for x in im.qvec)
            t = " ".join(str(x) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")


def write_cameras_binary(cameras: Dict[int, ColmapCamera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<iiQQ", cam.id, MODEL_NAME_TO_ID[cam.model],
                                int(cam.width), int(cam.height)))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_images_binary(images: Dict[int, ColmapImage], path: str):
    """images.bin with empty 2D-point tracks (the MASt3R/CUT3R export has
    no per-image observations)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            head = np.zeros(1, _IMAGE_HEAD)
            head["id"], head["camera_id"] = im.id, im.camera_id
            head["qvec"], head["tvec"] = im.qvec, im.tvec
            f.write(head.tobytes() + im.name.encode("utf-8") + b"\0"
                    + struct.pack("<Q", 0))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray,
                          errors: np.ndarray = None):
    """points3D.bin with empty tracks; rgb in [0,255] uint8."""
    n = xyz.shape[0]
    rec = np.zeros(n, _POINT)
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"] = xyz
    rec["rgb"] = np.asarray(rgb).astype(np.int64)
    rec["error"] = 0.0 if errors is None else np.asarray(errors).reshape(n)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n) + rec.tobytes())


def write_points3d_text(path: str, xyz: np.ndarray, rgb: np.ndarray,
                        errors: np.ndarray = None):
    n = xyz.shape[0]
    err = (np.zeros(n) if errors is None else np.asarray(errors).reshape(n))
    with open(path, "w") as f:
        f.write("# 3D point list\n")
        for i in range(n):
            x, y, z = (float(v) for v in xyz[i])
            r, g, b = (int(v) for v in rgb[i])
            f.write(f"{i + 1} {x} {y} {z} {r} {g} {b} {float(err[i])}\n")

"""Map export and wire formats (numpy).

Port of ``slamnet_tpu/io/export.py``, the reference's serializers
(SURVEY.md §5.4), built "for sending maps to a robot base station":

- ``packed_hole_pixels``  — HoleMap.GetPackedPixels 4-bit packing
  (CoreSLAM/HoleMap.cs:44-55)
- ``occupancy_bitmap``    — GridMap.GetBitmapData branchless grayscale
  (HectorSLAM/Map/GridMap.cs:104-115): 127 unscanned, 0 occupied, 254 free
- ``hole_map_u16``        — the hole map in its native 65535-gray form for
  Gray16 rendering (MainWindow.xaml.cs:227-229)
- pose byte codec         — VectorEx Vector3 (de)serialization
  (BaseSLAM/VectorEx.cs:68-119)

Every function takes numpy arrays or tensors on any device: a tensor is
copied to the host once (``.cpu()``) and the rest is numpy, so the outputs
equal the JAX package's bit for bit.
"""
from __future__ import annotations

import struct

import numpy as np
import torch


def host(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor copied to the host once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def packed_hole_pixels(hole_map_flat) -> np.ndarray:
    """4 bits per pixel: byte i packs pixels 2i (high nibble) and 2i+1 (low)."""
    px = host(hole_map_flat).astype(np.uint16)
    hi = (px[0::2] >> 12).astype(np.uint8)
    lo = (px[1::2] >> 12).astype(np.uint8)
    return ((hi << 4) | lo).astype(np.uint8)


def unpack_hole_pixels(packed) -> np.ndarray:
    """Inverse (lossy: restores the top nibble scaled back to 16 bits)."""
    packed = host(packed).astype(np.uint8)
    out = np.empty(packed.size * 2, np.uint16)
    out[0::2] = (packed.astype(np.uint16) >> 4) << 12
    out[1::2] = (packed.astype(np.uint16) & 0xF) << 12
    return out


def hole_map_u16(hole_map_flat, size: int) -> np.ndarray:
    """[size, size] uint16 image of the hole map (Gray16 rendering form)."""
    return host(hole_map_flat).astype(np.uint16).reshape(size, size)


def occupancy_bitmap(logodds_flat, size: int) -> np.ndarray:
    """Branchless ``127 - sign(v) * 127`` grayscale (GridMap.cs:104-115)."""
    v = host(logodds_flat).reshape(size, size)
    return (127 - np.sign(v) * 127).astype(np.uint8)


def obstacle_bitmap(obstacle_map) -> np.ndarray:
    """Obstacle map as grayscale: unmapped mid-gray, clear white, hits dark."""
    om = host(obstacle_map).astype(np.int32)
    img = np.full(om.shape, 127, np.uint8)
    img[om == 0] = 254
    img[om > 0] = np.clip(127 - om[om > 0] * 12, 0, 127).astype(np.uint8)
    return img


def pose_to_bytes(pose) -> bytes:
    """Vector3 -> 12 little-endian float bytes (VectorEx.ToBytes semantics)."""
    p = host(pose).astype(np.float32)
    return struct.pack("<3f", float(p[0]), float(p[1]), float(p[2]))


def pose_from_bytes(data: bytes, offset: int = 0) -> np.ndarray:
    return np.asarray(struct.unpack_from("<3f", data, offset), np.float32)


def vec2_to_bytes(v) -> bytes:
    """Vector2 -> 8 little-endian float bytes (VectorEx.GetBytes(Vector2),
    BaseSLAM/VectorEx.cs:68-77)."""
    p = host(v).astype(np.float32)
    return struct.pack("<2f", float(p[0]), float(p[1]))


def vec2_from_bytes(data: bytes, offset: int = 0) -> np.ndarray:
    """Bytes -> Vector2 (VectorEx.ToVector2, BaseSLAM/VectorEx.cs:85-90)."""
    return np.asarray(struct.unpack_from("<2f", data, offset), np.float32)


def pose_string(pose) -> str:
    """Human pose formatter matching VectorEx.ToPoseString
    (BaseSLAM/VectorEx.cs:194-197): "{x:f2}m x {y:f2}m @ {deg:f2}deg"."""
    p = host(pose).astype(np.float64)
    return f"{p[0]:.2f}m x {p[1]:.2f}m @ {np.degrees(p[2]):.2f}\N{DEGREE SIGN}"

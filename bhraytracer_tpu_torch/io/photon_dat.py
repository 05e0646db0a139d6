"""Reference-compatible photon map `.dat` serialization (a copy of
bhraytracer_tpu/io/photon_dat.py: the port reads and writes the same
bytes).

The reference dumps its raw `Photon[]` to Resource/*.dat (Main.cpp:288-294,
379-385) and reloads via InitializePhotonMapByFile (cyPhotonMap.h:409-417,
which re-balances on load — so on-disk ordering does not matter). The
PhotonMapViewer tool reads the same bytes (PhotonMapViz.cpp:30-36).

Layout (24 bytes, natural alignment; cyPhotonMap.h:72-90):
  float32 x, y, z          — position
  float32 power            — max channel of the power color
  uint8   r, g, b          — Color24 of power / max
  uint8   planeAndDirZ     — kd plane (2 bits) | dir.z sign (bit 3)
  int16   dirX, dirY       — direction x/y scaled by 0x7FFF

Direction decode replicates the reference's integer routine including its
`dirX*dirX + dirY - dirY` bug (cyPhotonMap.h:196): z = sqrt(1 - x^2),
ignoring y.
"""

from __future__ import annotations

import numpy as np

PHOTON_DTYPE = np.dtype(
    [
        ("pos", np.float32, 3),
        ("power", np.float32),
        ("color", np.uint8, 3),
        ("plane_dirz", np.uint8),
        ("dir_x", np.int16),
        ("dir_y", np.int16),
    ]
)
assert PHOTON_DTYPE.itemsize == 24


def encode_photons(pos: np.ndarray, direction: np.ndarray, power: np.ndarray) -> np.ndarray:
    """Pack (P,3) pos, (P,3) unit directions, (P,3) power colors."""
    p = np.zeros(pos.shape[0], PHOTON_DTYPE)
    p["pos"] = pos.astype(np.float32)
    maxp = np.maximum(power.max(axis=1), 1e-30)
    p["power"] = maxp
    # Color24(c / power): scale then FloatToByte (clamp [0,1] * 255 + .5).
    p["color"] = np.clip(power / maxp[:, None] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    p["dir_x"] = (direction[:, 0] * 0x7FFF).astype(np.int16)
    p["dir_y"] = (direction[:, 1] * 0x7FFF).astype(np.int16)
    p["plane_dirz"] = np.where(direction[:, 2] > 0, 0, 8).astype(np.uint8)
    return p


def decode_photons(raw: np.ndarray):
    """Unpack to (pos, direction, power). Replicates GetPower/GetDirection
    (cyPhotonMap.h:163, 192-215) including the z = sqrt(1-x^2) quirk."""
    pos = raw["pos"].astype(np.float32)
    power = raw["color"].astype(np.float32) / 255.0 * raw["power"][:, None]
    x = raw["dir_x"].astype(np.float32) / 0x7FFF
    y = raw["dir_y"].astype(np.float32) / 0x7FFF
    z = np.sqrt(np.maximum(1.0 - x * x, 0.0))  # dirY ignored, as in the ref
    z = np.where(raw["plane_dirz"] & 8, -z, z)
    return pos, np.stack([x, y, z], axis=1), power


def write_dat(path: str, pos, direction, power) -> None:
    encode_photons(np.asarray(pos), np.asarray(direction), np.asarray(power)).tofile(path)


def read_dat(path: str):
    return decode_photons(np.fromfile(path, PHOTON_DTYPE))

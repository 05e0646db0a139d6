"""Background and environment colours (the constant-colour branch of
bhraytracer_tpu/ops/texturing.py). Texture maps are not ported yet
(ROADMAP Queue 1, item 8); render_image refuses scenes that use them.
"""

from __future__ import annotations


def environment_valid(direction):
    """Where SampleEnvironment's lat-long mapping (scene.h:414-420) is
    defined: invalid directions (|dir.z| > 1 on an unnormalised direction,
    or dir.x = dir.y = 0) contribute zero (MtlBlinn.cpp:418-423). With a
    constant environment the mapped uv itself is never read."""
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    return (dz.abs() <= 1.0) & ((dx.abs() + dy.abs()) > 0.0)


def sample_environment(pack, direction):
    """environment.SampleEnvironment(dir) -> (colour (N,3), valid (N,))."""
    valid = environment_valid(direction)
    return pack.env_color.expand(direction.shape), valid


def sample_background(pack, n: int):
    """background.Sample for primary-ray misses (Main.cpp:166-167)."""
    return pack.bg_color.expand(n, 3)

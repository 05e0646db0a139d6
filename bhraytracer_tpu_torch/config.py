"""Render configuration (trimmed from bhraytracer_tpu/config.py).

One chunk driver, no TPU knobs: the JAX package's `ablate`,
`fused_levels`, `level_presort`, `*_reorder`, `inflight_chunks` and
`remat_levels` fields have no counterpart here (per-level remat was the
TPU's memory workaround for gradients).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer configuration. Defaults mirror the reference build's
    compiled-in constants (see bhraytracer_tpu/config.py for sources)."""

    spp: int = 32
    # Reflect/refract (TIR) bounce budget, decremented only on TIR.
    tir_bounces: int = 16
    gi_bounces: int = 3
    # Extra shade-tree levels past the GI budget where refraction chains
    # may continue (total depth gi_bounces + 1 + extra_refr_levels).
    extra_refr_levels: int = 2
    gamma: float = 2.2
    use_gamma: bool = True
    bias: float = 1e-4
    shadow_bias: float = 1e-5
    # Glossy-refraction rejection-sampling tries.
    refr_gloss_tries: int = 4
    # Texture filtering taps (TEXTURE_SAMPLE_COUNT 32, scene.h:18; 1 = the
    # centre tap alone).
    texture_sample_count: int = 32
    # Replicate the reference's plane-shadow frame bug (opt-in).
    parity_plane_shadow_bug: bool = False
    # Camera lanes per chunk.
    chunk_rays: int = 16384
    # Two-stage TIR chain: tir_head_trips full-width trips, then stragglers
    # recompacted to 1/tir_tail_divisor width (overflow counted in drop_tir).
    tir_tail_compaction: bool = True
    tir_head_trips: int = 1
    tir_tail_divisor: int = 8
    # Re-render chunks that dropped lanes with escalating capacities.
    adaptive_full_capacity: bool = True
    # Refraction-child and GI-child compaction capacities (fractions of a
    # level's width; overflow counted in drop_refr / drop_gi).
    refr_capacity: float = 0.25
    gi_capacity: float = 1.0
    # Caustic photon map (bhraytracer_tpu/config.py:55-67): photons to
    # store (MAX_CausticPhotonCount, Main.cpp:53), the gather's k-NN cap
    # and radius (MtlBlinn.cpp:28-29), the bounce's Russian-roulette absorb
    # chance (MtlBlinn.cpp:27), and the switch (USE_PhotonMap, Main.cpp:51).
    photon_count: int = 1 << 20
    photon_gather_max: int = 1000
    photon_gather_radius: float = 0.5
    photon_absorb_chance: float = 0.3
    use_photon_map: bool = False
    # Reverse-mode gradients (bhraytracer_tpu/config.py:75): the shade step
    # runs unfused and mesh hits resolve through rows_from_pools, so that
    # torch.autograd reaches materials, lights, camera, vertices and
    # texture tables (models/pathtracer.py:_render_chunk).
    differentiable: bool = False

    # The learned denoiser after the render (models/denoiser.py, in place
    # of the reference's OIDN, Main.cpp:57-95).
    use_denoiser: bool = False
    # Thin-lens depth of field over the camera's `dof` aperture
    # (ops/camera.py; the reference's integrator renders pinhole).
    use_dof: bool = False
    # Adaptive sampling (bhraytracer_tpu/config.py:179-187): after the base
    # pass, the `adaptive_fraction` highest-contrast pixels take
    # `adaptive_spp` extra samples; the image divides by each pixel's count.
    adaptive_spp: int = 0
    adaptive_fraction: float = 0.15

    @property
    def max_levels(self) -> int:
        """Total shade-tree depth (levels 0..max_levels-1 are shaded)."""
        return self.gi_bounces + 1 + self.extra_refr_levels

    def refr_cap(self, n: int) -> int:
        """Refraction-child slot count for a level of n tasks."""
        k = int(np.ceil(n * self.refr_capacity))
        return min(n, max(128, (k + 127) // 128 * 128))

    def gi_cap(self, n: int) -> int:
        """GI-child slot count for a level of n tasks."""
        if self.gi_capacity >= 1.0:
            return n
        k = int(np.ceil(n * self.gi_capacity))
        return min(n, max(128, (k + 127) // 128 * 128))

    def gi_active(self, level: int) -> bool:
        """GI runs while the remaining budget gi_bounces - level >= 0."""
        return self.gi_bounces - level >= 0

"""Inverse rendering and data parallelism over torch.distributed ranks
(sharding.py), and the start-up of a multi-process run (multihost.py)."""

from bhraytracer_tpu_torch.parallel.multihost import init_multihost, shutdown
from bhraytracer_tpu_torch.parallel.sharding import (
    make_mesh,
    render_image_distributed,
    render_radiance_sharded,
    train_step_sharded,
)

__all__ = ["make_mesh", "render_radiance_sharded", "train_step_sharded",
           "render_image_distributed", "init_multihost", "shutdown"]

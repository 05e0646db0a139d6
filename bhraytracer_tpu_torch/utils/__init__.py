from bhraytracer_tpu_torch.utils.png import read_png, write_png
from bhraytracer_tpu_torch.utils.ppm import read_ppm

__all__ = ["read_png", "write_png", "read_ppm"]

"""bhraytracer_tpu_torch: the PyTorch + CUDA port of bhraytracer_tpu.

The forward render of the wavefront path tracer on one NVIDIA H100: the
scene layer (numpy, with a g++ host helper), the integrator in PyTorch,
and hand-written CUDA kernels for the traces, the fused shade setup and
the photon sweeps (csrc/). Every kernel has a plain PyTorch twin that runs
on the CPU. Scenes come from the reference's XML dialect (`load_scene`) or
from SceneDesc values (`compile_scene`). Renders take adaptive sampling,
depth of field, checkpoints and the learned denoiser
(`models/denoiser.py`); `python -m bhraytracer_tpu_torch` is the command
line (`cli.py`). This package imports torch and never jax; bhraytracer_tpu,
the JAX package beside it, is the reference it is tested against.
"""

from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.models.denoiser import denoise, load_pretrained
from bhraytracer_tpu_torch.models.pathtracer import (
    image_to_u8,
    render_image,
    zbuffer_to_u8,
)
from bhraytracer_tpu_torch.scene.compile import compile_scene
from bhraytracer_tpu_torch.scene.pack import ScenePack, pack_from_numpy
from bhraytracer_tpu_torch.scene.xml_loader import load_scene

__all__ = ["RenderConfig", "render_image", "image_to_u8", "zbuffer_to_u8",
           "denoise", "load_pretrained", "compile_scene", "load_scene",
           "ScenePack", "pack_from_numpy"]

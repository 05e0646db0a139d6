"""The port imports torch and never jax."""

import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bhraytracer_tpu_torch")


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import bhraytracer_tpu_torch, bhraytracer_tpu_torch.scenes\n"
            "import bhraytracer_tpu_torch.ops.kernels\n"
            "import bhraytracer_tpu_torch.cli, bhraytracer_tpu_torch.io.photon_dat\n"
            "import bhraytracer_tpu_torch.models.denoiser\n"
            "import bhraytracer_tpu_torch.utils.checkpoint\n"
            "import bhraytracer_tpu_torch.utils.liveview\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'bhraytracer_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_no_jax_import_in_sources():
    pattern = re.compile(r"^\s*(import jax|from jax|import bhraytracer_tpu\b"
                         r"|from bhraytracer_tpu[ .])", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.join(root, f))
    assert not offenders, offenders


def test_parallel_leaves_jax_out():
    """The data-parallel modules import torch.distributed, not jax, and
    export what the JAX package's parallel/ does, with
    render_image_distributed and init_multihost."""
    code = ("import sys\n"
            "import bhraytracer_tpu_torch.parallel as P\n"
            "import bhraytracer_tpu_torch.parallel.multihost\n"
            "assert {'make_mesh', 'render_radiance_sharded', "
            "'train_step_sharded', 'render_image_distributed', "
            "'init_multihost'} <= set(P.__all__)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'bhraytracer_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)

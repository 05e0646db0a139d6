from bhraytracer_tpu_torch.native.build import get_lib, have_native

__all__ = ["get_lib", "have_native"]

"""The port's multi-process start-up (parallel/multihost.py), in the
pytest process, on the CPU: the single-process no-op and an explicit
one-process group (tests/test_multihost.py:16-41), the env:// rendezvous
of a launcher's variables, and the refusals (the CPU only when asked for,
NCCL only on a card)."""

import socket

import pytest
import torch
import torch.distributed as dist

from bhraytracer_tpu_torch.parallel import init_multihost, make_mesh, shutdown
from bhraytracer_tpu_torch.parallel.multihost import LAUNCHER_VARS, backend_for


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_launcher(monkeypatch):
    for var in LAUNCHER_VARS + ("MASTER_PORT",):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    shutdown()


def test_init_multihost_noop_single_process(no_launcher):
    """No coordinator and no launcher variables: False, and no group."""
    assert init_multihost() is False
    assert init_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_init_multihost_explicit_single_coordinator(no_launcher):
    """An explicit one-process group on the CPU: True, gloo, a world of
    one; shutdown() tears it down."""
    got = init_multihost(coordinator_address=f"127.0.0.1:{_free_port()}",
                         num_processes=1, process_id=0, device="cpu")
    assert got is True and dist.is_initialized()
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    assert dist.get_backend() == "gloo"
    mesh = make_mesh(device="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("dp",)
    x = torch.ones(3)
    dist.all_reduce(x, group=mesh.get_group("dp"))
    assert torch.equal(x, torch.ones(3))
    shutdown()
    assert not dist.is_initialized()


def test_init_multihost_launcher_variables(no_launcher):
    """torchrun's variables make the run multi-process: the group meets at
    the env:// rendezvous."""
    for var, val in (("MASTER_ADDR", "127.0.0.1"),
                     ("MASTER_PORT", str(_free_port())), ("WORLD_SIZE", "1"),
                     ("RANK", "0"), ("LOCAL_RANK", "0")):
        no_launcher.setenv(var, val)
    assert init_multihost(device="cpu") is True
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"


def test_init_multihost_needs_a_card_unless_asked(no_launcher):
    """Without a card the default device raises, and no group is left
    behind: the CPU only where device="cpu" asks for it."""
    no_launcher.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_multihost(coordinator_address=f"127.0.0.1:{_free_port()}",
                       num_processes=1, process_id=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    assert not dist.is_initialized()


def test_backend_follows_the_device():
    """NCCL on a card, gloo on the CPU; gloo on a card when asked (ranks
    sharing one card); NCCL on the CPU raises rather than falling back."""
    assert backend_for(torch.device("cuda", 0)) == "nccl"
    assert backend_for(torch.device("cpu")) == "gloo"
    assert backend_for(torch.device("cuda", 0), "gloo") == "gloo"
    with pytest.raises(ValueError):
        backend_for(torch.device("cpu"), "nccl")

"""Several processes (mcpt_tpu_torch/parallel/distributed.py) on the CPU:
two worker processes join one torch.distributed job over gloo on a free
localhost port, each with a mesh of two CPU devices (a global mesh of
four shards), and render the film through render_film_multihost and one
make_train_step.

* The gathered film is bit-equal to one render_pixels call over every
  pixel in this process.
* Each worker's all-reduced loss and gradients equal this process's
  one-device step within float reassociation (rtol 1e-5 on the loss,
  rtol 1e-4, atol 1e-7 on the gradients).
* init_distributed with no MCPT_COORDINATOR / MCPT_NUM_PROCS /
  MCPT_PROC_ID is a no-op.

The worker is this file run as a script; it imports only the port.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, SPP, DEPTH = 16, 2, 3
FAMILIES = ("textures", "bsdf")


def _config():
    from mcpt_tpu_torch.scene.builtin import cornell_box

    return cornell_box(res=RES, spp=SPP, depth_max=DEPTH)


def _target(n):
    r = np.random.default_rng(4)
    return torch.as_tensor(r.uniform(0.0, 0.5, size=(n, 3)).astype(np.float32))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(port, rank, world, out):
    """One process of the job: the film and one train step on a mesh of
    two CPU devices, written to `out` as .npz."""
    import torch.distributed as dist

    from mcpt_tpu_torch.parallel.distributed import (init_distributed,
                                                     render_film_multihost)
    from mcpt_tpu_torch.parallel.shard import make_mesh, make_train_step
    from mcpt_tpu_torch.render.renderer import Renderer

    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    r = Renderer(_config(), device="cpu")
    mesh = make_mesh(["cpu", "cpu"])
    film = render_film_multihost(r.scene, r.camera, r.integrator, SPP,
                                 mesh=mesh)
    n = RES * RES
    loss, grads = make_train_step(r.integrator, SPP, mesh, FAMILIES)(
        r.scene, r.camera, torch.arange(n), _target(n))
    np.savez(out, film=film, loss=loss.numpy(),
             **{k: v.numpy() for k, v in grads.items()})
    dist.destroy_process_group()


def test_two_processes_film_and_step_match_one_process(tmp_path):
    from mcpt_tpu_torch.parallel.shard import make_mesh, make_train_step
    from mcpt_tpu_torch.render.renderer import Renderer, render_pixels

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    outs = [str(tmp_path / f"rank{k}.npz") for k in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(k), "2",
         outs[k]], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for k in range(2)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    r = Renderer(_config(), device="cpu")
    n = RES * RES
    one = render_pixels(r.scene, r.camera, r.integrator, torch.arange(n),
                        SPP).numpy()
    loss, grads = make_train_step(r.integrator, SPP, make_mesh(["cpu"]),
                                  FAMILIES)(r.scene, r.camera,
                                            torch.arange(n), _target(n))
    assert one.mean() > 0.01 and float(grads["tex.color0"].abs().max()) > 0
    for out in outs:
        got = np.load(out)
        np.testing.assert_array_equal(got["film"], one)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(got[k], g.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=k)


def test_init_distributed_without_variables_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from mcpt_tpu_torch.parallel.distributed import (init_distributed,
                                                     mesh_slot)

    for var in ("MCPT_COORDINATOR", "MCPT_NUM_PROCS", "MCPT_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is None
    assert not dist.is_initialized()
    assert mesh_slot(("cpu",) * 3) == (0, 3)
    monkeypatch.setenv("MCPT_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="MCPT_COORDINATOR"):
        init_distributed()
    assert not dist.is_initialized()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

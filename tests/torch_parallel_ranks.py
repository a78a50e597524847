"""Rank functions for tests/test_torch_parallel.py, in a module of their
own so that the spawned ranks import torch and the port only (the test
module imports jax)."""
import os

import numpy as np
import torch
import torch.distributed as dist

# the 32×16 image and the camera of the mesh checks
MESH_H, MESH_W, MESH_HALO = 32, 16, 2
CAMERA = dict(pos=(32.0, 18.0, 8.0), yaw=1.1, pitch=-0.35, aspect=0.5)


def mesh_image():
    return np.arange(MESH_H * MESH_W, dtype=np.float32).reshape(MESH_H,
                                                                MESH_W)


def mesh_noise():
    return np.random.default_rng(7).uniform(
        size=(MESH_H, MESH_W)).astype(np.float32)


def camera_rows(y0, rows, cam):
    """The camera's ray directions for rows y0 .. y0 + rows - 1,
    (rows, W, 3)."""
    from rtvb_tpu_torch.core.camera import camera_rays
    _, d = camera_rays(cam, MESH_W, MESH_H, y0=y0, rows=rows)
    return torch.stack(d, dim=-1)


def mesh_rank(rank: int, n: int, out_dir: str):
    """One rank of the mesh checks: halo_exchange_rows, global_mean and
    sharded_render on its band, saved to out_dir/mesh{rank}.pt."""
    from rtvb_tpu_torch.core.camera import make_camera
    from rtvb_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    group = mesh.init_group("gloo", n, rank, os.path.join(out_dir, "store"))
    try:
        rows = MESH_H // n
        band = slice(rank * rows, (rank + 1) * rows)
        img = torch.from_numpy(mesh_image())[band]
        noise = torch.from_numpy(mesh_noise())[band]
        cam = make_camera(**CAMERA)
        out = dict(
            halo=mesh.halo_exchange_rows(img, MESH_HALO, group),
            mean=mesh.global_mean(noise, group),
            render=mesh.sharded_render(camera_rows, MESH_H, MESH_W, (cam,),
                                       group))
        torch.save(out, os.path.join(out_dir, f"mesh{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sleep_rank(rank: int, seconds: float):
    """A rank that outlives the deadline it is given."""
    import time
    time.sleep(seconds)

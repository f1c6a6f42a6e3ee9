"""Multi-device dry run: the sharded transcode step and the stage ring
over an n-shard mesh.

Port of __graft_entry__.dryrun_multichip. The JAX version forces n
virtual CPU devices and runs make_sharded_step and the ring pipeline of
the MPEG-4 stages over them; this one builds the mesh from distinct
devices (or the caller's explicit list: ["cpu"] * n in the tests,
["cuda:0"] * n on a one-card machine) and holds both to their
single-device forms exactly.

    python -m librempeg_tpu_torch.parallel.dryrun N [DEVICE ...]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from librempeg_tpu_torch.parallel.halo import halfpel_plane
from librempeg_tpu_torch.parallel.mesh import make_mesh
from librempeg_tpu_torch.parallel.pipeline import (make_sharded_step,
                                                   mpeg4_stage_fns,
                                                   transcode_step)
from librempeg_tpu_torch.parallel.stagepipe import ring_pipeline


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded step (batch over 'data', the half-pel stencil over
    'spatial') and, with spatial >= 2, the MPEG-4 stage ring on an
    n_devices mesh; raise unless each equals its single-device form.
    Refuses to pass on fewer shards than asked. Returns the mesh's shape
    and the devices its shards took."""
    mesh = make_mesh(n_devices, devices=devices)
    dp, sp = mesh.shape["data"], mesh.shape["spatial"]
    assert mesh.size == dp * sp == n_devices, (
        f"mesh {mesh.shape} != {n_devices} shards")
    if n_devices >= 2:
        assert sp >= 2, "spatial axis must be >= 2 so the halo and ring run"
    dev = mesh.shard().device

    n = max(2, dp)               # batch divisible by the data axis
    h, w = 128 * sp, 128         # rows divisible by spatial (and 16)
    dh, dw = 64 * sp, 64         # output rows too
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.as_tensor(rng.integers(0, 256, shape),
                               dtype=torch.float32, device=dev)

    y, u, v = rand(n, h, w), rand(n, h // 2, w // 2), rand(n, h // 2, w // 2)
    ref = rand(n, dh, dw)
    out = make_sharded_step(mesh, dst_h=dh, dst_w=dw)(y, u, v, ref)
    assert out["y"].shape == (n, dh, dw)
    single = transcode_step(y, u, v, ref, dh, dw, 4.0)
    for k, t in single.items():
        assert torch.equal(out[k], t), f"sharded step: {k} differs"
    hp = halfpel_plane(single["y"].to(torch.int32)).to(torch.uint8)
    assert torch.equal(out["y_halfpel"], hp), "sharded half-pel differs"

    if sp >= 2:
        stages = mpeg4_stage_fns(64, 128, 32, 64, n_stages=sp)
        micro = torch.as_tensor(rng.integers(0, 256, (3, 2, 64, 128)),
                                dtype=torch.float32, device=dev)
        got = ring_pipeline(stages, mesh, axis="spatial")(micro)
        for i in range(micro.shape[0]):
            x = micro[i]
            for f in stages:
                x = f(x)
            assert torch.equal(got[i], x), f"ring: microbatch {i} differs"
    return {"mesh": mesh.shape,
            "devices": [str(s.device) for s in mesh.shards.ravel()]}


if __name__ == "__main__":
    r = dryrun_multichip(int(sys.argv[1]), sys.argv[2:] or None)
    print(f"mesh={r['mesh']} devices={r['devices']} ok")

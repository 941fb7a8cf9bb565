"""A fault planted in a mesh's spawned ranks.  Rank 0 spawns its followers
by a "module:function" name (`distributed.open_inference_group`); `plant`
swaps that name for `zeroed_images_follower`, which breaks the follower's
side of the exchange in its own process and then runs the port's own
follower."""

from __future__ import annotations

ZEROED_IMAGES = "gitbench.tests.mesh_faults:zeroed_images_follower"


def zeroed_images_follower(rank, world_size, init_method, *args):
    """The port's follower, searching blank images of the broadcast batch's
    shape in place of the rows rank 0 sent it."""
    import torch

    from gitax_torch.runtime import engine

    run = engine.CaptionEngine._run

    def _run(self, images, pref, generate):
        return run(self, torch.zeros_like(images), pref, generate)

    engine.CaptionEngine._run = _run
    engine.follower_main(rank, world_size, init_method, *args)


def plant(monkeypatch):
    """Rank 0 (this process) spawns `zeroed_images_follower` in place of the
    port's follower."""
    from gitax_torch.runtime import distributed

    open_group = distributed.open_inference_group

    def open_inference_group(mesh_shape, _follower, *args, **kwargs):
        return open_group(mesh_shape, ZEROED_IMAGES, *args, **kwargs)

    monkeypatch.setattr(distributed, "open_inference_group", open_inference_group)

"""Row sharding of the frame over torch.distributed ranks, the port of
raytracer2_tpu/parallel (mesh.py, halo.py): each rank renders one band of
image rows and holds that band of the frame state, the scene is whole on
every rank, and the stencil passes exchange only their halo rows with the
neighbouring ranks.

    dist.init_process_group("nccl", init_method=..., rank=r, world_size=n)
    mesh = make_mesh("nccl")
    step = make_sharded_render_fn(renderer, mesh)
    state = shard_frame_state(init_frame_state(w, h, device=dev), mesh)
    state, tile = step(g_const, state)
    image = gather_frame(tile, mesh)      # [H, W, 3] on every rank

python -m raytracer2_tpu_torch.parallel.dryrun renders the Cornell box on
two gloo ranks on the CPU and holds the sharded frames to the unsharded
ones.
"""

"""CLI: evaluate a finished run (recon metrics, MAD, trajectory length).

Pipeline parity with scripts/evaluation/eval_replica.sh: cull the
reconstructed mesh with the run's trajectory, compute accuracy/completion/
ratio against the ground-truth mesh, MAD from the checkpoint, trajectory
length, and append everything to eval_result.txt.

    python -m naruto_tpu.evaluate --rec mesh_final.ply --gt gt.ply \
        --ckpt ckpt_final.pkl --dataset Replica --scene office0
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rec", required=True, help="reconstructed mesh (ply)")
    p.add_argument("--gt", required=True, help="ground-truth mesh (ply)")
    p.add_argument("--ckpt", default=None, help="mapper checkpoint (pkl)")
    p.add_argument("--dataset", default="Replica")
    p.add_argument("--scene", default="office0")
    p.add_argument("--out", default=None, help="eval_result.txt path")
    p.add_argument("--cull", action="store_true",
                   help="frustum-cull the rec mesh with ckpt poses first")
    p.add_argument("--align", action="store_true", help="ICP align first")
    p.add_argument("--n_samples", type=int, default=200_000)
    p.add_argument("--platform", default="cpu",
                   help="jax platform for the MAD field queries (default "
                        "cpu: a JAX process reserves most of a card's "
                        "memory when it starts, so an offline eval on the "
                        "card would starve a live run there — one process "
                        "per card)")
    args = p.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from naruto_tpu.config import make_config
    from naruto_tpu.evaluation import (
        cull_mesh, eval_mad, eval_mesh, eval_traj_length,
    )
    from naruto_tpu.mesh.ply import read_ply
    from naruto_tpu.utils.results import update_results_file

    def _load_mesh(path):
        if path.lower().endswith((".glb", ".gltf")):
            from naruto_tpu.mesh.gltf import load_gltf

            return load_gltf(path, quiet=True)
        return read_ply(path)

    cfg = make_config(args.dataset, args.scene)
    rec_v, rec_f, _ = _load_mesh(args.rec)
    gt_v, gt_f, _ = _load_mesh(args.gt)

    results = {}
    mapper = None
    if args.ckpt:
        from naruto_tpu.mapping.mapper import Mapper

        mapper = Mapper(cfg)
        mapper.load_ckpt(args.ckpt)
        poses = np.asarray(mapper.state.poses)
        if mapper.step > 0:           # drop unused trailing identity poses
            poses = poses[:mapper.step + 1]
        results["traj_length_m"] = eval_traj_length(poses)
        if args.cull:
            rec_v, rec_f = cull_mesh(
                rec_v, rec_f, list(poses), cfg.cam.intrinsics,
                (cfg.cam.H, cfg.cam.W), depth_fn=None, subsample=10)

    results.update(eval_mesh(rec_v, rec_f, gt_v, gt_f,
                             n_samples=args.n_samples, align=args.align))
    if mapper is not None:
        results["mad_cm"] = eval_mad(mapper, gt_v, gt_f,
                                     n_samples=args.n_samples)

    print(json.dumps(results))
    if args.out:
        update_results_file(results, args.out)


if __name__ == "__main__":
    main()

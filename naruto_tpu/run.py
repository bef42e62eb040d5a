"""CLI entry point: run active reconstruction.

Surface parity with the reference entry (src/naruto/cfg_loader.py:57-76 /
src/naruto/main.py): `--cfg` YAML experiment file (or `--dataset --scene`
preset), `--seed`, `--result_dir`, `--enable_vis`, `--num_iter`.

    python -m naruto_tpu.run --dataset Replica --scene office0 --seed 0
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NARUTO-TPU active reconstruction")
    p.add_argument("--cfg", type=str, default=None,
                   help="YAML experiment config (with inherit_from support)")
    p.add_argument("--dataset", type=str, default="Replica")
    p.add_argument("--scene", type=str, default="office0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--result_dir", type=str, default=None)
    p.add_argument("--num_iter", type=int, default=None)
    p.add_argument("--enable_vis", type=int, default=0)
    p.add_argument("--sim", type=str, default=None,
                   help="simulator backend override (analytic|replay|raycast)")
    p.add_argument("--scene_path", type=str, default=None,
                   help="scene asset path for replay/raycast backends")
    p.add_argument("--platform", type=str, default=None,
                   help="force jax platform (e.g. cpu) before any compute")
    p.add_argument("--resume", type=str, default=None,
                   help="full-state snapshot to resume from ('auto' = the "
                        "run dir's full_state_latest.pkl; requires "
                        "general.ckpt_freq > 0 to have written one)")
    return p.parse_args(argv)


def build_config(args):
    from naruto_tpu.config import load_config, make_config
    from naruto_tpu.config.schema import deep_update

    if args.cfg:
        cfg = load_config(args.cfg)
    else:
        cfg = make_config(args.dataset, args.scene, seed=args.seed,
                          num_iter=args.num_iter)
    over = {"general": {"seed": args.seed}}
    if args.num_iter is not None:
        over["general"]["num_iter"] = args.num_iter
    if args.result_dir:
        over["general"]["result_dir"] = args.result_dir
    if args.enable_vis:
        # mirrors the reference --enable_vis: artifact saving plus the live
        # rgbd window when a display exists (visualizer.py:67-106)
        over["vis"] = {"enable_all_vis": True, "vis_rgbd": True}
    if args.sim:
        over["sim"] = {"method": args.sim}
    if args.scene_path:
        over.setdefault("sim", {})["scene_path"] = args.scene_path
    return deep_update(cfg, over)


def main(argv=None):
    args = parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    cfg = build_config(args)
    from naruto_tpu.system.engine import Engine

    engine = Engine(cfg)
    resume = args.resume
    if resume == "auto":
        import os

        resume = os.path.join(cfg.general.result_dir, cfg.general.dataset,
                              cfg.general.scene, "full_state_latest.pkl")
        if not os.path.exists(resume):
            print(f"[resume] no snapshot at {resume}; starting fresh")
            resume = None
    engine.run(resume_from=resume)
    engine.finalize()
    return engine


if __name__ == "__main__":
    main()

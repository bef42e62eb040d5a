"""The active-reconstruction engine: the sim -> map -> plan loop.

Orchestration parity with src/naruto/main.py:40-151: construct simulator,
mapper, planner, visualizer; per step — update module steps, resolve the
pose, simulate RGB-D, run one mapping step (which returns fresh
uncertainty/SDF volumes on mapping steps), then let the planner emit the
next pose; at the end save the final mesh + checkpoint and print the timing
breakdown. The strict simulate->map->plan dependency per step is preserved
(SURVEY.md §5.2) — the planner consumes the volumes produced that step.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from naruto_tpu.config.schema import MainConfig
from naruto_tpu.mapping.mapper import Mapper
from naruto_tpu.planner import init_planner
from naruto_tpu.sim import init_simulator
from naruto_tpu.system.pose_loader import PoseLoader
from naruto_tpu.utils.printer import InfoPrinter
from naruto_tpu.utils.seeding import fix_random_seed
from naruto_tpu.utils.timer import Timer


class Engine:
    def __init__(self, cfg: MainConfig, quiet: bool = False):
        from naruto_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        self.cfg = cfg
        self.printer = InfoPrinter(
            "NARUTO-TPU", cfg.general.num_iter,
            f"{cfg.general.dataset} - {cfg.general.scene}", quiet=quiet)
        self.timer = Timer()

        fix_random_seed(cfg.general.seed)
        # the simulator must render exactly the mapper's sensor size —
        # cam.{H,W} and sim.pinhole_hw are separate config sections (the
        # reference splits them the same way: coslam.yaml cam vs habitat.py
        # sensors) and a silent mismatch only surfaces as a shape error
        # deep inside frame_to_rays
        ph = tuple(cfg.sim.pinhole_hw)
        cam_hw = (cfg.cam.H // cfg.cam.downsample,
                  cfg.cam.W // cfg.cam.downsample)
        if ph != cam_hw:
            raise ValueError(
                f"sim.pinhole_hw {ph} != cam (H/downsample, W/downsample) "
                f"{cam_hw}; set both config sections to the same sensor "
                f"size")
        self.sim = init_simulator(cfg, self.printer)
        self.mapper = Mapper(cfg, self.printer, timer=self.timer)
        self.planner = init_planner(cfg, self.printer)
        self.planner.update_sim(self.sim)
        self.planner.init_data(cfg.mapper.bound_np)
        self.planner.init_local_planner()
        self.pose_loader = PoseLoader(cfg)

        run_dir = os.path.join(cfg.general.result_dir, cfg.general.dataset,
                               cfg.general.scene)
        self.mapper.result_dir = run_dir

        # config provenance: dump the merged config next to the artifacts
        # (ref dumps the merged Co-SLAM dict to coslam/config.json,
        #  coslam.py:47-52)
        try:
            import json

            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=1, default=str)
        except OSError:
            pass

        self.visualizer = None
        if cfg.vis.enable_all_vis:
            from naruto_tpu.visualization.saver import ArtifactSaver
            self.visualizer = ArtifactSaver(cfg, self.printer)

        self.uncert_sdf = None

    def _init_pose(self) -> np.ndarray:
        c2w = self.pose_loader.load_init_pose()
        if self.cfg.enable_active_planning and self.pose_loader.traj is None \
                and self.cfg.start_c2w is None:
            # no per-scene start configured: asset-free runs start at the
            # room center (always free space in the analytic scenes). With a
            # configured start_c2w the pose loader's value is used verbatim
            # (ref configs/<ds>/<scene>/NARUTO.py start_c2w).
            bound = self.cfg.mapper.bound_np
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 3] = bound.mean(axis=1)
        return c2w

    def run(self, num_iter: Optional[int] = None,
            resume_from: Optional[str] = None) -> np.ndarray:
        """resume_from: path of a `save_full_state` snapshot (the periodic
        `full_state_latest.pkl` the ckpt_freq block writes). Restores the
        mapper pytree + rng key, the planner's FSM position and mitigation
        counters, and the current pose, then continues at the saved
        step + 1. The RRT's numpy rng is not restored, so tree sampling
        after the resume point diverges from an uninterrupted run (the
        mapper's BA ray draws do not — its key rides the checkpoint)."""
        cfg = self.cfg
        n = num_iter if num_iter is not None else cfg.general.num_iter
        c2w = self._init_pose()
        start = 0
        if resume_from:
            extra = self.mapper.load_full_state(resume_from)
            start = self.mapper.step + 1
            if extra.get("c2w") is not None:
                c2w = np.asarray(extra["c2w"], np.float32)
            if extra.get("planner") and hasattr(self.planner,
                                                "restore_state"):
                self.planner.restore_state(extra["planner"])
            if cfg.enable_active_planning:
                # the restored FSM may be mid-plan (movingToGoal etc.),
                # whose collision probes read uncert/sdf volumes before the
                # mapper's next volume dispatch — recompute them from the
                # restored field (volumes are a pure function of params)
                self.uncert_sdf = self.mapper.get_map_volumes_lazy()
            self.printer(f"Resumed from {resume_from} at step {start}",
                         start, "Engine")

        # passive mode: frame i+1's pose is known -> double-buffered
        # host->device streaming (BASELINE north star; impossible in active
        # mode where the pose depends on this step's planner output)
        # the raw frame has a consumer outside the mapper only when a
        # visualizer saves/shows rgbd; everything else (poses, paths,
        # meshes, state) is frame-independent
        vis_needs_rgbd = (self.visualizer is not None
                          and (cfg.vis.save_rgbd or cfg.vis.vis_rgbd))
        prefetcher = None
        if (not cfg.enable_active_planning and self.pose_loader.traj
                and start == 0):
            from naruto_tpu.sim.prefetch import FramePrefetcher

            prefetcher = FramePrefetcher(
                self.sim, lambda s: self.pose_loader.traj[s],
                needs_fn=(None if vis_needs_rgbd
                          else self.mapper.needs_frame),
                horizon=min(n, len(self.pose_loader.traj)))

        for i in range(start, n):
            # with a prefetcher the worker thread owns sim stepping (it
            # calls update_step ahead of the engine; stepping here too
            # would race the analytic sim's phase)
            mods = ((self.mapper, self.planner) if prefetcher is not None
                    else (self.sim, self.mapper, self.planner))
            for mod in mods:
                mod.update_step(i)
            if self.visualizer is not None:
                self.visualizer.update_step(i)

            c2w = self.pose_loader.update_pose(c2w, i)

            if prefetcher is not None:
                with self.timer.time("Simulation", "General"):
                    color, depth = prefetcher.get(i)
            elif vis_needs_rgbd or self.mapper.needs_frame(i):
                with self.timer.time("Simulation", "General"):
                    color, depth = self.sim.simulate(c2w)[:2]
            else:
                # frame is consumed by nothing (no mapping, no keyframe,
                # no tracking, no rgbd artifact): skip the render entirely
                # — simulate() is pure (object physics advances in
                # update_step above), so this changes no state. Untimed so
                # the Simulation median/mean reflect real renders only.
                color, depth = None, None

            with self.timer.time("SLAM", "General"):
                new_vols = self.mapper.online_recon_step(
                    i, color, depth, c2w)

            if self.visualizer is not None:
                self.visualizer.main(self.mapper, self.planner, color,
                                     depth, c2w)

            if cfg.enable_active_planning:
                with self.timer.time("Planning", "General"):
                    if new_vols is not None:
                        self.uncert_sdf = new_vols
                    c2w = self.planner.main(
                        self.uncert_sdf, np.asarray(c2w), new_vols is not None)

            if cfg.general.ckpt_freq and i > 0 and i % cfg.general.ckpt_freq == 0:
                extra = {"c2w": np.asarray(c2w, np.float32).tolist()}
                if hasattr(self.planner, "export_state"):
                    extra["planner"] = self.planner.export_state()
                self.mapper.save_full_state(os.path.join(
                    cfg.general.result_dir, cfg.general.dataset,
                    cfg.general.scene, "full_state_latest.pkl"),
                    extra=extra)
            if (i + 1) % 250 == 0:
                # mid-run wall-clock decomposition: long glb/MP3D runs are
                # host-bound in ways that differ per scene; the final
                # report alone can't tell probes from RRT from renders
                print(f"[Engine] step {i + 1} timers:\n"
                      f"{self.timer.summary()}", flush=True)
                stats_fn = getattr(self.planner, "stats_summary", None)
                if cfg.enable_active_planning and stats_fn:
                    print(f"[Engine] planner: {stats_fn()}", flush=True)
        if prefetcher is not None:
            prefetcher.close()
        return np.asarray(c2w)

    def finalize(self, result_dir: Optional[str] = None) -> None:
        cfg = self.cfg
        out = result_dir or os.path.join(
            cfg.general.result_dir, cfg.general.dataset, cfg.general.scene)
        os.makedirs(out, exist_ok=True)
        from naruto_tpu.mesh.extract import save_mesh

        save_mesh(self.mapper, os.path.join(
            out, f"mesh_{cfg.general.num_iter:04d}_final.ply"),
            voxel_size=cfg.mesh.voxel_final)
        self.mapper.save_ckpt(os.path.join(
            out, f"ckpt_{cfg.general.num_iter:04d}_final.pkl"))

        # trajectory length into the run's results file (ref
        # eval_traj_length + update_results_file contract)
        from naruto_tpu.evaluation import eval_traj_length
        from naruto_tpu.utils.results import update_results_file

        n = min(cfg.general.num_iter, self.mapper.state.poses.shape[0])
        traj_len = eval_traj_length(np.asarray(self.mapper.state.poses[:n]))
        update_results_file({"traj_length_m": traj_len},
                            os.path.join(out, "eval_result.txt"))

        # exploration diagnostics (weak-seed analysis, VERDICT r3 #6)
        if hasattr(self.planner, "stats_summary"):
            import json as _json

            with open(os.path.join(out, "planner_stats.json"), "w") as f:
                _json.dump({"summary": self.planner.stats_summary(),
                            "events": self.planner.stats["events"]}, f,
                           indent=1)

        # asset-free runs: export the analytic scene's exact GT mesh so the
        # recon metrics can be computed without external data
        gt_path = None
        if hasattr(self.sim, "gt_occupancy_volume"):
            from naruto_tpu.mesh.marching import marching_cubes
            from naruto_tpu.mesh.ply import write_ply

            vs = cfg.mesh.voxel_eval
            gt_sdf = self.sim.gt_occupancy_volume(vs)
            v_vox, f = marching_cubes(gt_sdf, truncation=1e9)
            bound = cfg.mapper.bound_np
            gt_path = os.path.join(out, "gt_mesh.ply")
            write_ply(gt_path, v_vox * vs + bound[:, 0], f)
        elif cfg.sim.scene_path.lower().endswith((".ply", ".glb", ".gltf")) \
                and os.path.exists(cfg.sim.scene_path):
            gt_path = cfg.sim.scene_path
        else:
            for name in ("mesh.ply", "mesh.glb"):
                cand = os.path.join(cfg.sim.scene_path, name)
                if os.path.isfile(cand):
                    # raycast scene dir (+ optional traj.txt for replays)
                    gt_path = cand
                    break

        # full metric row — acc/comp/ratio/MAD merged next to traj_length
        # (ref eval_replica.sh pipeline + update_results_file,
        #  src/utils/general_utils.py:163-188)
        if cfg.general.final_eval and gt_path is not None:
            try:
                from naruto_tpu.evaluation import eval_mad, eval_mesh
                from naruto_tpu.mesh.ply import read_ply

                rec_v, rec_f, _ = read_ply(os.path.join(
                    out, f"mesh_{cfg.general.num_iter:04d}_final.ply"))
                if gt_path.lower().endswith((".glb", ".gltf")):
                    from naruto_tpu.mesh.gltf import load_gltf

                    gt_v, gt_f, _ = load_gltf(gt_path, quiet=True)
                else:
                    gt_v, gt_f, _ = read_ply(gt_path)
                row = eval_mesh(rec_v, rec_f, gt_v, gt_f)
                row["mad_cm"] = eval_mad(self.mapper, gt_v, gt_f)
                update_results_file(row, os.path.join(out, "eval_result.txt"))
                self.printer(
                    "Eval: " + " ".join(f"{k}={v:.3f}" for k, v in row.items()),
                    cfg.general.num_iter, "Eval")
            except Exception as e:  # noqa: BLE001 — eval is best-effort
                self.printer(f"final eval failed: {e}",
                             cfg.general.num_iter, "Eval")
        self.timer.time_analysis()

"""Online SLAM with loop closing: ``se2lam_tpu_torch.system.SlamSystem``
fed frame by frame through ``process(img, odo)``.

Set-up renders the route's lap, runs a throwaway system over the first
frames and through its closure branch (pose graph and joint GBA at the
window's capacities), then builds the window's fresh system. After the
window the run is judged by the extraction of a sample of its frames
against the plain extractor, a sample of K3's reductions against float64,
a sample of its local BAs and its first pose graph and joint GBA against
float64 re-solves of the problems the program built, whether it closed a
loop, and the live trajectory against the ground truth.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bench import log
from ..reference.geometry import ate_se2, schur_error, schur_reduction
from ..reference.solve import ba_cost, pose_graph_cost, shortfall, solve_ba, solve_pose_graph
from ..world import map_gauge
from .common import Session, extraction_diff

__all__ = ["SlamSession"]


class SlamSession(Session):
    # K3 launches of the window whose inputs the check keeps, drawn from
    # the first this many (local BA makes 10 a keyframe)
    K3_DRAW_FROM, K3_SAMPLES = 300, 6
    # local BAs (one a keyframe) whose problems the check keeps
    BA_DRAW_FROM, BA_SAMPLES = 40, 3

    def build(self):
        from se2lam_tpu_torch import loopclose
        from se2lam_tpu_torch.system import SlamSystem

        self._SlamSystem = SlamSystem
        # a throwaway system over the first frames; a loop candidate 2
        # keyframes back admits the closure branch within them
        warm = self._new(self.cfg.replace(gm_dcl_min_kfid_offset=2), salt=7)
        for i in range(self.traffic.warm_frames):
            warm.process(self.image(i), self.seq.odo[i])
        ms, _ = loopclose.run_global_ba(warm.ms, iters=self.cfg.global_iter,
                                        huber=self.cfg.gm_pg_huber)
        loopclose.run_global_ba_joint(ms, self.cfg, iters=self.cfg.gm_joint_ba_iters)
        self.warm_loops = warm._loop_closer.n_loops_closed
        del warm, ms

    def _new(self, cfg, salt):
        slam = self._SlamSystem(cfg, device=self.device,
                                generator=self.torch_generator(salt))
        if slam._loop_closer is not None:
            slam._loop_closer.generator = self.torch_generator(salt + 1)
        return slam

    def start(self):
        self.system = self._new(self.cfg, salt=1)
        self.loops_closed = 0

    def holds(self, n_frames):
        drawn = {0} | set(self.rng(11).choice(self.K3_DRAW_FROM, self.K3_SAMPLES,
                                              replace=False).tolist())
        joint = []

        def keep(i, args):
            """The drawn launches, and the first at the joint GBA's shape."""
            if args[0].shape[0] == self.cfg.cap.max_kfs and not joint:
                joint.append(i)
                return True
            return i in drawn

        ba = {0} | set(self.rng(13).choice(self.BA_DRAW_FROM, self.BA_SAMPLES,
                                           replace=False).tolist())
        return {"k3": ("se2lam_tpu_torch.solver.schur:point_reduction", keep),
                "local_ba": ("se2lam_tpu_torch.localmap:solve_local_ba", ba),
                "pose_graph": ("se2lam_tpu_torch.loopclose:solve_pose_graph", {0}),
                "joint_ba": ("se2lam_tpu_torch.loopclose:solve_local_ba", {0})}

    def process(self, i):
        return self.system.process(self.image(i), self.seq.odo[i])

    def counts(self):
        s = self.system
        lc = s._loop_closer
        self.loops_closed = lc.n_loops_closed
        return dict(keyframes=len(s.kf_frame_ids), local_bas=s.n_local_ba,
                    loops_closed=lc.n_loops_closed, renewal_gbas=lc.n_renewal_gbas,
                    vocab_trainings=lc.n_vocab_trainings, host_reads=s.host_reads,
                    map_points=s.n_map_points(), warm_loops=self.warm_loops)

    def unchanged(self, n_done):
        """``ate_m`` of a system whose pose never leaves the first frame's."""
        gt = map_gauge(self.seq.gt[:n_done], self.seq.gt[0])
        return dict(ate_m=ate_se2(np.zeros_like(gt), gt))

    def _ba_shortfall(self, hold, iters, tf32):
        """The largest shortfall (``reference.solve.shortfall``) of the held
        BA solves from a float64 re-solve of the same problem, at the
        configuration's iterations and Huber threshold."""
        sc = self.doc["system"]
        K, Tcb, huber = (sc["fx"], sc["fy"], sc["cx"], sc["cy"]), self.tcb(), sc["th_huber2"] ** 0.5
        worst = []
        for i, args, _kw, out in hold.kept:
            prob, cfg = args[0], args[3]
            want = solve_ba(prob, K, Tcb, iters, huber, cfg.lm_init_lambda, cfg.eps)
            got = (solve_ba(prob, K, Tcb, iters, huber, cfg.lm_init_lambda, cfg.eps,
                            dtype=torch.float32, tf32=True) if tf32 else out[:2])
            cost = [ba_cost(prob, K, Tcb, p, x, huber)
                    for p, x in ((prob.poses, prob.points), got, want)]
            worst.append(shortfall(*cost))
            log(f"BA call {i} (K, M) = {(prob.poses.shape[0], prob.points.shape[0])}: "
                f"costs {cost}, shortfall {worst[-1]!r}")
        return max(worst) if worst else float("inf")

    def _pg_shortfall(self, hold, tf32):
        """The same for the held pose-graph solves."""
        sc = self.doc["system"]
        worst = []
        for i, args, kw, out in hold.kept:
            prob, huber = args[0], sc["gm_pg_huber"]
            lam0 = kw.get("lm_init_lambda", 1e-6)
            want = solve_pose_graph(prob, sc["global_iter"], huber, lam0)
            got = (solve_pose_graph(prob, sc["global_iter"], huber, lam0, dtype=torch.float32,
                                    tf32=True) if tf32 else out[0])
            cost = [pose_graph_cost(prob, p, huber) for p in (prob.poses, got, want)]
            worst.append(shortfall(*cost))
            log(f"pose graph call {i}: costs {cost}, shortfall {worst[-1]!r}")
        return max(worst) if worst else float("inf")

    def readings(self, n_done, poses, held, extracted, tf32=False):
        """The numbers compared: ``extract_diff``, ``k3_err``,
        ``local_ba_shortfall``, ``pose_graph_shortfall``,
        ``joint_ba_shortfall``, ``closures_missing``, ``ate_m``. ``tf32``:
        the control, the references in the precision below."""
        sc = self.doc["system"]
        gt = map_gauge(self.seq.gt[:n_done], self.seq.gt[0])
        est = np.asarray([p if p is not None else [np.nan] * 3 for p in poses[:n_done]])
        ok = np.isfinite(est).all(1)
        ate = ate_se2(est[ok, :2], gt[ok]) if ok.sum() >= 2 else float("inf")
        k3 = []
        for i, args, _kw, S in held["k3"].kept:
            Hpx, Hxx_inv = args
            if tf32:
                S = schur_reduction(Hpx, Hxx_inv, dtype=torch.float32, tf32=True)
            k3.append(schur_error(S, Hpx, Hxx_inv))
            log(f"k3 launch {i} (K, M) = {tuple(Hpx.shape[::2])}: {k3[-1]!r}")
        return dict(
            extract_diff=extraction_diff(self, extracted, tf32),
            k3_err=max(k3) if k3 else float("inf"),
            local_ba_shortfall=self._ba_shortfall(held["local_ba"], sc["local_iter"], tf32),
            pose_graph_shortfall=self._pg_shortfall(held["pose_graph"], tf32),
            joint_ba_shortfall=self._ba_shortfall(held["joint_ba"], sc["gm_joint_ba_iters"], tf32),
            closures_missing=float(self.loops_closed < 1), ate_m=ate)

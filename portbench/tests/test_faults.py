"""A run with its timed path broken underneath reads ``correct`` false:
one run per fault the cells can have (a step that returns its state
unchanged: tracking, local BA, the pose graph, the joint GBA, the
localizer's step; loop closing off; a solve's result dropped; an answer
altered where it is produced), at a small size on the CPU, through the
whole harness but its look for a card. One chip, no batch: the faults of
a missing exchange or half a batch do not arise."""
import pytest
import torch

from portbench.bench import run_cell
from portbench.tests.small import small

SEED = 2**31 + 99


# frames of the laps cell after which the small size has closed a loop
# (the lap is 72 frames)
LOOP_FRAMES = 100


def run(cell, frames):
    return run_cell(cell, SEED, 1000.0, False, device="cpu", config_override=small,
                    max_frames=frames)


def failed(result, name):
    c = result["checks"][name]
    return c["value"] is None or c["value"] > c["limit"]


def _frozen_track(orig):
    def track_frame(ts, feats, odom, cfg, **kw):
        _new, res = orig(ts, feats, odom, cfg, **kw)
        return ts, res._replace(pose=ts.cur_pose, need_kf=torch.zeros_like(res.need_kf))
    return track_frame


def _frozen_step(orig):
    def process_features(self, feats, odo):
        if self.pose is None:
            return orig(self, feats, odo)
        return self.pose.copy()
    return process_features


def _flip_descriptors(orig):
    def forward(self, img):
        f = orig(self, img)
        pm1 = f.desc_pm1.clone()
        pm1[f.valid.nonzero()[:5, 0], 0] *= -1
        return f._replace(desc_pm1=pm1)
    return forward


def _scaled_reduction(orig):
    def point_reduction(Hpx, Hxx_inv):
        return orig(Hpx, Hxx_inv) * (1 + 1e-3)
    return point_reduction


def _shifted_match(orig):
    def windowed_top2(*args):
        best, second, arg, arg2 = orig(*args)
        return best, second, (arg + 1) % args[6].shape[0], arg2
    return windowed_top2


def _moved_pose(orig):
    def solve_pose_only(*args, **kw):
        p, chi, n = orig(*args, **kw)
        return p + torch.tensor([0.02, 0.0, 0.0], dtype=p.dtype), chi, n
    return solve_pose_only


def _unchanged_ba(orig):
    def solve_local_ba(prob, *args, **kw):
        _p, _x, info = orig(prob, *args, **kw)
        return prob.poses, prob.points, info
    return solve_local_ba


def _unchanged_pose_graph(orig):
    def solve_pose_graph(prob, *args, **kw):
        _p, info = orig(prob, *args, **kw)
        return prob.poses, info
    return solve_pose_graph


def _no_loop_detection(orig):
    def __init__(self, cfg, *args, **kw):
        orig(self, cfg, *args, **dict(kw, detect_loops=False))
    return __init__


def _dropped_solve(orig):
    def _localize_step(ms, pose, last_odom, feats, odo, *args):
        from se2lam_tpu_torch.ops import se2
        _new, ok = orig(ms, pose, last_odom, feats, odo, *args)
        return se2.compose(pose, se2.minus(odo, last_odom)), ok
    return _localize_step


FAULTS = [
    ("room640_slam.laps", "se2lam_tpu_torch.tracking", "track_frame", _frozen_track, "ate_m", 14),
    ("room640_slam.laps", "se2lam_tpu_torch.frontend.orb", "OrbExtractor.forward",
     _flip_descriptors, "extract_diff", 8),
    ("room640_slam.laps", "se2lam_tpu_torch.solver.schur", "point_reduction", _scaled_reduction,
     "k3_err", 14),
    ("room640_loc.route", "se2lam_tpu_torch.localizer", "Localizer.process_features",
     _frozen_step, "loc_err_p90_m", 30),
    ("room640_loc.restart", "se2lam_tpu_torch.frontend.windowed_match", "windowed_top2",
     _shifted_match, "k2_rows", 10),
    ("room640_loc.route", "se2lam_tpu_torch.localizer", "solve_pose_only", _moved_pose,
     "pose_gap_m", 10),
    ("room640_loc.route", "se2lam_tpu_torch.localizer", "_localize_step", _dropped_solve,
     "pose_gap_m", 16),
    ("room640_slam.laps", "se2lam_tpu_torch.localmap", "solve_local_ba", _unchanged_ba,
     "local_ba_shortfall", 14),
    ("room640_slam.laps", "se2lam_tpu_torch.loopclose", "solve_pose_graph",
     _unchanged_pose_graph, "pose_graph_shortfall", LOOP_FRAMES),
    ("room640_slam.laps", "se2lam_tpu_torch.loopclose", "solve_local_ba", _unchanged_ba,
     "joint_ba_shortfall", LOOP_FRAMES),
    ("room640_slam.laps", "se2lam_tpu_torch.system", "SlamSystem.__init__", _no_loop_detection,
     "closures_missing", LOOP_FRAMES),
]


@pytest.mark.parametrize("cell,module,attr,fault,number,frames", FAULTS,
                         ids=[f"{f[0]}-{f[4]}" for f in FAULTS])
def test_a_broken_timed_path_reads_incorrect(monkeypatch, cell, module, attr, fault, number,
                                             frames):
    import importlib

    owner = importlib.import_module(module)
    *outer, name = attr.split(".")
    for part in outer:
        owner = getattr(owner, part)
    monkeypatch.setattr(owner, name, fault(owner.__dict__[name]))
    result = run(cell, frames)
    assert failed(result, number), result["checks"]
    assert result["correct"] is False


@pytest.mark.parametrize("cell,frames", [("room640_slam.laps", 14), ("room640_loc.restart", 10)])
def test_a_sound_run_passes_its_exact_numbers(cell, frames):
    result = run(cell, frames)
    exact = [k for k in ("extract_diff", "k2_rows") if k in result["checks"]]
    assert exact and not any(failed(result, k) for k in exact), result["checks"]
    assert result["failed"] == 0 and result["attempted"] == frames


def test_a_sound_run_closes_a_loop_and_matches_its_re_solves():
    """The closure branch runs in the window and each solve held there
    reads within its limit of its float64 re-solve."""
    result = run("room640_slam.laps", LOOP_FRAMES)
    solves = ["local_ba_shortfall", "pose_graph_shortfall", "joint_ba_shortfall",
              "closures_missing"]
    assert not any(failed(result, k) for k in solves), result["checks"]

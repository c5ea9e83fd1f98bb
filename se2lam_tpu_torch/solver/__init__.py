"""Bundle adjustment (port of se2lam_tpu.solver): the SE2-XYZ local BA and
the Schur point reduction, kernel K3; the pose-only, pose-graph and
sparsifier solvers are its modules."""
from .ba import BAConfig, BAProblem, ba_chi2, solve_local_ba  # noqa: F401

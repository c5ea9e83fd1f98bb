"""Multi-device distribution (port of se2lam_tpu.parallel): the map-block
partitioned BA (``dist_ba``), the edge-sharded pose graph
(``dist_posegraph``), keyframe-bank-split loop scoring (``dist_loop``),
the mesh and its collectives (``mesh``), the multi-process runtime
(``runtime``), and fleets of robots on one device or over a mesh
(``fleet``, ``fleet_localize``)."""
from .dist_ba import (  # noqa: F401
    DistBAProblem,
    dist_solve_local_ba,
    partition_points,
    sharded_solve_joint_ba,
    sharded_solve_local_ba,
)
from .dist_posegraph import dist_solve_pose_graph  # noqa: F401
from .dist_loop import (  # noqa: F401
    shard_bank, sharded_bow_detect, sharded_hamming_detect,
)
from .fleet import ShardedFleet, make_fleet_tracker, shard_fleet  # noqa: F401
from .fleet_localize import make_fleet_localizer  # noqa: F401
from .mesh import Mesh, gather, make_mesh  # noqa: F401
from . import runtime  # noqa: F401

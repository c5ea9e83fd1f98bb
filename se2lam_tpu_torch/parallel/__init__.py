"""Fleets of robots on one GPU (port of se2lam_tpu.parallel's ``fleet`` and
``fleet_localize``). The distributed solvers of ``se2lam_tpu.parallel``
(``dist_ba``, ``dist_posegraph``, ``dist_loop``, ``mesh``, ``runtime``) are
not ported yet (``ROADMAP.md`` §1, item 20)."""
from .fleet import make_fleet_tracker, shard_fleet  # noqa: F401
from .fleet_localize import make_fleet_localizer  # noqa: F401

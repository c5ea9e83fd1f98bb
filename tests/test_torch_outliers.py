"""The port's outlier-observation removal (``localmap.remove_outlier_obs``)
against the JAX package's, as ``tests/test_outliers.py`` runs it: on a map
the JAX package builds (11 frames of synthetic geometry, 64 features),
carried across with ``map_state_from_numpy``, clean and with one valid
point moved by (5, 5, 3) m. Tolerance: none. Every table of the result
and ``n_bad`` equal JAX's (the chi2 gate at th_huber2 sees no observation
near it on these maps), and the result passes the JAX package's own
consistency check."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import localmap as jlm
from se2lam_tpu_torch import localmap as tlm
from se2lam_tpu_torch.convert import config_from_fields, map_state_from_numpy
from se2lam_tpu_torch.mapstate import MapState

from synth_utils import make_cfg, make_scene
from test_localmap import drive_frames, motion_poses
from test_prune import check_consistency

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def built():
    cfg = make_cfg()
    pts, bits = make_scene(np.random.default_rng(0))
    poses = motion_poses(11)
    ms, kfs = drive_frames(cfg, poses, poses, pts, bits)
    return cfg, config_from_fields(dataclasses.asdict(cfg)), ms, kfs


def _corrupt(ms):
    victim = int(np.nonzero(np.asarray(ms.mp_valid))[0][0])
    return ms._replace(mp_pos=ms.mp_pos.at[victim].add(jnp.asarray([5.0, 5.0, 3.0]))), victim


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupted"])
def test_remove_outlier_obs_matches_jax(built, corrupt):
    cfg, tcfg, ms, kfs = built
    victim = None
    if corrupt:
        ms, victim = _corrupt(ms)
    cur = kfs[-1]
    want, want_bad = jlm.remove_outlier_obs(ms, jnp.asarray(cur), cfg)
    got, n_bad = tlm.remove_outlier_obs(
        map_state_from_numpy(jax.tree.map(np.asarray, ms), "cpu"), torch.tensor(cur), tcfg)
    assert n_bad.dtype == torch.int32 and int(n_bad) == int(want_bad)
    for name in MapState._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    check_consistency(got)
    if corrupt:
        # the JAX test's asserts: the victim's observations are gone from
        # every keyframe row and, below 2 observations, the point is killed
        assert int(n_bad) >= 1
        assert not (got.kf_obs_mp == victim).any()
        assert not bool(got.mp_valid[victim])
    else:
        assert int(n_bad) == 0

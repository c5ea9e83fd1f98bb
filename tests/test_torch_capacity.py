"""The port's capacity relief against the JAX package's.

The three relief runs of ``tests/test_capacity.py`` (160x120, 128
features): the 8-keyframe bank over 44 frames (``:66``), the 80-point
bank over 60 frames (``:170``) and the 8-keyframe bank with the loop
closer attached (``:213``), each through both packages' ``SlamSystem``
with JAX's per-frame tracking draws passed to the port. The port's map is
checked for table consistency (``tests/test_prune.check_consistency``)
after every relief. Then each relief function of ``localmap`` runs on the
map the JAX package held just before its first compaction.

Tolerances: keyframe frames, compaction, cull and reclaim counts and
re-anchored anchors are equal; integer tables, slots and permutations
are equal; floats are gathered, so equal too. The two corrected ATEs
agree within 0.01 m.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import localmap as jlm
from se2lam_tpu import system as jsys
from se2lam_tpu.config import Capacity
from se2lam_tpu.io import SyntheticWorld, ate_se2
from se2lam_tpu_torch import localmap as tlm
from se2lam_tpu_torch.convert import config_from_fields, map_state_from_numpy
from se2lam_tpu_torch.mapstate import MapState
from se2lam_tpu_torch.system import SlamSystem

from jax_draws import run_jax_slam
from test_capacity import _cfg
from test_prune import check_consistency

torch.set_num_threads(2)

RUNS = {
    "kf_bank": (lambda: _cfg(), 44, False),
    "mp_bank": (lambda: _cfg(cap=Capacity(
        n_features=128, max_kfs=32, max_mps=80, local_kfs=4, local_ref_kfs=4, local_mps=64,
        ransac_trials=32)), 60, False),
    "kf_bank_loops": (lambda: _cfg(gm_dcl_min_kfid_offset=4, gm_vcl_num_min_match_mp=6,
                                   gm_vcl_num_min_match_kp=12), 44, True),
}
COUNTERS = ("capacity_compactions", "mp_compactions", "mp_culled_weak", "mp_slots_reclaimed",
            "anchors_reanchored", "at_capacity")


@pytest.fixture(scope="module", params=list(RUNS))
def run(request):
    make, n, loops = RUNS[request.param]
    cfg = make()
    world = SyntheticWorld(cfg, n_landmarks=300, room=10.0, seed=1)
    seq = list(world.sequence(n, noise=(0.002, 0.001, 0.001)))
    first_compaction = []
    orig = jlm.compact_map

    def record(ms):
        if not first_compaction:
            first_compaction.append(ms)
        return orig(ms)

    js = jsys.SlamSystem(cfg, enable_loops=loops)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlm, "compact_map", record)
        noise = run_jax_slam(js, seq)

    ts = SlamSystem(config_from_fields(dataclasses.asdict(cfg)), enable_loops=loops,
                    device="cpu")
    checked = []
    for name in ("_relieve_capacity", "_relieve_mp_capacity"):
        def checked_relief(fn=getattr(ts, name)):
            out = fn()
            check_consistency(ts.ms)
            checked.append(int(ts.ms.n_kf))
            return out
        setattr(ts, name, checked_relief)
    for (img, odo), g in zip(seq, noise):
        ts.process(img, odo, gumbel=g)
    return dict(name=request.param, cfg=cfg, n=n, js=js, ts=ts, gt=world.gt[:n],
                checked=checked, jax_map=first_compaction[0] if first_compaction else None)


def test_relief_matches_jax(run):
    js, ts = run["js"], run["ts"]
    assert ts.frame_id == run["n"]
    assert ts.kf_frame_ids == js.kf_frame_ids
    for c in COUNTERS:
        assert getattr(ts, c) == getattr(js, c), c
    assert ts.capacity_compactions + ts.mp_compactions >= 1
    # consistency held after every relief
    assert len(run["checked"]) == ts.capacity_compactions + ts.mp_compactions
    check_consistency(ts.ms)
    if run["name"] == "mp_bank":
        assert ts.mp_culled_weak >= 1
        assert int(ts.ms.n_mp) + ts.mp_slots_reclaimed > 2 * run["cfg"].cap.max_mps
    else:
        assert ts.capacity_compactions >= 1 and max(ts.kf_frame_ids) > 20
    ates = [ate_se2(s.corrected_trajectory()[:, 1:3], run["gt"][:, :2])[0] for s in (js, ts)]
    assert np.isfinite(ates).all() and ates[1] < 0.5
    assert abs(ates[0] - ates[1]) < 0.01, ates


def test_relief_keeps_the_loop_closer_consistent(run):
    """With the closer attached, the bank follows the compacted slots:
    nonzero rows exactly on valid keyframes (``tests/test_capacity.py:213``)."""
    lc = run["ts"]._loop_closer
    if run["name"] != "kf_bank_loops":
        assert lc is None
        return
    jl = run["js"]._loop_closer
    assert lc.vocab is not None and lc.n_vocab_trainings == jl.n_vocab_trainings
    bank, valid = lc.bank.numpy(), run["ts"].ms.kf_valid.numpy()
    assert np.any(bank[valid] != 0.0, axis=1).all()
    assert not np.any(bank[~valid] != 0.0)
    assert lc.n_loops_closed == jl.n_loops_closed


def _jax_map(run):
    ms = run["jax_map"]
    if ms is None:      # the point-bank run compacts points only
        ms = run["js"].ms
    return ms, map_state_from_numpy(jax.tree.map(np.asarray, ms), "cpu")


def _equal(tms: MapState, jms):
    for f in MapState._fields:
        a, b = getattr(tms, f).numpy(), np.asarray(getattr(jms, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_compact_map_matches_jax(run):
    jms, tms = _jax_map(run)
    jout, jkf, jmp = jlm.compact_map(jms)
    tout, tkf, tmp = tlm.compact_map(tms)
    np.testing.assert_array_equal(tkf.numpy(), np.asarray(jkf))
    np.testing.assert_array_equal(tmp.numpy(), np.asarray(jmp))
    _equal(tout, jout)
    check_consistency(tout)


def test_mp_relief_functions_match_jax(run):
    """cull_weak_mps, compact_mps and relieve_mp_pressure at a target that
    culls about a third of the live points."""
    jms, tms = _jax_map(run)
    n_live = int(np.asarray(jms.mp_valid).sum())
    target = (2 * n_live) // 3
    protect = int(np.nonzero(np.asarray(jms.kf_valid))[0][-1])     # the newest keyframe
    jc, jn = jlm.cull_weak_mps(jms, jnp.asarray(target, jnp.int32), jnp.asarray(protect))
    tc, tn = tlm.cull_weak_mps(tms, target, protect)
    assert int(tn) == int(jn) > 0
    _equal(tc, jc)
    check_consistency(tc)
    _equal(tlm.compact_mps(tc), jlm.compact_mps(jc))
    jr, jn2 = jlm.relieve_mp_pressure(jms, jnp.asarray(target, jnp.int32), jnp.asarray(protect))
    tr, tn2 = tlm.relieve_mp_pressure(tms, target, protect)
    assert int(tn2) == int(jn2)
    _equal(tr, jr)
    assert int(tr.n_mp) == int(tr.mp_valid.sum()) <= target


def test_recompute_covis_matches_jax(run):
    jms, tms = _jax_map(run)
    np.testing.assert_array_equal(tlm.recompute_covis(tms).covis.numpy(),
                                  np.asarray(jlm.recompute_covis(jms).covis))

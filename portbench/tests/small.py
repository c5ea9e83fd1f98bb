"""A small size of the benchmark's configurations for CPU tests: 320x240,
256 features on 2 levels, small banks. The widths of the cells on the card
are those of the configuration files; this size only drives the harness."""
import copy


def small(doc: dict) -> dict:
    d = copy.deepcopy(doc)
    s = d["system"]
    s.update(width=320, height=240, fx=256.0, fy=256.0, cx=160.0, cy=120.0,
             max_feature_num=256, max_level=2, gm_dcl_min_kfid_offset=8,
             gm_vcl_num_min_match_mp=6, gm_vcl_num_min_match_kp=15)
    d["capacity"].update(n_features=256, max_kfs=32, max_mps=2048, local_kfs=8,
                         local_ref_kfs=8, local_mps=512, local_obs=2048, ransac_trials=64)
    d["world"]["n_landmarks"] = 600
    return d

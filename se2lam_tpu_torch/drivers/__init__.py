"""Command-line drivers of the port (counterparts of the JAX package's
``examples/`` drivers), each run as ``python -m
se2lam_tpu_torch.drivers.<name>`` and callable as ``main(argv)``:

- ``run_dataset``: SLAM over a DatasetRoom directory or the synthetic world;
- ``run_localization``: localization-only on a saved map;
- ``merge_maps``: merge two saved maps into one;
- ``make_dataset``: render a synthetic DatasetRoom to disk;
- ``serve_live`` and ``feed_live``: a TCP SLAM server and a feed client;
- ``fleet_demo``: two robots map, the maps merge, a fleet localizes;
- ``evaluate_ate``: SE(2)-aligned ATE between two trajectory files;
- the studies and the soak of the JAX package's ``examples/``:
  ``study_drift`` (multi-lap drift of odometry and three SLAM estimators),
  ``study_noise`` (odometry-noise sweep), ``study_pg_calib`` (pose-graph
  Huber and loop-information ceiling), ``study_noloop_debug`` (a no-loop
  run instrumented a keyframe), ``study_tri_accuracy`` (triangulation at
  exact poses), ``study_vocab_scale`` (BoW separation against bank size),
  ``study_pcg_precond`` (the bank-scale PCG's preconditioners) and
  ``soak_bank_scale`` (past 200 keyframe insertions into 128 slots, with
  its structural asserts), each with its script's options and
  ``--device``, writing under ``artifacts/torch_*``; each ``run(args)``
  returns what it writes.

Each driver that computes on a device takes ``--device`` (default: the
card; ``--device cpu`` runs the plain versions on the CPU); ``make_dataset``,
``feed_live`` and ``evaluate_ate`` run on the host. Plots need matplotlib
and are skipped without it.
"""

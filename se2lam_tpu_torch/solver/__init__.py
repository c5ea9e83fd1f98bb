"""Bundle adjustment (port of se2lam_tpu.solver): the SE2-XYZ local BA and
the Schur point reduction, kernel K3."""

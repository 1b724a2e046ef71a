"""Fixed-depth FDDP and the SbFDDP homotopy."""

"""Training losses (full RoMa and Tiny RoMa)."""

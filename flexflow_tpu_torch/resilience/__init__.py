"""Resilience: the batch preflight of fit/eval/predict. Checkpointing, the
divergence guard and the strategy cascade come in later slices."""

"""Training: optimizer, train state, step factories, checkpoints and fault handling."""

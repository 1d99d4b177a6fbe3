"""VideoMAE pretraining: optimizer, train state, step and gradient probes."""

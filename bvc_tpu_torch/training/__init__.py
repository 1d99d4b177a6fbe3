"""VideoMAE and JEPA pretraining: optimizer, train state, steps and
gradient probes."""

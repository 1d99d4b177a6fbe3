"""VideoMAE, JEPA and SimCLR pretraining: optimizer, train state, steps,
trainers and gradient probes."""

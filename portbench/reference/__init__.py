"""The plain reference: f32 PyTorch and numpy, TF32 off, written from the
published descriptions.  It imports nothing of the program and takes
nothing the program made: the inputs (corpus, clips, weights) come from the
benchmark, and the masks, the gathered clips and the state after each step
are worked out again here from them and the seed."""

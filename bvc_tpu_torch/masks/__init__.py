"""VideoMAE tube and random masks, sampled on the device."""

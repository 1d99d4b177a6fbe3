"""VideoMAE tube and random masks, sampled on the device, and the JEPA
multi-block collator (numpy, on the host)."""

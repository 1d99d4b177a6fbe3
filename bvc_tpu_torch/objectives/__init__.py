"""The SimCLR objective: InfoNCE over interleaved augmentation pairs."""

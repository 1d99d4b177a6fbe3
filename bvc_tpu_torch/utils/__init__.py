"""Model, mask and optimizer configuration, and device choice."""

"""Model configuration and device choice."""

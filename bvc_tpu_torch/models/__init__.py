"""VideoMAE encoder, transformer core, initialisation and weight conversion."""

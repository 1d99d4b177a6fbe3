"""VideoMAE and JEPA models, transformer core, position tables,
initialisation and weight conversion."""

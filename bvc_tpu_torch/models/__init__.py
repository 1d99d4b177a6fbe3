"""VideoMAE, JEPA and SimCLR's ResNet models, transformer core, position
tables, initialisation and weight conversion."""

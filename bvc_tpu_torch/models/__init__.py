"""VideoMAE encoder and pretraining model, transformer core, initialisation and weight conversion."""

"""VideoMAE, JEPA and SimCLR's ResNet models, the image ViT, transformer
core, position tables, initialisation and weight conversion."""

"""The training dataset, ray sampling and image / mesh file I/O."""

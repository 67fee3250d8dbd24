"""dist of the PyTorch port: off-mesh sampling only (see the package
docstring); the mesh paths come last."""

"""data of the PyTorch port: the synthetic corpus and the packed LM
pipeline, numpy copies of the reference's (see the package docstring)."""

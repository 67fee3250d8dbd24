"""ckpt of the PyTorch port: the reference's checkpoint format (see the
package docstring)."""

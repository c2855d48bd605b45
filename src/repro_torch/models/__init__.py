"""LM model code of the port: layers, attention and the dense-block
decoder."""

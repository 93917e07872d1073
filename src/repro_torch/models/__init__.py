"""The LM stack of the port: layers, GQA attention, Mamba2, the block
kinds, model assembly, and the loader of the JAX package's weights."""

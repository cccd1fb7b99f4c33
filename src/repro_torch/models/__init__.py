"""The LM template's dense-attention family: config, layers, transformer."""

"""The LM template's attention family: config, layers, transformer."""

"""Model zoo: layers, attention, transformer blocks, the causal LM."""

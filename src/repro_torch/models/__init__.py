"""Model code of the port (decoder-only LM with MoE FFNs)."""

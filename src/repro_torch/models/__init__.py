"""The decoder-only LM stack the serving and training paths run: layers,
attention, the Mamba block, the layer stack and model assembly; and the
UNOMT drug-response net."""

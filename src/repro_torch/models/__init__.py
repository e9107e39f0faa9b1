"""The decoder-only LM stack the serving path runs: layers, attention,
the layer stack and model assembly."""

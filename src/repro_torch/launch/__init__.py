"""Launchers, PyTorch port: the prefill and serve steps and the serving CLI."""

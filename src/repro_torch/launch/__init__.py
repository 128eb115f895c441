"""Launchers of the port: distributed MD, the dry run, LM serving and LM
training."""

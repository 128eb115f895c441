"""Launchers of the port: entry points that run across ranks."""
